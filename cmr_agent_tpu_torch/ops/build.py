"""Builds the port's CUDA kernels (``csrc/*.cu``) and loads them with ctypes.

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds each in seconds. Each source is compiled on its own, all at
once, then linked into one shared library under ``build/cuda/<hash>/`` at
the repository root, where ``<hash>`` covers the sources and the flags: a
change to either builds anew, an unchanged tree loads the cached library.
The build happens at first use, on the machine with the card; nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cuda"
LIB_NAME = "libcmr_kernels.so"
# No --use_fast_math: the raster's division and rintf must round as IEEE
# f32 does, or a point on a pixel boundary changes pixel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built where the CUDA toolkit is installed")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, headers = _sources()
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile and link the kernels unless the library already exists.

    The compiler's register/shared-memory report (``-Xptxas=-v``) is kept
    in ``build.log`` beside the library. Raises with the compiler's output
    if any source fails.
    """
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    srcs, _ = _sources()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        Path(lib.parent, "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library."""
    return ctypes.CDLL(str(build()))
