"""The data pipeline's native host ops (FPS and 1-NN), bound with ctypes.

``host_ops.cpp`` is built with ``g++`` at first use into
``build/native/<hash>/`` at the repository root, with the JAX package's
flags (``-O3 -march=native -ffp-contract=fast``): the synthetic scenes'
node sets and point-to-node maps depend on how these two recurrences round
near-tied distances, and the numpy versions in :mod:`..data.pipeline` round
them otherwise. A failed build raises; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-ffp-contract=fast", "-shared", "-fPIC",
         "-std=c++17")
_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    """The host's CPU feature line: ``-march=native`` builds for it, so a
    library built on one host is not loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes()
                       + _cpu_flags())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcmr_host_ops.so"


def load_lib() -> ctypes.CDLL:
    """Build (unless built) and load the library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = library_path()
        if not lib_path.is_file():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
                tmp_lib = Path(tmp, lib_path.name)
                proc = subprocess.run(
                    ["g++", *FLAGS, str(SRC), "-o", str(tmp_lib)],
                    capture_output=True, text=True, timeout=120)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {SRC}:\n"
                                       f"{proc.stderr}")
                os.replace(tmp_lib, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.cmr_fps.argtypes = [f32p, i64, i64, i64p, f32p]
        lib.cmr_fps.restype = None
        lib.cmr_nn_assign.argtypes = [f32p, i64, f32p, i64, i64p]
        lib.cmr_nn_assign.restype = None
        _lib = lib
        return _lib


def fps_native(rng: np.random.Generator, pts: np.ndarray,
               k: int) -> np.ndarray:
    """Farthest point sampling with the signature of
    :func:`..data.pipeline.farthest_point_sample_np`."""
    lib = load_lib()
    pts32 = np.ascontiguousarray(pts, dtype=np.float32)
    out = np.zeros(k, dtype=np.int64)
    out[0] = rng.integers(pts32.shape[0])
    scratch = np.empty(pts32.shape[0], dtype=np.float32)
    lib.cmr_fps(pts32, pts32.shape[0], k, out, scratch)
    return out


def nn_assign_native(points: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Brute-force 1-NN: the index of each point's nearest centre."""
    lib = load_lib()
    p = np.ascontiguousarray(points, dtype=np.float32)
    c = np.ascontiguousarray(centers, dtype=np.float32)
    out = np.empty(p.shape[0], dtype=np.int64)
    lib.cmr_nn_assign(p, p.shape[0], c, c.shape[0], out)
    return out


def get_fast_host_ops() -> Tuple[Callable, Callable]:
    """``(fps_fn, nn_fn)`` for :class:`..data.SyntheticDataset`."""
    load_lib()
    return fps_native, nn_assign_native
