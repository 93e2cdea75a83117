"""The serving path's hand-written CUDA kernels, their plain PyTorch
versions, and launch counts.

Each public wrapper takes the plain version for tensors on the CPU and
launches its kernel (``csrc/*.cu``, built and loaded by :mod:`.build` at
first use) for CUDA tensors; there is no fallback from the card to the
plain version. Each wrapper carries ``launches``, a plain integer that it
increments once per kernel launch, so a run can show which kernels its
path went through. The plain versions share the wrappers' signatures; the
tests compare them with the JAX package, and ``chip_smoke.py`` compares
the kernels with them on the card.

========================================  ==================================
wrapper                                   replaces (cmr_agent_tpu/ops/
                                          pallas_kernels.py)
========================================  ==================================
:func:`segment_softmax_attend`            ``segment_softmax_attend_fused``
:func:`gather_rows`                       ``gather_rows_fused``
:func:`knn`                               ``knn_fused``
:func:`segment_mean_count_image_project`  ``segment_mean_count_image_project_fused``
========================================  ==================================
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmr_segment_softmax_attend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmr_knn": [_P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_raster_project": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _P],
    "cmr_error_string": [_I],
}
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load()
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "cmr_error_string" \
                else ctypes.c_int
        _lib = lib
    return _lib


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA arguments, False for all-CPU ones; raises on any
    other device or a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors on unsupported or mixed devices: "
                     f"{[str(t.device) for t in tensors]}")


def _require(name: str, t: torch.Tensor, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(fn_name: str, *args) -> None:
    lib = library()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = (lib.cmr_error_string(err).decode() if err > 0
               else "unsupported argument")
        raise RuntimeError(f"{fn_name} failed: {msg} ({err})")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# --------------------------------------------------------------------------
# 1. segmented softmax-attend
# --------------------------------------------------------------------------

def segment_softmax_attend_plain(attn: torch.Tensor, values: torch.Tensor,
                                 idx: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Per-channel softmax of ``attn [B,N,F]`` within each segment
    ``idx [B,N]``, then the softmax-weighted sum of ``values`` per segment
    -> ``[B,M,F]`` f32. Stabilised by the global per-(b, channel) max
    (exact: the shift is constant within every segment). Empty segments
    give 0; idx outside [0, M) contributes nothing."""
    b, n, f = attn.shape
    m = num_segments
    e = torch.exp(attn - attn.amax(dim=1, keepdim=True))
    valid = (idx >= 0) & (idx < m)
    e = torch.where(valid[..., None], e, torch.zeros_like(e))
    seg = torch.where(valid, idx, torch.zeros_like(idx)).long()
    seg = seg[..., None].expand(b, n, f)
    sums = attn.new_zeros((b, m, f)).scatter_add_(1, seg, e)
    out = attn.new_zeros((b, m, f)).scatter_add_(1, seg, e * values)
    return out / sums.clamp_min(1e-30)


def segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Kernel wrapper of :func:`segment_softmax_attend_plain`: f32
    ``attn``/``values`` ``[B,N,F]``, int32 ``idx [B,N]``."""
    if not _on_cuda(attn, values, idx):
        return segment_softmax_attend_plain(attn, values, idx, num_segments)
    b, n, f = attn.shape
    m = int(num_segments)
    _require("attn", attn, (torch.float32,), (b, n, f))
    _require("values", values, (torch.float32,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, n))
    if m < 1:
        raise ValueError(f"num_segments must be positive, got {m}")
    gmax = torch.full((b, f), float("-inf"), device=attn.device)
    sums = torch.zeros((b, m, f), device=attn.device)
    out = torch.zeros((b, m, f), device=attn.device)
    _launch("cmr_segment_softmax_attend", _ptr(attn), _ptr(values), _ptr(idx),
            _ptr(gmax), _ptr(sums), _ptr(out), b, n, m, f, _stream())
    segment_softmax_attend.launches += 1
    return out


segment_softmax_attend.launches = 0


# --------------------------------------------------------------------------
# 2. batched row gather
# --------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [B,M,F] x idx [B,N] -> [B,N,F]``; idx outside [0, M) gives a
    zero row. Exact."""
    b, m, f = table.shape
    valid = (idx >= 0) & (idx < m)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = torch.gather(table, 1, safe[..., None].expand(b, idx.shape[1], f))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of :func:`gather_rows_plain`: f32 or bf16 ``table``,
    int32 ``idx``."""
    if not _on_cuda(table, idx):
        return gather_rows_plain(table, idx)
    b, m, f = table.shape
    n = idx.shape[1]
    _require("table", table, (torch.float32, torch.bfloat16), (b, m, f))
    _require("idx", idx, (torch.int32,), (b, n))
    out = torch.empty((b, n, f), dtype=table.dtype, device=table.device)
    row_bytes = f * table.element_size()
    chunk = next(c for c in (16, 4, 2)
                 if row_bytes % c == 0 and table.data_ptr() % c == 0
                 and out.data_ptr() % c == 0)
    _launch("cmr_gather_rows", _ptr(table), _ptr(idx), _ptr(out), b, n, m,
            row_bytes, chunk, _stream())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# --------------------------------------------------------------------------
# 3. exact k nearest neighbours
# --------------------------------------------------------------------------

KNN_MAX_K = 32
KNN_MAX_POINTS = 4096


def knn_plain(xyz: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-NN indices ``xyz [B,N,3], query [B,M,3] -> [B,M,k]`` int32,
    ranked by ``|x|^2 - 2 q.x`` in f32 (the row-constant ``|q|^2``
    dropped), ties to the lower index. The terms are added in the kernel's
    fixed order, one rounding per operation."""
    x0, x1, x2 = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sqn = x0 * x0 + x1 * x1 + x2 * x2                         # [B, N]
    q0, q1, q2 = (query[..., i, None] for i in range(3))      # [B, M, 1]
    dot = q0 * x0[:, None] + q1 * x1[:, None] + q2 * x2[:, None]
    d = sqn[:, None, :] - 2.0 * dot                           # [B, M, N]
    order = torch.sort(d, dim=-1, stable=True).indices
    return order[..., :k].to(torch.int32)


def knn(xyz: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel wrapper of :func:`knn_plain`: f32, ``k <= 32``,
    ``N <= 4096``."""
    if not _on_cuda(xyz, query):
        return knn_plain(xyz, query, k)
    b, n, _ = xyz.shape
    m = query.shape[1]
    _require("xyz", xyz, (torch.float32,), (b, n, 3))
    _require("query", query, (torch.float32,), (b, m, 3))
    if not 1 <= k <= min(KNN_MAX_K, n) or n > KNN_MAX_POINTS:
        raise ValueError(f"knn kernel supports 1 <= k <= min(32, N) and "
                         f"N <= {KNN_MAX_POINTS}; got k={k}, N={n}")
    out = torch.empty((b, m, k), dtype=torch.int32, device=xyz.device)
    _launch("cmr_knn", _ptr(xyz), _ptr(query), _ptr(out), b, n, m, k,
            _stream())
    knn.launches += 1
    return out


knn.launches = 0


# --------------------------------------------------------------------------
# 4. projection-fused observation raster (mean + count per pixel)
# --------------------------------------------------------------------------

def quantize_int8(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) symmetric absmax int8 quantisation of
    ``feat [B,K,F]`` -> ``(q int8, scale [B,F] f32)``.

    The absmax covers ALL K rows, including rows past the valid count: the
    JAX package does the same (pallas_kernels.py:1607-1611), and the port
    matches it on purpose so both quantise identically.
    """
    f32 = feat.float()
    scale = f32.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q = torch.round(f32 / scale[:, None, :]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _operands(feat: torch.Tensor, compute_dtype):
    """Feature operand and dequantisation scale for a compute dtype
    (None/f32, bf16 or int8)."""
    if compute_dtype == torch.int8:
        return quantize_int8(feat)
    if compute_dtype == torch.bfloat16:
        return feat.to(torch.bfloat16), None
    if compute_dtype in (None, torch.float32):
        return feat.float(), None
    raise ValueError(f"unsupported raster compute dtype {compute_dtype}")


def _project_pixels(pcT, ab, counts, h: int, w: int):
    """Pixel id per row (``h*w`` = dropped) with the kernel's arithmetic:
    one rounding per operation, in _project_raster_kernel's term order."""
    px, py, pz = pcT[:, 0], pcT[:, 1], pcT[:, 2]              # [B, K]
    a = [ab[:, i, None] for i in range(12)]
    xp = a[0] * px + a[1] * py + a[2] * pz + a[9]
    yp = a[3] * px + a[4] * py + a[5] * pz + a[10]
    zp = a[6] * px + a[7] * py + a[8] * pz + a[11]
    zs = torch.where(zp.abs() < 1e-10, torch.full_like(zp, 1e-10), zp)
    x = xp / zs
    y = yp / zs
    row = torch.arange(pcT.shape[2], device=pcT.device)[None, :]
    ok = ((x >= 0) & (x <= (w - 1)) & (y >= 0) & (y <= (h - 1)) & (zp > 0)
          & (row < counts[:, None]))
    pix = torch.round(y).long() * w + torch.round(x).long()
    return torch.where(ok, pix, torch.full_like(pix, h * w))


def segment_mean_count_image_project_plain(
        pcT: torch.Tensor, feat: torch.Tensor, ab: torch.Tensor,
        counts: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused project + raster mean -> ``(means [B,h*w,F], counts [B,h*w])``.

    ``pcT [B,3,K]`` f32 valid rows first; ``feat [B,K,F]``; ``ab [B,12]``
    f32 (row-major ``A`` then ``t``: pixel of p = round((A p + t)_xy /
    (A p + t)_z)); ``counts [B]`` int32 valid leading rows (rows beyond are
    never rastered). ``compute_dtype`` None/f32, bf16 (features rounded to
    bf16, f32 sums) or int8 (quantised, exact integer sums).
    """
    b, _, k = pcT.shape
    f = feat.shape[-1]
    q, scale = _operands(feat, compute_dtype)
    pix = _project_pixels(pcT, ab, counts, h, w)
    acc_dtype = torch.int32 if scale is not None else torch.float32
    data = torch.cat([q.to(acc_dtype),
                      torch.ones((b, k, 1), dtype=acc_dtype,
                                 device=feat.device)], dim=-1)
    acc = torch.zeros((b, h * w + 1, f + 1), dtype=acc_dtype,
                      device=feat.device)
    acc.scatter_add_(1, pix[..., None].expand(b, k, f + 1), data)
    acc = acc[:, :h * w]
    sums, cnt = acc[..., :f].float(), acc[..., f].float()
    if scale is not None:
        sums = sums * scale[:, None, :]
    return sums / cnt.clamp_min(1.0)[..., None], cnt


def segment_mean_count_image_project(
        pcT: torch.Tensor, feat: torch.Tensor, ab: torch.Tensor,
        counts: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_mean_count_image_project_plain`."""
    if not _on_cuda(pcT, feat, ab, counts):
        return segment_mean_count_image_project_plain(
            pcT, feat, ab, counts, h, w, compute_dtype)
    b, _, k = pcT.shape
    f = feat.shape[-1]
    _require("pcT", pcT, (torch.float32,), (b, 3, k))
    _require("feat", feat, (torch.float32, torch.bfloat16), (b, k, f))
    _require("ab", ab, (torch.float32,), (b, 12))
    _require("counts", counts, (torch.int32,), (b,))
    q, scale = _operands(feat, compute_dtype)
    q = q.contiguous()
    kind = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[q.dtype]
    acc = torch.zeros((b, h * w, f + 1),
                      dtype=torch.int32 if kind == 2 else torch.float32,
                      device=pcT.device)
    means = torch.empty((b, h * w, f), device=pcT.device)
    cnt = torch.empty((b, h * w), device=pcT.device)
    _launch("cmr_raster_project", _ptr(pcT), _ptr(q), kind, _ptr(ab),
            _ptr(counts), _ptr(scale), _ptr(acc), _ptr(means), _ptr(cnt),
            b, k, f, h, w, _stream())
    segment_mean_count_image_project.launches += 1
    return means, cnt


segment_mean_count_image_project.launches = 0

WRAPPERS = (segment_softmax_attend, gather_rows, knn,
            segment_mean_count_image_project)
PLAIN = {
    "segment_softmax_attend": segment_softmax_attend_plain,
    "gather_rows": gather_rows_plain,
    "knn": knn_plain,
    "segment_mean_count_image_project": segment_mean_count_image_project_plain,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
