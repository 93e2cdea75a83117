"""The port's hand-written CUDA kernels, their plain PyTorch versions,
launch counts, and the autograd Functions built on them.

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
:func:`segment_sum`                       ``segment_sum_fused``
:func:`segment_softmax_attend_backward`   ``_bwd`` (VJP of
                                          ``segment_softmax_attend_fused``)
:func:`segment_mean_count_image`          ``segment_sum_image_fused`` (flat)
:func:`segment_sum_shared`                ``segment_sum_fused_shared``
:func:`mask_compact_pack`                 ``mask_compact_pack``
========================================  ==================================

Gradients: :class:`SegmentSoftmaxAttendFn`, :class:`GatherRowsFn` and
:class:`SegmentMeanCountImageFn` are ``torch.autograd.Function``s whose
forward and backward both go through the wrappers above (kernel or plain
version by device), as the JAX package's ``custom_vjp`` rules do. They look
the wrappers up at call time, so swapping a wrapper for its plain version
(``PLAIN``) swaps it in both directions.
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
    "cmr_segment_sum": [_P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_segment_softmax_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _P],
    "cmr_raster_image": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_segment_sum_shared": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmr_mask_pack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
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
                                 idx: torch.Tensor, num_segments: int,
                                 return_stats: bool = False):
    """Per-channel softmax of ``attn [B,N,F]`` within each segment
    ``idx [B,N]``, then the softmax-weighted sum of ``values`` per segment
    -> ``[B,M,F]`` f32. Stabilised by the global per-(b, channel) max
    (exact: the shift is constant within every segment). Empty segments
    give 0; idx outside [0, M) contributes nothing.

    ``return_stats=True`` returns ``(out, sums [B,M,F], gmax [B,F])``, the
    residuals of :func:`segment_softmax_attend_backward`."""
    b, n, f = attn.shape
    m = num_segments
    gmax = attn.amax(dim=1)
    e = torch.exp(attn - gmax[:, None, :])
    valid = (idx >= 0) & (idx < m)
    e = torch.where(valid[..., None], e, torch.zeros_like(e))
    seg = torch.where(valid, idx, torch.zeros_like(idx)).long()
    seg = seg[..., None].expand(b, n, f)
    sums = attn.new_zeros((b, m, f)).scatter_add_(1, seg, e)
    out = attn.new_zeros((b, m, f)).scatter_add_(1, seg, e * values)
    out = out / sums.clamp_min(1e-30)
    return (out, sums, gmax) if return_stats else out


def segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor, num_segments: int,
                           return_stats: bool = False):
    """Kernel wrapper of :func:`segment_softmax_attend_plain`: f32
    ``attn``/``values`` ``[B,N,F]``, int32 ``idx [B,N]``. The kernel fills
    ``sums`` and ``gmax`` on its way, so ``return_stats`` costs nothing."""
    if not _on_cuda(attn, values, idx):
        return segment_softmax_attend_plain(attn, values, idx, num_segments,
                                            return_stats)
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
    return (out, sums, gmax) if return_stats else out


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
    q, scale = _operands(feat, compute_dtype)
    pix = _project_pixels(pcT, ab, counts, h, w)
    return _raster_mean_count(q, scale, pix, h * w)


def _raster_mean_count(q: torch.Tensor, scale: Optional[torch.Tensor],
                       pix: torch.Tensor, hw: int):
    """Shared tail of the plain rasters: ``q [B,K,F]`` (f32/bf16 summed in
    f32, int8 in exact int32 then scaled by ``scale [B,F]``) summed with a
    ones column into pixel ``pix [B,K]`` (``hw`` = dropped) -> ``(means
    [B,hw,F], counts [B,hw])``."""
    b, k, f = q.shape
    acc_dtype = torch.int32 if scale is not None else torch.float32
    data = torch.cat([q.to(acc_dtype),
                      torch.ones((b, k, 1), dtype=acc_dtype,
                                 device=q.device)], dim=-1)
    acc = torch.zeros((b, hw + 1, f + 1), dtype=acc_dtype, device=q.device)
    acc.scatter_add_(1, pix.long()[..., None].expand(b, k, f + 1), data)
    acc = acc[:, :hw]
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

# --------------------------------------------------------------------------
# 5. segment sum (the row gather's backward)
# --------------------------------------------------------------------------

def segment_sum_plain(data: torch.Tensor, idx: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``data [B,N,F] x idx [B,N] -> [B,M,F]`` sums per segment; rows with
    idx outside [0, M) contribute nothing."""
    b, n, f = data.shape
    m = num_segments
    valid = (idx >= 0) & (idx < m)
    seg = torch.where(valid, idx, torch.full_like(idx, m)).long()
    out = data.new_zeros((b, m + 1, f))
    out.scatter_add_(1, seg[..., None].expand(b, n, f), data)
    return out[:, :m]


def segment_sum(data: torch.Tensor, idx: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Kernel wrapper of :func:`segment_sum_plain`: f32 ``data``, int32
    ``idx``."""
    if not _on_cuda(data, idx):
        return segment_sum_plain(data, idx, num_segments)
    b, n, f = data.shape
    m = int(num_segments)
    _require("data", data, (torch.float32,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, n))
    if m < 1:
        raise ValueError(f"num_segments must be positive, got {m}")
    out = torch.zeros((b, m, f), device=data.device)
    _launch("cmr_segment_sum", _ptr(data), _ptr(idx), _ptr(out), b, n, m, f,
            _stream())
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


# --------------------------------------------------------------------------
# 6. segmented softmax-attend, backward
# --------------------------------------------------------------------------

def segment_softmax_attend_backward_plain(
        attn: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
        out: torch.Tensor, sums: torch.Tensor, gmax: torch.Tensor,
        grad: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form VJP of :func:`segment_softmax_attend_plain` from its
    residuals (``out``, ``sums``, ``gmax``) and the output gradient
    ``grad [B,M,F]`` -> ``(dattn, dvalues)`` ``[B,N,F]``: with ``w =
    exp(attn - gmax) / max(sums[seg], 1e-30)``, ``dvalues = w g[seg]`` and
    ``dattn = w g[seg] (values - out[seg])``; 0 for routed-out rows."""
    valid = ((idx >= 0) & (idx < num_segments))[..., None]

    def at(table):
        return gather_rows_plain(table, idx)

    w = torch.exp(attn - gmax[:, None, :]) / at(sums).clamp_min(1e-30)
    gw = torch.where(valid, w, torch.zeros_like(w)) * at(grad)
    return gw * (values - at(out)), gw


def segment_softmax_attend_backward(
        attn: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
        out: torch.Tensor, sums: torch.Tensor, gmax: torch.Tensor,
        grad: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_softmax_attend_backward_plain`: all
    f32, int32 ``idx``; the gather of the three ``[B,M,F]`` tables is fused
    into the kernel."""
    if not _on_cuda(attn, values, idx, out, sums, gmax, grad):
        return segment_softmax_attend_backward_plain(
            attn, values, idx, out, sums, gmax, grad, num_segments)
    b, n, f = attn.shape
    m = int(num_segments)
    for name, t, shape in (("attn", attn, (b, n, f)),
                           ("values", values, (b, n, f)),
                           ("out", out, (b, m, f)), ("sums", sums, (b, m, f)),
                           ("gmax", gmax, (b, f)), ("grad", grad, (b, m, f))):
        _require(name, t, (torch.float32,), shape)
    _require("idx", idx, (torch.int32,), (b, n))
    dattn = torch.empty_like(attn)
    dvalues = torch.empty_like(values)
    _launch("cmr_segment_softmax_backward", _ptr(attn), _ptr(values),
            _ptr(idx), _ptr(out), _ptr(sums), _ptr(gmax), _ptr(grad),
            _ptr(dattn), _ptr(dvalues), b, n, m, f, _stream())
    segment_softmax_attend_backward.launches += 1
    return dattn, dvalues


segment_softmax_attend_backward.launches = 0


# --------------------------------------------------------------------------
# 7. pixel-id observation raster (mean + count per pixel)
# --------------------------------------------------------------------------

def _image_operand(data: torch.Tensor, compute_dtype) -> torch.Tensor:
    if compute_dtype == torch.int8:
        raise ValueError("the pixel-id raster has no int8 mode (training "
                         "episodes raster in f32 or bf16)")
    return _operands(data, compute_dtype)[0]


def segment_mean_count_image_plain(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-id raster -> ``(means [B,h*w,F], counts [B,h*w])`` f32.

    ``data [B,K,F]``; ``ids [B,K]`` pixel ``y*w + x`` per row, any id
    outside ``[0, h*w)`` routed out. ``compute_dtype`` None/f32 or bf16
    (rows rounded to bf16 once, f32 sums)."""
    hw = h * w
    pix = torch.where((ids >= 0) & (ids < hw), ids, torch.full_like(ids, hw))
    return _raster_mean_count(_image_operand(data, compute_dtype), None, pix,
                              hw)


def segment_mean_count_image(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_mean_count_image_plain`: f32 or
    bf16 ``data``, int32 ``ids``."""
    if not _on_cuda(data, ids):
        return segment_mean_count_image_plain(data, ids, h, w, compute_dtype)
    b, k, f = data.shape
    _require("data", data, (torch.float32, torch.bfloat16), (b, k, f))
    _require("ids", ids, (torch.int32,), (b, k))
    q = _image_operand(data, compute_dtype).contiguous()
    kind = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    acc = torch.zeros((b, h * w, f + 1), device=data.device)
    means = torch.empty((b, h * w, f), device=data.device)
    cnt = torch.empty((b, h * w), device=data.device)
    _launch("cmr_raster_image", _ptr(q), kind, _ptr(ids), _ptr(acc),
            _ptr(means), _ptr(cnt), b, k, f, h * w, _stream())
    segment_mean_count_image.launches += 1
    return means, cnt


segment_mean_count_image.launches = 0


# --------------------------------------------------------------------------
# 8. shared-data segment sum (the cost volume's warp)
# --------------------------------------------------------------------------

def segment_sum_shared_plain(data: torch.Tensor, idx: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """One ``data [B,N,F]`` summed under P index maps ``idx [B,P,N]`` ->
    ``[B,P,M,F]`` f32; a row whose idx lies outside [0, M) contributes
    nothing to that map."""
    b, n, f = data.shape
    p, m = idx.shape[1], num_segments
    valid = (idx >= 0) & (idx < m)
    seg = torch.where(valid, idx, torch.full_like(idx, m)).long()
    out = data.new_zeros((b, p, m + 1, f), dtype=torch.float32)
    out.scatter_add_(2, seg[..., None].expand(b, p, n, f),
                     data.float()[:, None].expand(b, p, n, f))
    return out[:, :, :m]


def segment_sum_shared(data: torch.Tensor, idx: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Kernel wrapper of :func:`segment_sum_shared_plain`: f32 ``data``,
    int32 ``idx``. The output is zeroed here, then filled by atomics."""
    if not _on_cuda(data, idx):
        return segment_sum_shared_plain(data, idx, num_segments)
    b, n, f = data.shape
    p, m = idx.shape[1], int(num_segments)
    _require("data", data, (torch.float32,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, p, n))
    if m < 1:
        raise ValueError(f"num_segments must be positive, got {m}")
    out = torch.zeros((b, p, m, f), device=data.device)
    _launch("cmr_segment_sum_shared", _ptr(data), _ptr(idx), _ptr(out), b, p,
            n, m, f, _stream())
    segment_sum_shared.launches += 1
    return out


segment_sum_shared.launches = 0


# --------------------------------------------------------------------------
# 9. stable mask compaction (the "pack"/"mega" episode's compaction)
# --------------------------------------------------------------------------

def mask_compact_pack_plain(mask: torch.Tensor, pcT: torch.Tensor,
                            feat: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked rows packed first-index-first -> ``(feat [B,k,F]`` in
    ``feat``'s dtype, ``pcT [B,3,k]`` f32``)``: output row ``j`` of a
    sample is its ``j``-th masked row; rows past ``min(count, k)`` are 0,
    and masked rows beyond the first ``k`` (the highest indices) are
    dropped. ``mask [B,N]`` bool or integer (non-zero keeps), ``pcT
    [B,3,N]``, ``feat [B,N,F]``. Exact: rows are copied, never summed."""
    b, n = mask.shape
    keep = mask != 0
    rank = torch.cumsum(keep, dim=1) - 1                      # [B, N]
    dest = torch.where(keep & (rank < k), rank, torch.full_like(rank, k))
    feat_out = feat.new_zeros((b, k + 1, feat.shape[-1]))
    feat_out.scatter_(1, dest[..., None].expand(-1, -1, feat.shape[-1]), feat)
    pc_out = pcT.new_zeros((b, 3, k + 1), dtype=torch.float32)
    pc_out.scatter_(2, dest[:, None, :].expand(-1, 3, -1), pcT.float())
    # the spill slot k took the rows that were not kept
    return feat_out[:, :k].contiguous(), pc_out[:, :, :k].contiguous()


def mask_compact_pack(mask: torch.Tensor, pcT: torch.Tensor,
                      feat: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`mask_compact_pack_plain`: f32 ``pcT``,
    ``feat`` of any dtype with an even row size in bytes (copied as
    bytes). Both outputs are zeroed here; two small launches (per-tile
    counts, then the ranked copy) count as one."""
    if not _on_cuda(mask, pcT, feat):
        return mask_compact_pack_plain(mask, pcT, feat, k)
    b, n = mask.shape
    f = feat.shape[-1]
    k = int(k)
    _require("pcT", pcT, (torch.float32,), (b, 3, n))
    _require("feat", feat, (feat.dtype,), (b, n, f))
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    mask = mask.contiguous()
    feat_out = torch.zeros((b, k, f), dtype=feat.dtype, device=feat.device)
    pc_out = torch.zeros((b, 3, k), device=feat.device)
    row_bytes = f * feat.element_size()
    chunk = next((c for c in (16, 4, 2)
                  if row_bytes % c == 0 and feat.data_ptr() % c == 0
                  and feat_out.data_ptr() % c == 0), None)
    if chunk is None:
        raise ValueError(f"feature rows of {row_bytes} bytes cannot be "
                         "copied in 2-byte chunks")
    tile_counts = torch.empty((b, (n + 255) // 256), dtype=torch.int32,
                              device=feat.device)
    _launch("cmr_mask_pack", _ptr(mask), _ptr(pcT), _ptr(feat),
            _ptr(tile_counts), _ptr(feat_out), _ptr(pc_out), b, n, k,
            row_bytes, chunk, _stream())
    mask_compact_pack.launches += 1
    return feat_out, pc_out


mask_compact_pack.launches = 0


# --------------------------------------------------------------------------
# autograd Functions (the JAX package's custom_vjp rules)
# --------------------------------------------------------------------------

class SegmentSoftmaxAttendFn(torch.autograd.Function):
    """:func:`segment_softmax_attend` with the closed-form backward of
    pallas_kernels.py:_bwd; ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, attn, values, idx, num_segments: int):
        out, sums, gmax = segment_softmax_attend(attn, values, idx,
                                                 num_segments,
                                                 return_stats=True)
        ctx.save_for_backward(attn, values, idx, out, sums, gmax)
        ctx.num_segments = num_segments
        return out

    @staticmethod
    def backward(ctx, grad):
        attn, values, idx, out, sums, gmax = ctx.saved_tensors
        dattn, dvalues = segment_softmax_attend_backward(
            attn, values, idx, out, sums, gmax, grad.contiguous(),
            ctx.num_segments)
        return dattn, dvalues, None, None


class GatherRowsFn(torch.autograd.Function):
    """:func:`gather_rows`; its backward is :func:`segment_sum` of the
    gradient widened to f32, cast back to the table's dtype
    (pallas_kernels.py:505-509)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.dtype = table.shape[1], table.dtype
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        d_table = segment_sum(grad.float().contiguous(), idx, ctx.num_rows)
        return d_table.to(ctx.dtype), None


class SegmentMeanCountImageFn(torch.autograd.Function):
    """:func:`segment_mean_count_image`; counts carry no gradient, and the
    means' gradient reaches the rows through :func:`gather_rows` of the
    sums' gradient (pallas_kernels.py:923-932)."""

    @staticmethod
    def forward(ctx, data, ids, h: int, w: int, compute_dtype=None):
        means, cnt = segment_mean_count_image(data, ids, h, w, compute_dtype)
        ctx.save_for_backward(ids, cnt)
        ctx.dtype = data.dtype
        ctx.mark_non_differentiable(cnt)
        return means, cnt

    @staticmethod
    def backward(ctx, grad_means, _grad_counts):
        ids, cnt = ctx.saved_tensors
        g_sums = (grad_means / cnt.clamp_min(1.0)[..., None]).contiguous()
        return gather_rows(g_sums, ids).to(ctx.dtype), None, None, None, None


WRAPPERS = (segment_softmax_attend, gather_rows, knn,
            segment_mean_count_image_project, segment_sum,
            segment_softmax_attend_backward, segment_mean_count_image,
            segment_sum_shared, mask_compact_pack)
PLAIN = {
    "segment_softmax_attend": segment_softmax_attend_plain,
    "gather_rows": gather_rows_plain,
    "knn": knn_plain,
    "segment_mean_count_image_project": segment_mean_count_image_project_plain,
    "segment_sum": segment_sum_plain,
    "segment_softmax_attend_backward": segment_softmax_attend_backward_plain,
    "segment_mean_count_image": segment_mean_count_image_plain,
    "segment_sum_shared": segment_sum_shared_plain,
    "mask_compact_pack": mask_compact_pack_plain,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
