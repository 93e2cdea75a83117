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
:func:`segment_sum_count_image_compact`   ``segment_sum_count_image_compact``
:func:`fused_dense_chain`                 ``fused_dense_chain``
:func:`fused_dense_chain_cn`              ``fused_dense_chain_cn``
:func:`segment_sum_image`                 ``segment_sum_image_fused``
                                          (factored; the band kernel
                                          of the flat raster)
========================================  ==================================

Gradients: :class:`SegmentSoftmaxAttendFn`, :class:`GatherRowsFn`,
:class:`SegmentMeanCountImageFn`, :class:`SegmentSumImageFn` and
:class:`SegmentSumCountImageCompactFn` are ``torch.autograd.Function``s
whose forward and backward both go through the wrappers above (kernel or
plain version by device), as the JAX package's ``custom_vjp`` rules do;
:class:`DenseChainFn` (called through :func:`dense_chain`) launches the
chain kernel forward and differentiates the plain chain backward, as the
JAX package's chain VJP differentiates its pure-jnp mirror. They look the
wrappers up at call time, so swapping a wrapper for its plain version
(``PLAIN``) swaps it in both directions.

Operators: every forward wrapper but the chain's packing does its work
through one PyTorch operator of the ``cmr`` namespace, named as the
wrapper (``torch.ops.cmr.segment_softmax_attend``, ...; :data:`OPERATORS`).
The dispatcher sends CUDA tensors to the launch (which counts it) and CPU
tensors to the plain version; the fake implementation gives the outputs'
shapes and dtypes and raises, on CUDA tensors, what the launch refuses
before it reaches the card. So ``torch.export`` keeps each kernel as one
node of its graph (``train/export.py``), and a CUDA graph captures the
launch. Registering them needs neither a card nor ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "cmr_segment_softmax_attend": [_P, _P, _I, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _P],
    "cmr_segment_softmax_scratch_bytes": [_I, _I, _I, _I],
    "cmr_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmr_knn": [_P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_raster_project": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _P],
    "cmr_segment_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmr_segment_sum_scratch_bytes": [_I, _I, _I, _I],
    "cmr_segment_softmax_backward": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _I, _P],
    "cmr_raster_image": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    "cmr_segment_sum_shared": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmr_mask_pack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmr_dense_chain": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _F, _F, _F, _P],
    "cmr_dense_chain_cn": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F, _F, _F, _P],
    "cmr_error_string": [_I],
}
_RESTYPES = {"cmr_error_string": ctypes.c_char_p,
             "cmr_segment_sum_scratch_bytes": ctypes.c_longlong,
             "cmr_segment_softmax_scratch_bytes": ctypes.c_longlong}
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = build.load()
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
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


# the kernels' own refusals (csrc/common.cuh), beside CUDA's error codes
_REFUSALS = {-1: "unsupported argument",
             -2: "the operands do not fit in a block's shared memory"}


def _launch(fn_name: str, *args) -> None:
    lib = library()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = (lib.cmr_error_string(err).decode() if err > 0 else
               _REFUSALS.get(err, "unsupported argument"))
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
    -> ``[B,M,F]``. Stabilised by the global per-(b, channel) max (exact:
    the shift is constant within every segment). Empty segments give 0;
    idx outside [0, M) contributes nothing.

    ``return_stats=True`` returns ``(out, sums [B,M,F], gmax [B,F])``, the
    residuals of :func:`segment_softmax_attend_backward`.

    bf16 operands are widened to f32 first (exact, as the kernel widens
    them), so the answer is f32 and equals the f32 call on the widened
    tensors; f32 and f64 stay as they are. The shifted logits ``attn -
    gmax`` are rounded to that dtype, as the kernel rounds them; ``exp`` is
    taken in f64 and rounded once to it (the correctly rounded exp,
    whatever vector library the host's f32 ``exp`` would reach); the
    per-segment sums and weighted sums are f64, and the output is rounded
    once. So the answer does not depend on the host, and on the card it
    differs from the kernel's only where ``expf`` is not correctly rounded
    and in the f32 rounding of the sums."""
    dt = torch.promote_types(attn.dtype, torch.float32)
    attn, values = attn.to(dt), values.to(dt)
    b, n, f = attn.shape
    m = num_segments
    gmax = attn.amax(dim=1)
    e = torch.exp((attn - gmax[:, None, :]).double()).to(dt).double()
    valid = (idx >= 0) & (idx < m)
    e = torch.where(valid[..., None], e, torch.zeros_like(e))
    seg = torch.where(valid, idx, torch.zeros_like(idx)).long()
    seg = seg[..., None].expand(b, n, f)
    sums = e.new_zeros((b, m, f)).scatter_add_(1, seg, e)
    out = e.new_zeros((b, m, f)).scatter_add_(1, seg, e * values.double())
    out = (out / sums.clamp_min(1e-30)).to(dt)
    if return_stats:
        return out, sums.to(dt), gmax
    return out


@functools.lru_cache(maxsize=64)
def _segment_softmax_scratch_bytes(b: int, n: int, m: int, f: int) -> int:
    return library().cmr_segment_softmax_scratch_bytes(b, n, m, f)


def segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor, num_segments: int,
                           return_stats: bool = False):
    """Kernel wrapper of :func:`segment_softmax_attend_plain`: ``attn`` and
    ``values`` ``[B,N,F]`` both f32 or both bf16, read as given and widened
    in registers (the output is f32); int32 ``idx [B,N]``;
    ``num_segments`` at most 65535. The kernel buckets the rows by segment
    and writes ``out``, ``sums`` and ``gmax`` once each, every segment's
    rows added in ascending order in fixed pieces: the same bits on every
    run, and ``return_stats`` costs nothing."""
    out, sums, gmax = OPERATORS["segment_softmax_attend"](
        attn, values, idx, int(num_segments))
    return (out, sums, gmax) if return_stats else out


segment_softmax_attend.launches = 0

# M past 65535 does not fit the bucketing's 16-bit segment ids (kernels 1,
# 5 and 7), nor more than 65536 rows kernel 7's
MAX_SEGMENTS = 65535


def _refuse_segments(fn_name: str, m: int) -> None:
    """Raises as the launch of ``fn_name`` refuses ``m`` past
    :data:`MAX_SEGMENTS` (the kernel's -1)."""
    if m > MAX_SEGMENTS:
        raise RuntimeError(f"{fn_name} failed: {_REFUSALS[-1]} (-1): "
                           f"num_segments {m} > {MAX_SEGMENTS}")


def _check_segment_softmax_attend(attn, values, idx, m: int) -> None:
    """Raises what the launch refuses, on CUDA tensors (the plain version
    takes any CPU ones)."""
    if not _on_cuda(attn, values, idx):
        return
    b, n, f = attn.shape
    _require("attn", attn, (torch.float32, torch.bfloat16), (b, n, f))
    _require("values", values, (attn.dtype,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, n))
    if min(m, n, f) < 1:
        raise ValueError(f"segment softmax kernel needs N, F and "
                         f"num_segments >= 1; got N={n}, F={f}, M={m}")
    _refuse_segments("cmr_segment_softmax_attend", m)


def _segment_softmax_attend_cuda(attn, values, idx, m: int):
    _check_segment_softmax_attend(attn, values, idx, m)
    b, n, f = attn.shape
    dev = attn.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(_segment_softmax_scratch_bytes(b, n, m, f), dev,
                       stream)
    gmax = torch.empty((b, f), device=dev)
    sums = torch.empty((b, m, f), device=dev)
    out = torch.empty((b, m, f), device=dev)
    _launch("cmr_segment_softmax_attend", _ptr(attn), _ptr(values),
            int(attn.dtype == torch.bfloat16), _ptr(idx), _ptr(scratch),
            _ptr(gmax), _ptr(sums), _ptr(out), b, n, m, f,
            ctypes.c_void_p(stream))
    segment_softmax_attend.launches += 1
    return out, sums, gmax


def _segment_softmax_attend_fake(attn, values, idx, m: int):
    _check_segment_softmax_attend(attn, values, idx, m)
    b, n, f = attn.shape
    dt = torch.promote_types(attn.dtype, torch.float32)
    return (attn.new_empty((b, m, f), dtype=dt),
            attn.new_empty((b, m, f), dtype=dt),
            attn.new_empty((b, f), dtype=dt))


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
    return OPERATORS["gather_rows"](table, idx)


def _check_gather_rows(table, idx) -> None:
    if not _on_cuda(table, idx):
        return
    b, m, f = table.shape
    _require("table", table, (torch.float32, torch.bfloat16), (b, m, f))
    _require("idx", idx, (torch.int32,), (b, idx.shape[1]))


def _gather_rows_fake(table, idx):
    _check_gather_rows(table, idx)
    return table.new_empty((table.shape[0], idx.shape[1], table.shape[2]))


def _gather_rows_cuda(table, idx):
    _check_gather_rows(table, idx)
    b, m, f = table.shape
    n = idx.shape[1]
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
    return OPERATORS["knn"](xyz, query, int(k))


def _check_knn(xyz, query, k: int) -> None:
    if not _on_cuda(xyz, query):
        return
    b, n, _ = xyz.shape
    _require("xyz", xyz, (torch.float32,), (b, n, 3))
    _require("query", query, (torch.float32,), (b, query.shape[1], 3))
    if not 1 <= k <= min(KNN_MAX_K, n) or n > KNN_MAX_POINTS:
        raise ValueError(f"knn kernel supports 1 <= k <= min(32, N) and "
                         f"N <= {KNN_MAX_POINTS}; got k={k}, N={n}")


def _knn_fake(xyz, query, k: int):
    _check_knn(xyz, query, k)
    return xyz.new_empty((xyz.shape[0], query.shape[1],
                          min(k, xyz.shape[1])), dtype=torch.int32)


def _knn_cuda(xyz, query, k: int):
    _check_knn(xyz, query, k)
    b, n, _ = xyz.shape
    m = query.shape[1]
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
    absmax = f32.abs().amax(dim=1).clamp_min(1e-12)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its f32 reciprocal, which can differ from the IEEE quotient in the
    # last bit; the kernel and the CPU divide
    scale = absmax / torch.full_like(absmax, 127.0)
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


def _raster_sum_count(q: torch.Tensor, scale: Optional[torch.Tensor],
                      pix: torch.Tensor, hw: int):
    """Shared tail of the plain rasters: ``q [B,K,F]`` (f32/bf16 summed in
    f32, int8 in exact int32 then scaled by ``scale [B,F]``) summed with a
    ones column into pixel ``pix [B,K]`` (``hw`` = dropped) -> ``(sums
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
    return sums, cnt


def _raster_mean_count(q: torch.Tensor, scale: Optional[torch.Tensor],
                       pix: torch.Tensor, hw: int):
    """:func:`_raster_sum_count` -> ``(means [B,hw,F], counts [B,hw])``."""
    sums, cnt = _raster_sum_count(q, scale, pix, hw)
    return sums / cnt.clamp_min(1.0)[..., None], cnt


# operand mode of the raster kernel by compute dtype, and back (the
# operators take the mode)
_RASTER_MODES = {None: 0, torch.float32: 0, torch.bfloat16: 1,
                 torch.int8: 2}
_MODE_DTYPES = (None, torch.bfloat16, torch.int8)


def _raster_mode(compute_dtype) -> int:
    if compute_dtype not in _RASTER_MODES:
        raise ValueError(f"unsupported raster compute dtype {compute_dtype}")
    return _RASTER_MODES[compute_dtype]


def segment_mean_count_image_project(
        pcT: torch.Tensor, feat: torch.Tensor, ab: torch.Tensor,
        counts: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_mean_count_image_project_plain`:
    ``feat`` f32 or bf16, read as it comes; the bf16 rounding and the int8
    quantisation (``scale`` by a reduction kernel over all K rows, as
    :func:`quantize_int8`) happen on the card. Each output element is
    written once."""
    return OPERATORS["segment_mean_count_image_project"](
        pcT, feat, ab, counts, int(h), int(w), _raster_mode(compute_dtype))


def _check_raster_project(pcT, feat, ab, counts, h: int, w: int) -> None:
    if not _on_cuda(pcT, feat, ab, counts):
        return
    b, _, k = pcT.shape
    f = feat.shape[-1]
    _require("pcT", pcT, (torch.float32,), (b, 3, k))
    _require("feat", feat, (torch.float32, torch.bfloat16), (b, k, f))
    _require("ab", ab, (torch.float32,), (b, 12))
    _require("counts", counts, (torch.int32,), (b,))
    if min(k, f, h, w) < 1:
        raise ValueError(f"raster kernel needs K, F, h, w >= 1; got K={k}, "
                         f"F={f}, h={h}, w={w}")


def _image_outputs(data, h: int, w: int):
    """Empty ``([B,h*w,F], [B,h*w])`` f32 like a raster's outputs."""
    b, f = data.shape[0], data.shape[-1]
    return (data.new_empty((b, h * w, f), dtype=torch.float32),
            data.new_empty((b, h * w), dtype=torch.float32))


def _raster_project_fake(pcT, feat, ab, counts, h: int, w: int, mode: int):
    _check_raster_project(pcT, feat, ab, counts, h, w)
    return _image_outputs(feat, h, w)


def _raster_project_cuda(pcT, feat, ab, counts, h: int, w: int, mode: int):
    _check_raster_project(pcT, feat, ab, counts, h, w)
    b, _, k = pcT.shape
    f = feat.shape[-1]
    dev = pcT.device
    # scratch: pixel ids [B, K] int32, then (int8) scale [B, F] f32
    pix_bytes = -(-b * k * 4 // 16) * 16
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = _scratch(pix_bytes + b * f * 4, dev, stream)
    scale = buf.data_ptr() + pix_bytes if mode == 2 else None
    means = torch.empty((b, h * w, f), device=dev)
    cnt = torch.empty((b, h * w), device=dev)
    _launch("cmr_raster_project", _ptr(pcT), _ptr(feat),
            int(feat.dtype == torch.bfloat16), mode, _ptr(ab), _ptr(counts),
            ctypes.c_void_p(scale), _ptr(buf), _ptr(means), _ptr(cnt),
            b, k, f, h, w, ctypes.c_void_p(stream))
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


@functools.lru_cache(maxsize=64)
def _segment_sum_scratch_bytes(b: int, n: int, m: int, f: int) -> int:
    return library().cmr_segment_sum_scratch_bytes(b, n, m, f)


_SCRATCH: dict = {}


def _scratch(nbytes: int, device: torch.device, stream: int
             ) -> torch.Tensor:
    """A byte buffer of at least ``nbytes`` on ``device``, kept for the
    CUDA ``stream`` between calls: a kernel that takes it reads and writes
    it only while it runs, and the stream runs its calls in order.

    While the stream is captured into a CUDA graph, a buffer of the call's
    own instead, from the graph's private pool: the graph replays into it
    for as long as the graph lives, and no later call or capture can free
    or grow it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    key = (device, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf


def segment_sum(data: torch.Tensor, idx: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Kernel wrapper of :func:`segment_sum_plain`: f32 ``data``, int32
    ``idx``, ``num_segments`` at most 65535. The kernel buckets the rows by
    segment, then writes every output row once, its rows added in ascending
    order in fixed pieces: the same bits on every run."""
    return OPERATORS["segment_sum"](data, idx, int(num_segments))


def _check_segment_sum(data, idx, m: int) -> None:
    if not _on_cuda(data, idx):
        return
    b, n, f = data.shape
    _require("data", data, (torch.float32,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, n))
    if m < 1:
        raise ValueError(f"num_segments must be positive, got {m}")
    _refuse_segments("cmr_segment_sum", m)


def _segment_sum_fake(data, idx, m: int):
    _check_segment_sum(data, idx, m)
    return data.new_empty((data.shape[0], m, data.shape[2]))


def _segment_sum_cuda(data, idx, m: int):
    _check_segment_sum(data, idx, m)
    b, n, f = data.shape
    stream = torch.cuda.current_stream(data.device).cuda_stream
    nbytes = _segment_sum_scratch_bytes(b, n, m, f)
    scratch = _scratch(nbytes, data.device, stream) if nbytes else None
    out = torch.empty((b, m, f), device=data.device)
    _launch("cmr_segment_sum", _ptr(data), _ptr(idx), _ptr(scratch),
            _ptr(out), b, n, m, f, ctypes.c_void_p(stream))
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_mean_count(data: torch.Tensor, idx: torch.Tensor,
                       num_segments: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic segment mean + counts ``-> (means [B,M,F], counts [B,M])``:
    :func:`segment_sum` of the rows with a ones column appended (the JAX
    package's ``segment_mean_count_fused``); empty segments mean 0."""
    ones = data.new_ones(data.shape[:2] + (1,))
    sums = segment_sum(torch.cat([data, ones], dim=-1), idx, num_segments)
    counts = sums[..., -1]
    return sums[..., :-1] / counts.clamp_min(1.0)[..., None], counts


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
    ``dattn = w g[seg] (values - out[seg])``; 0 for routed-out rows.

    bf16 operands are widened to f32 first, as the forward widened them,
    and the two gradients are rounded once to bf16 at the end: the kernel's
    bf16 mode, the exact derivative of the widened forward rounded to the
    operands' dtype."""
    dt = torch.promote_types(attn.dtype, torch.float32)
    valid = ((idx >= 0) & (idx < num_segments))[..., None]

    def at(table):
        return gather_rows_plain(table, idx)

    w = torch.exp(attn.to(dt) - gmax[:, None, :]) / at(sums).clamp_min(1e-30)
    gw = torch.where(valid, w, torch.zeros_like(w)) * at(grad)
    dattn = gw * (values.to(dt) - at(out))
    return dattn.to(attn.dtype), gw.to(values.dtype)


def segment_softmax_attend_backward(
        attn: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
        out: torch.Tensor, sums: torch.Tensor, gmax: torch.Tensor,
        grad: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_softmax_attend_backward_plain`:
    ``attn`` and ``values`` both f32 or both bf16, read as given and
    widened in registers; ``out``, ``sums``, ``gmax`` and ``grad`` f32;
    int32 ``idx``. The gradients come out in the operands' dtype (bf16:
    the f32 result rounded once); the gather of the three ``[B,M,F]``
    tables is fused into the kernel. Any other dtype on the card raises."""
    if not _on_cuda(attn, values, idx, out, sums, gmax, grad):
        return segment_softmax_attend_backward_plain(
            attn, values, idx, out, sums, gmax, grad, num_segments)
    b, n, f = attn.shape
    m = int(num_segments)
    _require("attn", attn, (torch.float32, torch.bfloat16), (b, n, f))
    _require("values", values, (attn.dtype,), (b, n, f))
    for name, t, shape in (("out", out, (b, m, f)), ("sums", sums, (b, m, f)),
                           ("gmax", gmax, (b, f)), ("grad", grad, (b, m, f))):
        _require(name, t, (torch.float32,), shape)
    _require("idx", idx, (torch.int32,), (b, n))
    dattn = torch.empty_like(attn)
    dvalues = torch.empty_like(values)
    _launch("cmr_segment_softmax_backward", _ptr(attn), _ptr(values),
            int(attn.dtype == torch.bfloat16), _ptr(idx), _ptr(out),
            _ptr(sums), _ptr(gmax), _ptr(grad), _ptr(dattn), _ptr(dvalues),
            b, n, m, f, _stream())
    segment_softmax_attend_backward.launches += 1
    return dattn, dvalues


segment_softmax_attend_backward.launches = 0


# --------------------------------------------------------------------------
# 7. pixel-id observation raster (mean + count per pixel)
# --------------------------------------------------------------------------

def _pixel_id_raster(data, ids, h: int, w: int, compute_dtype):
    """The plain pixel-id rasters' common part -> ``(sums, counts)``. Ids
    outside ``[0, h*w)`` are routed out."""
    hw = h * w
    q, scale = _operands(data, compute_dtype)
    pix = torch.where((ids >= 0) & (ids < hw), ids, torch.full_like(ids, hw))
    return _raster_sum_count(q, scale, pix, hw)


def _image_raster(data, ids, h: int, w: int, compute_dtype, sums: bool):
    """The pixel-id band kernel (``csrc/raster.cu``) on CUDA tensors ->
    ``(out [B,h*w,F], counts [B,h*w])``, ``out`` each pixel's means or,
    with ``sums``, its sums: ``data`` f32 or bf16, read as it comes; int32
    ``ids``. The bf16 rounding and the
    int8 quantisation (``scale`` by the absmax prepass over all K rows, as
    :func:`quantize_int8`) happen on the card; each output element is
    written once, the same bits on every launch. Raises on what the kernel
    cannot take."""
    mode = _raster_mode(compute_dtype)
    _check_image_raster(data, ids, h, w)
    b, k, f = data.shape
    dev = data.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = _scratch(b * f * 4, dev, stream) if mode == 2 else None
    out = torch.empty((b, h * w, f), device=dev)
    cnt = torch.empty((b, h * w), device=dev)
    _launch("cmr_raster_image", _ptr(data), int(data.dtype == torch.bfloat16),
            mode, _ptr(ids), _ptr(scale), _ptr(out), _ptr(cnt), b, k, f,
            h * w, int(sums), ctypes.c_void_p(stream))
    return out, cnt


def _factored_mean_count(sum_image, data, ids, h: int, w: int,
                         compute_dtype):
    """Means and counts from the factored raster ``sum_image`` of the rows
    with a ones column appended (pallas_kernels.py:938-946): the counts
    are sums of exact ones, the means ``sums / max(count, 1)``."""
    ones = data.new_ones(data.shape[:2] + (1,))
    sums = sum_image(torch.cat([data, ones], dim=-1), ids, h, w,
                     compute_dtype)
    counts = sums[..., -1]
    return sums[..., :-1] / counts.clamp_min(1.0)[..., None], counts


def segment_mean_count_image_plain(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None, factored: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-id raster -> ``(means [B,h*w,F], counts [B,h*w])`` f32.

    ``data [B,K,F]``; ``ids [B,K]`` pixel ``y*w + x`` per row, any id
    outside ``[0, h*w)`` routed out. ``compute_dtype`` None/f32, bf16
    (rows rounded to bf16 once, f32 sums) or int8 (:func:`quantize_int8`
    over all K rows, exact integer sums, then scaled). ``factored=True``
    takes :func:`segment_sum_image_plain` of the rows and a ones column
    instead (no int8, ``w <= 128``)."""
    if factored:
        return _factored_mean_count(segment_sum_image_plain, data, ids, h, w,
                                    compute_dtype)
    sums, cnt = _pixel_id_raster(data, ids, h, w, compute_dtype)
    return sums / cnt.clamp_min(1.0)[..., None], cnt


def segment_mean_count_image(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None, factored: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_mean_count_image_plain`: the
    pixel-id band kernel (:func:`_image_raster`, the projection-fused
    raster's band kernel on the caller's ids) writing means; the episodes
    keep this default. ``factored=True`` keeps the JAX package's factored
    path and its refusals: on CUDA tensors the same band kernel through
    :class:`SegmentMeanCountImageFn` (no ones column copied; the same bits
    as ``factored=False``), its launch counted by :func:`segment_sum_image`
    as well, the factored kernel's count; on the CPU the plain ones-column
    form through :class:`SegmentSumImageFn`. Both carry the gradient."""
    if factored:
        _factored_refusal(w, compute_dtype)
        if not _on_cuda(data, ids):
            return _factored_mean_count(SegmentSumImageFn.apply, data, ids,
                                        h, w, compute_dtype)
        out = SegmentMeanCountImageFn.apply(data, ids, h, w, compute_dtype)
        segment_sum_image.launches += 1
        return out
    return OPERATORS["segment_mean_count_image"](
        data, ids, int(h), int(w), _raster_mode(compute_dtype))


segment_mean_count_image.launches = 0


def _check_image_raster(data, ids, h: int, w: int) -> None:
    if not _on_cuda(data, ids):
        return
    b, k, f = data.shape
    _require("data", data, (torch.float32, torch.bfloat16), (b, k, f))
    _require("ids", ids, (torch.int32,), (b, k))
    if min(k, f, h, w) < 1:
        raise ValueError(f"raster kernel needs K, F, h, w >= 1; got K={k}, "
                         f"F={f}, h={h}, w={w}")


def _image_raster_fake(data, ids, h: int, w: int, mode: int):
    _check_image_raster(data, ids, h, w)
    return _image_outputs(data, h, w)


def _segment_mean_count_image_cuda(data, ids, h: int, w: int, mode: int):
    out = _image_raster(data, ids, h, w, _MODE_DTYPES[mode], sums=False)
    segment_mean_count_image.launches += 1
    return out


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
    int32 ``idx``, at most 65536 rows and 65535 segments. A block per
    hypothesis buckets its rows by segment and writes its ``[M, F]`` slab
    once, each segment's rows added in ascending order: the same bits on
    every run."""
    return OPERATORS["segment_sum_shared"](data, idx, int(num_segments))


segment_sum_shared.launches = 0


def _check_segment_sum_shared(data, idx, m: int) -> None:
    if not _on_cuda(data, idx):
        return
    b, n, f = data.shape
    _require("data", data, (torch.float32,), (b, n, f))
    _require("idx", idx, (torch.int32,), (b, idx.shape[1], n))
    if m < 1:
        raise ValueError(f"num_segments must be positive, got {m}")
    _refuse_segments("cmr_segment_sum_shared", m)
    if n > MAX_SEGMENTS + 1:
        raise RuntimeError(f"cmr_segment_sum_shared failed: {_REFUSALS[-1]} "
                           f"(-1): {n} rows > {MAX_SEGMENTS + 1}")


def _segment_sum_shared_fake(data, idx, m: int):
    _check_segment_sum_shared(data, idx, m)
    b, p = idx.shape[:2]
    return data.new_empty((b, p, m, data.shape[2]), dtype=torch.float32)


def _segment_sum_shared_cuda(data, idx, m: int):
    _check_segment_sum_shared(data, idx, m)
    b, n, f = data.shape
    p = idx.shape[1]
    out = torch.empty((b, p, m, f), device=data.device)
    _launch("cmr_segment_sum_shared", _ptr(data), _ptr(idx), _ptr(out), b, p,
            n, m, f, _stream())
    segment_sum_shared.launches += 1
    return out


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


def _mask_pack_into(mask: torch.Tensor, pcT: torch.Tensor,
                    feat: torch.Tensor, feat_out: torch.Tensor,
                    pc_out: torch.Tensor) -> None:
    """Launches the mask-pack kernel (``csrc/mask_pack.cu``) into
    ``feat_out [B,k,F]`` and ``pc_out [B,3,k]``, every element of which it
    writes; raises on what the kernel cannot take. ``mask`` bool or uint8,
    contiguous."""
    b, n = mask.shape
    k, f = feat_out.shape[1], feat.shape[-1]
    _require("mask", mask, (torch.bool, torch.uint8), (b, n))
    _require("pcT", pcT, (torch.float32,), (b, 3, n))
    _require("feat", feat, (feat.dtype,), (b, n, f))
    _require("feat_out", feat_out, (feat.dtype,), (b, k, f))
    _require("pc_out", pc_out, (torch.float32,), (b, 3, k))
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    row_bytes = f * feat.element_size()
    chunk = next((c for c in (16, 4, 2)
                  if row_bytes % c == 0 and feat.data_ptr() % c == 0
                  and feat_out.data_ptr() % c == 0), None)
    if chunk is None:
        raise ValueError(f"feature rows of {row_bytes} bytes cannot be "
                         "copied in 2-byte chunks")
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    scratch = _scratch((b * k + b) * 4, feat.device, stream)
    _launch("cmr_mask_pack", _ptr(mask), _ptr(pcT), _ptr(feat),
            _ptr(scratch), _ptr(feat_out), _ptr(pc_out), b, n, k, row_bytes,
            chunk, ctypes.c_void_p(stream))


def mask_compact_pack(mask: torch.Tensor, pcT: torch.Tensor,
                      feat: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`mask_compact_pack_plain`: f32 ``pcT``,
    ``feat`` of any dtype with an even row size in bytes (copied as
    bytes). The outputs come from ``torch.empty``: one launch ranks each
    sample's kept rows, the next writes every slot once, kept rows and
    zeros (:func:`_mask_pack_into`); the two count as one."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return OPERATORS["mask_compact_pack"](mask.contiguous(), pcT, feat, int(k))


def _check_mask_pack(mask, pcT, feat, k: int) -> None:
    """What :func:`_mask_pack_into` refuses before it reads a pointer."""
    if not _on_cuda(mask, pcT, feat):
        return
    b, n = mask.shape
    f = feat.shape[-1]
    _require("mask", mask, (torch.bool, torch.uint8), (b, n))
    _require("pcT", pcT, (torch.float32,), (b, 3, n))
    _require("feat", feat, (feat.dtype,), (b, n, f))
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if (f * feat.element_size()) % 2:
        raise ValueError(f"feature rows of {f * feat.element_size()} bytes "
                         "cannot be copied in 2-byte chunks")


def _mask_pack_fake(mask, pcT, feat, k: int):
    _check_mask_pack(mask, pcT, feat, k)
    b = mask.shape[0]
    return (feat.new_empty((b, k, feat.shape[-1])),
            feat.new_empty((b, 3, k), dtype=torch.float32))


def _mask_pack_cuda(mask, pcT, feat, k: int):
    _check_mask_pack(mask, pcT, feat, k)
    b = mask.shape[0]
    feat_out = torch.empty((b, k, feat.shape[-1]), dtype=feat.dtype,
                           device=feat.device)
    pc_out = torch.empty((b, 3, k), device=feat.device)
    _mask_pack_into(mask, pcT, feat, feat_out, pc_out)
    mask_compact_pack.launches += 1
    return feat_out, pc_out


mask_compact_pack.launches = 0


# --------------------------------------------------------------------------
# 10. compacting pixel-id raster (the "compact" eval episode's raster)
# --------------------------------------------------------------------------

def segment_sum_count_image_compact_plain(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-id raster -> ``(sums [B,h*w,F], counts [B,h*w])`` f32 over
    every row whose id lies in ``[0, h*w)``, none dropped. ``data [B,N,F]``
    in any order (the whole, uncompacted cloud); ``ids
    [B,N]``. ``compute_dtype`` None/f32, bf16 (rows rounded once, f32 sums)
    or int8 (:func:`quantize_int8` over all N rows, exact integer sums,
    then scaled), so that ``sums / max(counts, 1)`` is the "flat" raster's
    mean in every dtype. (The JAX kernel's int8 mode casts without
    quantising; see ROADMAP C.)"""
    return _pixel_id_raster(data, ids, h, w, compute_dtype)


def segment_sum_count_image_compact(
        data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
        compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of :func:`segment_sum_count_image_compact_plain`:
    the pixel-id band kernel writing sums (:func:`_image_raster`), f32 or
    bf16 ``data`` read as it comes, int32 ``ids``; in int8 the absmax
    prepass first. Each band lists the rows landing in it from all N ids,
    so no tile packing is needed."""
    return OPERATORS["segment_sum_count_image_compact"](
        data, ids, int(h), int(w), _raster_mode(compute_dtype))


segment_sum_count_image_compact.launches = 0


def _segment_sum_count_image_compact_cuda(data, ids, h: int, w: int,
                                          mode: int):
    out = _image_raster(data, ids, h, w, _MODE_DTYPES[mode], sums=True)
    segment_sum_count_image_compact.launches += 1
    return out


# --------------------------------------------------------------------------
# 11. fused dense chain, row-major [B,N,C] and channel-major [B,C,N]
# --------------------------------------------------------------------------

CHAIN_MAX_CHANNELS = 128
CHAIN_MAX_LAYERS = 3
_RESIDUALS = ("none", "identity", "proj", "identity_split")


def _leaky(x: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    return x if slope is None else torch.where(x >= 0, x, x * slope)


def _batch_bias(bias: torch.Tensor, b: int) -> torch.Tensor:
    """A ``[C]`` or per-batch ``[B,C]`` bias as ``[B,C]`` f32."""
    return bias.float().expand(b, bias.shape[-1])


def _check_chain(c0: int, weights, res_weight, pooled, slopes,
                 residual: str) -> None:
    if residual not in _RESIDUALS:
        raise ValueError(f"residual must be one of {_RESIDUALS}, got "
                         f"{residual!r}")
    if len(slopes) != len(weights):
        raise ValueError("one slope (or None) per layer")
    c_out = weights[-1].shape[-1]
    if residual == "identity" and c0 != c_out:
        raise ValueError(f"identity residual needs C_in == C_out, got "
                         f"{c0} vs {c_out}")
    if residual == "identity_split" and (
            pooled is None or c0 + pooled.shape[-1] != c_out):
        raise ValueError("identity_split needs pooled with C_in + P == C_out")
    if residual == "proj" and res_weight is None:
        raise ValueError("proj residual needs res_weight and res_bias")


def fused_dense_chain_plain(x: torch.Tensor, weights, biases,
                            res_weight=None, res_bias=None, pooled=None,
                            slopes=(), residual: str = "none",
                            final_slope=None, out_max: bool = False):
    """``L`` pointwise layers over ``x [B,N,C0]`` (f32 or bf16):
    ``acc_i = leaky(h_{i-1} @ W_i + b_i, slopes[i])`` with the products
    of ``x.dtype`` values summed in f32 and ``h_i = acc_i`` rounded to
    ``x.dtype`` (``slopes[i] = None`` skips the activation); then the
    residual added to the last ``acc`` in f32 — "identity" ``x``, "proj"
    ``x @ res_weight + res_bias``, "identity_split" the virtual
    ``concat(x, broadcast(pooled))`` — then ``final_slope`` and one
    rounding to ``x.dtype``. ``W_i [C_{i-1}, C_i]`` are cast to
    ``x.dtype``; biases are ``[C]`` or per-batch ``[B,C]``, added in f32.
    With ``out_max`` also returns the per-(sample, channel) max over the N
    rows of the final f32 ``acc``, rounded to ``x.dtype``, ``[B,C]``."""
    _check_chain(x.shape[-1], weights, res_weight, pooled, slopes, residual)
    b, dt = x.shape[0], x.dtype
    h, acc = x, None
    for w, bias, slope in zip(weights, biases, slopes):
        acc = h.float() @ w.to(dt).float()
        acc = _leaky(acc + _batch_bias(bias, b)[:, None, :], slope)
        h = acc.to(dt)
    if residual == "proj":
        acc = acc + (x.float() @ res_weight.to(dt).float()
                     + _batch_bias(res_bias, b)[:, None, :])
    elif residual == "identity":
        acc = acc + x.float()
    elif residual == "identity_split":
        p = pooled.to(dt).float()[:, None, :].expand(b, x.shape[1], -1)
        acc = acc + torch.cat([x.float(), p], dim=-1)
    acc = _leaky(acc, final_slope)
    out = acc.to(dt)
    return (out, acc.amax(dim=1).to(dt)) if out_max else out


def fused_dense_chain_cn_plain(x: torch.Tensor, weights, biases,
                               res_weight=None, res_bias=None, pooled=None,
                               slopes=(), residual: str = "none",
                               final_slope=None, out_max: bool = False):
    """:func:`fused_dense_chain_plain` on channel-major ``x [B,C0,N]`` ->
    ``[B,C,N]`` (``out_max`` still ``[B,C]``); the same arithmetic per
    point."""
    res = fused_dense_chain_plain(x.transpose(1, 2), weights, biases,
                                  res_weight, res_bias, pooled, slopes,
                                  residual, final_slope, out_max)
    if out_max:
        return res[0].transpose(1, 2).contiguous(), res[1]
    return res.transpose(1, 2).contiguous()


def _pad_pow2(c: int) -> int:
    """A width padded for the tensor-core kernel: 16, 32, 64 or 128."""
    return next(p for p in (16, 32, 64, 128) if c <= p)


def pack_chain_weights(mats, dtype) -> torch.Tensor:
    """The chain kernel's weight buffer: ``mats`` (``[Cin, Cout]`` each,
    the layers' then the projection's) cast to ``dtype``, one after the
    other, each written once into a zeroed buffer through a view of its
    slot.

    bf16 (the tensor-core kernel): each matrix zero-padded to 16, 32, 64
    or 128 in both dims and laid out in ``mma.m16n8k16`` B-fragment order,
    ``[k-tile][n-tile][lane][2 registers][2 halves]``: lane ``4 g + t`` of
    (k-tile ``kt``, n-tile ``nt``) holds ``W[16 kt + 8 r + 2 t + e, 8 nt +
    g]`` in half ``e`` of register ``r``. f32 (the CUDA-core kernel): each
    matrix row-major with its columns zero-padded to 64, or to 128 past 64.
    """
    bf16 = dtype == torch.bfloat16
    shapes = []
    for m in mats:
        k, n = m.shape
        shapes.append((_pad_pow2(k), _pad_pow2(n)) if bf16 else
                      (k, 64 if n <= 64 else 128))
    buf = torch.zeros(sum(k * n for k, n in shapes), dtype=dtype,
                      device=mats[0].device)
    off = 0
    for m, (kp, np_) in zip(mats, shapes):
        slot = buf[off:off + kp * np_]
        off += kp * np_
        k, n = m.shape
        if not bf16:
            slot.view(kp, np_)[:, :n].copy_(m)
            continue
        if (k, n) != (kp, np_):
            m = torch.nn.functional.pad(m, (0, np_ - n, 0, kp - k))
        # [kt][nt][g][t][r][e] seen as [kt][r][t][e][nt][g] = [k][n]
        slot.view(kp // 16, np_ // 8, 8, 4, 2, 2).permute(
            0, 4, 3, 5, 1, 2).copy_(m.reshape(kp // 16, 2, 4, 2, np_ // 8, 8))
    return buf


def _check_dense_chain(cn: bool, x, weights, res_weight, pooled, slopes,
                       residual: str) -> list:
    """The chain kernel's refusals -> its widths ``[C0, C1, ..., CL]``."""
    c0 = x.shape[1] if cn else x.shape[2]
    _check_chain(c0, weights, res_weight, pooled, slopes, residual)
    _require("x", x, (torch.float32, torch.bfloat16), x.shape)
    dims = [c0] + [w.shape[-1] for w in weights]
    if not 1 <= len(weights) <= CHAIN_MAX_LAYERS or \
            max(dims) > CHAIN_MAX_CHANNELS:
        raise ValueError(f"the chain kernel takes 1-{CHAIN_MAX_LAYERS} "
                         f"layers of at most {CHAIN_MAX_CHANNELS} channels; "
                         f"got {dims}")
    for i, w in enumerate(weights):
        if tuple(w.shape) != (dims[i], dims[i + 1]):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)}, expected "
                             f"{(dims[i], dims[i + 1])}")
    return dims


def _slope(v) -> float:
    """A slope of None as 1: LeakyReLU with slope 1 is the identity, bit
    for bit, in the kernel and in :func:`_leaky` alike."""
    return 1.0 if v is None else float(v)


def _chain_call(cn: bool, x, weights, biases, res_weight, res_bias, pooled,
                slopes, residual, final_slope, out_max):
    """The chain operator (layout ``cn``) on a wrapper's arguments. For
    CUDA tensors the weights go packed (:func:`pack_chain_weights`) and
    the f32 ``[B, C]`` bias rows in one buffer, made here, outside the
    operator; the CPU's plain version takes the layers as they are."""
    packed = bias_rows = None
    if _on_cuda(*_chain_tensors(x, weights, biases, res_weight, res_bias,
                                pooled)):
        _check_dense_chain(cn, x, weights, res_weight, pooled, slopes,
                           residual)
        proj = residual == "proj"
        packed = pack_chain_weights(
            list(weights) + ([res_weight] if proj else []), x.dtype)
        rows = list(biases) + ([res_bias] if proj else [])
        bias_rows = torch.cat([_batch_bias(v, x.shape[0]) for v in rows],
                              dim=1).contiguous()
    op = OPERATORS["fused_dense_chain_cn" if cn else "fused_dense_chain"]
    out, mx = op(x, list(weights), list(biases), res_weight, res_bias, pooled,
                 packed, bias_rows, [_slope(v) for v in slopes], residual,
                 _slope(final_slope), bool(out_max))
    return (out, mx) if out_max else out


def _dense_chain_fake(cn: bool, x, weights, biases, res_weight, res_bias,
                      pooled, packed, bias_rows, slopes, residual,
                      final_slope, out_max):
    c_out = weights[-1].shape[-1]
    if _on_cuda(*_chain_tensors(x, weights, biases, res_weight, res_bias,
                                pooled)):
        _check_dense_chain(cn, x, weights, res_weight, pooled, slopes,
                           residual)
    else:
        _check_chain(x.shape[1 if cn else 2], weights, res_weight, pooled,
                     slopes, residual)
    b, n = x.shape[0], x.shape[2 if cn else 1]
    out = x.new_empty((b, c_out, n) if cn else (b, n, c_out))
    return out, x.new_empty((b, c_out) if out_max else (0,))


def _dense_chain(cn: bool, x, weights, biases, res_weight, res_bias, pooled,
                 packed, bias_rows, slopes, residual, final_slope, out_max):
    """Launch the chain kernel of ``csrc/dense_chain.cu`` (layout ``cn``)
    on the packed weights and bias rows of :func:`_chain_call`."""
    dims = _check_dense_chain(cn, x, weights, res_weight, pooled, slopes,
                              residual)
    if packed is None or bias_rows is None:
        raise ValueError("the chain kernel takes its weights packed "
                         "(pack_chain_weights) and its bias rows")
    if not _on_cuda(*_chain_tensors(x, weights, biases, res_weight, res_bias,
                                    pooled), packed, bias_rows):
        raise ValueError("the chain kernel takes CUDA tensors")
    b, n, dt = x.shape[0], x.shape[2 if cn else 1], x.dtype
    prow = (pooled.to(dt).float().contiguous()
            if residual == "identity_split" else None)
    c_out = dims[-1]
    out = torch.empty((b, c_out, n) if cn else (b, n, c_out), dtype=dt,
                      device=x.device)
    mx = (torch.full((b, c_out), float("-inf"), device=x.device)
          if out_max else None)
    dims4 = dims + [0] * (CHAIN_MAX_LAYERS + 1 - len(dims))
    s = list(slopes) + [1.0] * (CHAIN_MAX_LAYERS - len(slopes))
    _launch("cmr_dense_chain_cn" if cn else "cmr_dense_chain", _ptr(x),
            0 if dt == torch.float32 else 1, _ptr(packed), _ptr(bias_rows),
            _ptr(prow), _ptr(out), _ptr(mx), b, n, len(weights), *dims4,
            _RESIDUALS.index(residual), *s, final_slope, _stream())
    return out, (mx.to(dt) if out_max else x.new_empty((0,)))


def fused_dense_chain(x: torch.Tensor, weights, biases, res_weight=None,
                      res_bias=None, pooled=None, slopes=(),
                      residual: str = "none", final_slope=None,
                      out_max: bool = False):
    """Kernel wrapper of :func:`fused_dense_chain_plain`: f32 or bf16
    ``x [B,N,C0]``, 1-3 layers, every width at most 128, whose packed
    weights fit in a block's shared memory (the kernel refuses others:
    a RuntimeError). bf16 runs on the
    tensor cores, f32 on the CUDA cores; both keep the weights in shared
    memory for the whole launch. No gradient: :func:`dense_chain` adds
    it."""
    return _chain_call(False, x, weights, biases, res_weight, res_bias,
                       pooled, slopes, residual, final_slope, out_max)


fused_dense_chain.launches = 0


def fused_dense_chain_cn(x: torch.Tensor, weights, biases, res_weight=None,
                         res_bias=None, pooled=None, slopes=(),
                         residual: str = "none", final_slope=None,
                         out_max: bool = False):
    """Kernel wrapper of :func:`fused_dense_chain_cn_plain`: f32 or bf16
    ``x [B,C0,N]``, as :func:`fused_dense_chain`."""
    return _chain_call(True, x, weights, biases, res_weight, res_bias,
                       pooled, slopes, residual, final_slope, out_max)


fused_dense_chain_cn.launches = 0


def _chain_tensors(x, weights, biases, *rest):
    return [x, *weights, *biases, *(t for t in rest if t is not None)]


# --------------------------------------------------------------------------
# 12. factored pixel-id raster sum (tools/raster_probe's "fact" cases)
# --------------------------------------------------------------------------

FACTORED_MAX_W = 128


def _factored_refusal(w: int, compute_dtype) -> None:
    """Raises as the JAX package's factored path does
    (pallas_kernels.py:629-634), though the band kernel could take both."""
    if compute_dtype == torch.int8:
        raise ValueError("int8 raster is implemented for the flat kernel "
                         "only")
    if w > FACTORED_MAX_W:
        raise ValueError(f"factored raster kernel needs w <= "
                         f"{FACTORED_MAX_W}, got {w}")


def segment_sum_image_plain(data: torch.Tensor, ids: torch.Tensor, h: int,
                            w: int, compute_dtype=None) -> torch.Tensor:
    """Pixel-id raster sums ``data [B,N,F] x ids [B,N] -> [B,h*w,F]`` f32:
    row ``j`` adds into pixel ``ids[b, j] = y*w + x``; any id outside
    ``[0, h*w)`` (negative ones too) contributes nothing. ``compute_dtype``
    None/f32, or bf16 (rows rounded to bf16 once, f32 sums); int8 and
    ``w > 128`` raise ``ValueError``."""
    _factored_refusal(w, compute_dtype)
    q = _operands(data, compute_dtype)[0].float()
    b, n, f = q.shape
    hw = h * w
    pix = torch.where((ids >= 0) & (ids < hw), ids, torch.full_like(ids, hw))
    out = q.new_zeros((b, hw + 1, f))
    out.scatter_add_(1, pix.long()[..., None].expand(b, n, f), q)
    return out[:, :hw]


def segment_sum_image(data: torch.Tensor, ids: torch.Tensor, h: int, w: int,
                      compute_dtype=None) -> torch.Tensor:
    """Kernel wrapper of :func:`segment_sum_image_plain`: f32 or bf16
    ``data`` read as it comes, int32 ``ids``. The TPU kernel's factoring
    (a 128-lane column one-hot times a gate per image row) was made for its
    vector unit; here the pixel-id band kernel writing sums computes the
    same function, each pixel's sum in a fixed order."""
    _factored_refusal(w, compute_dtype)
    return OPERATORS["segment_sum_image"](
        data, ids, int(h), int(w), _raster_mode(compute_dtype))


segment_sum_image.launches = 0


def _segment_sum_image_fake(data, ids, h: int, w: int, mode: int):
    _factored_refusal(w, _MODE_DTYPES[mode])
    _check_image_raster(data, ids, h, w)
    return _image_outputs(data, h, w)[0]


def _segment_sum_image_cuda(data, ids, h: int, w: int, mode: int):
    _factored_refusal(w, _MODE_DTYPES[mode])
    out, _ = _image_raster(data, ids, h, w, _MODE_DTYPES[mode], sums=True)
    segment_sum_image.launches += 1
    return out


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
        # bf16 operands go to the kernel as given (it widens them as the
        # forward did) and their gradients come back in bf16
        dattn, dvalues = segment_softmax_attend_backward(
            attn, values, idx, out, sums, gmax, grad.float().contiguous(),
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


class SegmentSumImageFn(torch.autograd.Function):
    """:func:`segment_sum_image`; its backward is :func:`gather_rows` of the
    sums' gradient, zero for routed-out rows, the bf16 rounding
    differentiated as the identity (pallas_kernels.py:705-717)."""

    @staticmethod
    def forward(ctx, data, ids, h: int, w: int, compute_dtype=None):
        ctx.save_for_backward(ids)
        ctx.dtype = data.dtype
        return segment_sum_image(data, ids, h, w, compute_dtype)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        d_data = gather_rows(grad.contiguous(), ids)
        return d_data.to(ctx.dtype), None, None, None, None


class SegmentSumCountImageCompactFn(torch.autograd.Function):
    """:func:`segment_sum_count_image_compact`; counts carry no gradient,
    and the sums' gradient reaches the rows through :func:`gather_rows`
    (zero for routed-out rows), the input's rounding to its compute dtype
    differentiated as the identity (pallas_kernels.py:882-893)."""

    @staticmethod
    def forward(ctx, data, ids, h: int, w: int, compute_dtype=None):
        sums, cnt = segment_sum_count_image_compact(data, ids, h, w,
                                                    compute_dtype)
        ctx.save_for_backward(ids)
        ctx.dtype = data.dtype
        ctx.mark_non_differentiable(cnt)
        return sums, cnt

    @staticmethod
    def backward(ctx, grad_sums, _grad_counts):
        (ids,) = ctx.saved_tensors
        d_data = gather_rows(grad_sums.float().contiguous(), ids)
        return d_data.to(ctx.dtype), None, None, None, None


class DenseChainFn(torch.autograd.Function):
    """:func:`fused_dense_chain` (or, with ``cn``, :func:`fused_dense_chain_cn`)
    forward; its backward is autograd of the plain chain recomputed from
    the saved inputs, as the JAX package's ``_chain_bwd`` takes ``jax.vjp``
    of ``_dense_chain_reference`` (pallas_kernels.py:1171-1179,
    :1371-1379). Gradients reach ``x``, every weight and bias, the
    residual's weight and bias and ``pooled``; with ``out_max`` both
    outputs carry one. The tensors come one by one (a tuple is invisible to
    autograd): ``x``, the ``L`` weights, the ``L`` biases, then
    ``res_weight``, ``res_bias`` and ``pooled`` (each may be None)."""

    @staticmethod
    def forward(ctx, cn: bool, n_layers: int, slopes, residual: str,
                final_slope, out_max: bool, x, *tensors):
        weights, biases = tensors[:n_layers], tensors[n_layers:2 * n_layers]
        res_weight, res_bias, pooled = tensors[2 * n_layers:]
        chain = fused_dense_chain_cn if cn else fused_dense_chain
        ctx.save_for_backward(x, *tensors)
        ctx.config = (cn, n_layers, slopes, residual, final_slope, out_max)
        return chain(x, weights, biases, res_weight, res_bias, pooled,
                     slopes=slopes, residual=residual,
                     final_slope=final_slope, out_max=out_max)

    @staticmethod
    def backward(ctx, *grads):
        cn, n_layers, slopes, residual, final_slope, out_max = ctx.config
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[6:]
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, wanted)]
        x, tensors = leaves[0], leaves[1:]
        plain = fused_dense_chain_cn_plain if cn else fused_dense_chain_plain
        with torch.enable_grad():
            outs = plain(x, tensors[:n_layers],
                         tensors[n_layers:2 * n_layers],
                         *tensors[2 * n_layers:], slopes=slopes,
                         residual=residual, final_slope=final_slope,
                         out_max=out_max)
        outs = outs if out_max else (outs,)
        inputs = [t for t, need in zip(leaves, wanted) if need]
        got = iter(torch.autograd.grad(outs, inputs, grads,
                                       allow_unused=True) if inputs else ())
        d = [next(got) if need else None for need in wanted]
        return (None,) * 6 + tuple(d)


def dense_chain(x: torch.Tensor, weights, biases, res_weight=None,
                res_bias=None, pooled=None, slopes=(),
                residual: str = "none", final_slope=None,
                out_max: bool = False, cn: bool = False):
    """The fused dense chain with its gradient: :class:`DenseChainFn` on
    :func:`fused_dense_chain`'s arguments (``cn`` picks the channel-major
    kernel). What the fused eval stacks call."""
    if len(weights) != len(biases):
        raise ValueError("one bias per layer")
    return DenseChainFn.apply(cn, len(weights), tuple(slopes), residual,
                              final_slope, out_max, x, *weights, *biases,
                              res_weight, res_bias, pooled)


# --------------------------------------------------------------------------
# the kernels as operators of the ``cmr`` namespace
# --------------------------------------------------------------------------

def _fused_dense_chain_cuda(*args):
    out = _dense_chain(False, *args)
    fused_dense_chain.launches += 1
    return out


def _fused_dense_chain_cn_cuda(*args):
    out = _dense_chain(True, *args)
    fused_dense_chain_cn.launches += 1
    return out


def _chain_plain(plain):
    def cpu(x, weights, biases, res_weight, res_bias, pooled, _packed,
            _bias_rows, slopes, residual, final_slope, out_max):
        out = plain(x, weights, biases, res_weight, res_bias, pooled, slopes,
                    residual, final_slope, out_max)
        return out if out_max else (out, x.new_empty((0,)))
    return cpu


def _with_mode(plain):
    """A plain raster taking the operators' mode for its compute dtype."""
    return lambda *args: plain(*args[:-1], _MODE_DTYPES[args[-1]])


def _contiguous(out):
    """Outputs as the fake implementations give them: a plain version may
    return a view of a larger buffer."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


_CHAIN_SCHEMA = ("(Tensor x, Tensor[] weights, Tensor[] biases, "
                 "Tensor? res_weight, Tensor? res_bias, Tensor? pooled, "
                 "Tensor? packed_weights, Tensor? bias_rows, float[] slopes, "
                 "str residual, float final_slope, bool out_max) "
                 "-> (Tensor, Tensor)")
_RASTER_SCHEMA = "(Tensor data, Tensor ids, int h, int w, int mode)"
# name -> (schema, CUDA implementation (the launch), CPU implementation (the
# plain version), fake implementation)
_OPERATOR_TABLE = {
    "segment_softmax_attend": (
        "(Tensor attn, Tensor values, Tensor idx, int num_segments) "
        "-> (Tensor, Tensor, Tensor)", _segment_softmax_attend_cuda,
        lambda a, v, i, m: segment_softmax_attend_plain(a, v, i, m, True),
        _segment_softmax_attend_fake),
    "gather_rows": ("(Tensor table, Tensor idx) -> Tensor",
                    _gather_rows_cuda, gather_rows_plain, _gather_rows_fake),
    "knn": ("(Tensor xyz, Tensor query, int k) -> Tensor", _knn_cuda,
            knn_plain, _knn_fake),
    "segment_mean_count_image_project": (
        "(Tensor pcT, Tensor feat, Tensor ab, Tensor counts, int h, int w, "
        "int mode) -> (Tensor, Tensor)", _raster_project_cuda,
        _with_mode(segment_mean_count_image_project_plain),
        _raster_project_fake),
    "segment_sum": ("(Tensor data, Tensor idx, int num_segments) -> Tensor",
                    _segment_sum_cuda, segment_sum_plain, _segment_sum_fake),
    "segment_mean_count_image": (
        _RASTER_SCHEMA + " -> (Tensor, Tensor)",
        _segment_mean_count_image_cuda,
        _with_mode(segment_mean_count_image_plain), _image_raster_fake),
    "segment_sum_shared": (
        "(Tensor data, Tensor idx, int num_segments) -> Tensor",
        _segment_sum_shared_cuda, segment_sum_shared_plain,
        _segment_sum_shared_fake),
    "mask_compact_pack": (
        "(Tensor mask, Tensor pcT, Tensor feat, int k) -> (Tensor, Tensor)",
        _mask_pack_cuda, mask_compact_pack_plain, _mask_pack_fake),
    "segment_sum_count_image_compact": (
        _RASTER_SCHEMA + " -> (Tensor, Tensor)",
        _segment_sum_count_image_compact_cuda,
        _with_mode(segment_sum_count_image_compact_plain),
        _image_raster_fake),
    "fused_dense_chain": (
        _CHAIN_SCHEMA, _fused_dense_chain_cuda,
        _chain_plain(fused_dense_chain_plain),
        functools.partial(_dense_chain_fake, False)),
    "fused_dense_chain_cn": (
        _CHAIN_SCHEMA, _fused_dense_chain_cn_cuda,
        _chain_plain(fused_dense_chain_cn_plain),
        functools.partial(_dense_chain_fake, True)),
    "segment_sum_image": (
        _RASTER_SCHEMA + " -> Tensor", _segment_sum_image_cuda,
        _with_mode(segment_sum_image_plain), _segment_sum_image_fake),
}


def _register(lib: torch.library.Library) -> dict:
    ops = {}
    for name, (schema, cuda, cpu, fake) in _OPERATOR_TABLE.items():
        lib.define(name + schema)
        lib.impl(name, cuda, "CUDA")
        lib.impl(name, lambda *args, cpu=cpu: _contiguous(cpu(*args)), "CPU")
        torch.library.register_fake(f"cmr::{name}", fake, lib=lib)
        ops[name] = getattr(torch.ops.cmr, name).default
    return ops


_LIBRARY = torch.library.Library("cmr", "DEF")
#: wrapper name -> its ``torch.ops.cmr`` operator (the forward kernels)
OPERATORS = _register(_LIBRARY)


WRAPPERS = (segment_softmax_attend, gather_rows, knn,
            segment_mean_count_image_project, segment_sum,
            segment_softmax_attend_backward, segment_mean_count_image,
            segment_sum_shared, mask_compact_pack,
            segment_sum_count_image_compact, fused_dense_chain,
            fused_dense_chain_cn, segment_sum_image)
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
    "segment_sum_count_image_compact": segment_sum_count_image_compact_plain,
    "fused_dense_chain": fused_dense_chain_plain,
    "fused_dense_chain_cn": fused_dense_chain_cn_plain,
    "segment_sum_image": segment_sum_image_plain,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
