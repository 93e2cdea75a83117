"""Segment ops (PyTorch twin of ``ops/scatter.py``).

* ``segment_sum`` / ``segment_max`` / ``segment_mean``, their ``batched_``
  forms and the unbatched ``segment_softmax_attend`` are XLA ops in the
  JAX package, not Pallas kernels: here they are ``index_add_`` /
  ``scatter_reduce_`` on either device (``via="matmul"`` the one-hot
  matmul). Ids outside ``[0, num_segments)`` are dropped, as
  ``jax.ops.segment_*`` drop them; an empty segment's max is the dtype's
  lowest value (``-inf`` for floats), its mean 0.
* ``batched_segment_softmax_attend`` (the group softmax) and
  ``scatter_mean_image`` (the observation raster) run the kernels, both
  differentiable through the kernels' autograd Functions.
"""

from __future__ import annotations

import torch

from . import kernels


def _routed(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Flat int64 ids with every id outside ``[0, num_segments)`` sent to
    the dump bucket ``num_segments``."""
    ids = segment_ids.reshape(-1).long()
    out = (ids < 0) | (ids >= num_segments)
    return torch.where(out, torch.full_like(ids, num_segments), ids)


def _use_matmul(data: torch.Tensor, num_segments: int, via: str) -> bool:
    if via == "auto":
        # one-hot matmul only for rank-2 float data on large N (JAX
        # scatter.py:47-54)
        return (data.ndim == 2 and data.is_floating_point()
                and data.shape[0] >= 4096 and num_segments <= 8192)
    if via not in ("scatter", "matmul"):
        raise ValueError(f"unknown via {via!r}")
    return via == "matmul" and data.ndim == 2


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, via: str = "auto") -> torch.Tensor:
    """Sum of ``data [N, ...]`` rows per segment -> ``[num_segments, ...]``.
    ``via``: ``"scatter"`` (``index_add_``), ``"matmul"`` (a one-hot
    ``[num_segments, N]`` matrix times ``data``, rank-2 data only) or
    ``"auto"`` (the matmul for rank-2 float data with ``N >= 4096`` and at
    most 8192 segments)."""
    if _use_matmul(data, num_segments, via):
        seg = torch.arange(num_segments, device=data.device)[:, None]
        onehot = (seg == segment_ids.long()[None, :]).to(data.dtype)
        return onehot @ data
    out = data.new_zeros((num_segments + 1,) + data.shape[1:])
    out.index_add_(0, _routed(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per segment; an empty segment holds the
    dtype's lowest value (``-inf`` for floats), as ``jax.ops.segment_max``
    gives it."""
    low = (-float("inf") if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments + 1,) + data.shape[1:], low)
    ids = _routed(segment_ids, num_segments)
    ids = ids.view((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
    out.scatter_reduce_(0, ids, data, reduce="amax", include_self=True)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, via: str = "auto") -> torch.Tensor:
    """Mean per segment; an empty segment is 0 (torch_scatter's
    ``scatter_mean``). The sums follow ``via``, the counts a scatter."""
    total = segment_sum(data, segment_ids, num_segments, via=via)
    ones = data.new_ones((data.shape[0],))
    count = segment_sum(ones, segment_ids, num_segments, via="scatter")
    count = count.reshape((num_segments,) + (1,) * (data.ndim - 1))
    return total / count.clamp_min(1.0)


def segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                           segment_ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """Per-channel softmax of ``attn [N, F]`` within each segment, then the
    per-segment sum of ``softmax * values`` -> ``[num_segments, F]`` (JAX
    ``scatter.py:79-108``; reference models/PointNN.py:167-182), each
    segment shifted by its own max. Empty segments give 0; rows with an id
    out of range read the nearest segment's max and sum, as JAX's clamped
    gathers do, and are dropped."""
    g_max = segment_max(attn, segment_ids, num_segments)
    at = segment_ids.long().clamp(0, num_segments - 1)
    ex = torch.exp(attn - g_max[at])
    g_sum = segment_sum(ex, segment_ids, num_segments, via="scatter")
    weight = ex / g_sum[at].clamp_min(1e-30)
    return segment_sum(weight * values, segment_ids, num_segments)


def _batched(fn, data, segment_ids, num_segments, *args):
    """``fn`` over the leading batch axis (the JAX package's ``vmap``)."""
    return torch.stack([fn(d, i, num_segments, *args)
                        for d, i in zip(data, segment_ids)])


def batched_segment_sum(data, segment_ids, num_segments: int,
                        via: str = "auto") -> torch.Tensor:
    """``[B, N, ...] x [B, N] -> [B, num_segments, ...]``."""
    return _batched(segment_sum, data, segment_ids, num_segments, via)


def batched_segment_max(data, segment_ids,
                        num_segments: int) -> torch.Tensor:
    return _batched(segment_max, data, segment_ids, num_segments)


def batched_segment_mean(data, segment_ids, num_segments: int,
                         via: str = "auto") -> torch.Tensor:
    return _batched(segment_mean, data, segment_ids, num_segments, via)


def batched_segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                                   segment_ids: torch.Tensor,
                                   num_segments: int) -> torch.Tensor:
    """``[B, N, F] x [B, N] -> [B, M, F]`` segmented softmax attention (the
    GroupPointTransformer group softmax, reference models/PointNN.py:167-182)
    through the segment-softmax kernel and its backward."""
    return kernels.SegmentSoftmaxAttendFn.apply(attn, values, segment_ids,
                                                num_segments)


def scatter_mean_image(feat: torch.Tensor, pixel_ids: torch.Tensor,
                       valid: torch.Tensor, h: int, w: int,
                       compute_dtype=None, mode: str = "flat"
                       ) -> torch.Tensor:
    """Rasterise per-point features into an ``[B, h, w, F]`` mean image
    (0 where no point lands), the JAX package's ``scatter_mean_image``
    (``scatter.py:134-188``): invalid points go to id ``h*w`` and are
    routed out. ``mode`` "flat" is the pixel-id raster kernel (with its
    gradient); "compact" the compacting raster kernel, for a whole,
    unordered cloud (with its gradient, the row gather of the sums'). ``compute_dtype``
    None/f32, bf16 (one rounding of the inputs, f32 sums) or int8 (absmax
    quantised, exact integer sums)."""
    ids = torch.where(valid, pixel_ids,
                      torch.full_like(pixel_ids, h * w)).to(torch.int32)
    ids = ids.contiguous()
    if mode == "compact":
        sums, counts = kernels.SegmentSumCountImageCompactFn.apply(
            feat.contiguous(), ids, h, w, compute_dtype)
        means = sums / counts.clamp_min(1.0)[..., None]
    elif mode == "flat":
        means, _ = kernels.SegmentMeanCountImageFn.apply(
            feat.contiguous(), ids, h, w, compute_dtype)
    else:
        raise ValueError(f"unknown raster mode {mode!r}")
    return means.reshape(feat.shape[0], h, w, feat.shape[-1])
