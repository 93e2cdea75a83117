"""Segment ops (PyTorch twin of ``ops/scatter.py``): the group softmax and
the observation raster, both differentiable through the kernels'
autograd Functions."""

from __future__ import annotations

import torch

from . import kernels


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
                       compute_dtype=None) -> torch.Tensor:
    """Rasterise per-point features into an ``[B, h, w, F]`` mean image
    (0 where no point lands), the JAX package's ``scatter_mean_image`` in
    its flat mode (``scatter.py:134-188``): invalid points go to id
    ``h*w`` and are routed out by the pixel-id raster kernel.
    ``compute_dtype`` None/f32 or bf16 (one rounding of the inputs, f32
    sums)."""
    ids = torch.where(valid, pixel_ids,
                      torch.full_like(pixel_ids, h * w)).to(torch.int32)
    means, _ = kernels.SegmentMeanCountImageFn.apply(
        feat, ids.contiguous(), h, w, compute_dtype)
    return means.reshape(feat.shape[0], h, w, feat.shape[-1])
