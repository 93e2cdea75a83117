"""Segment ops of the serving path (PyTorch twin of ``ops/scatter.py``)."""

from __future__ import annotations

import torch

from . import kernels


def batched_segment_softmax_attend(attn: torch.Tensor, values: torch.Tensor,
                                   segment_ids: torch.Tensor,
                                   num_segments: int) -> torch.Tensor:
    """``[B, N, F] x [B, N] -> [B, M, F]`` segmented softmax attention (the
    GroupPointTransformer group softmax, reference models/PointNN.py:167-182)
    through the segment-softmax kernel."""
    return kernels.segment_softmax_attend(attn, values, segment_ids,
                                          num_segments)
