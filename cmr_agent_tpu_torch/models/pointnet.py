"""PointNet++ modules (PyTorch twin of the JAX package's
``models/pointnet.py``; reference models/pointnet_util.py:96-308).

``sample_and_group(_all)``, the set-abstraction layers (single- and
multi-scale grouping) and feature propagation, channels-last, on the port's
``Linear`` and flax-semantics ``BatchNorm``. The constructors take the
reference's channel arguments (``in_channel``), which flax infers; the
submodule names are the JAX package's (``mlp_i``, ``bn_i``, ``scale_i``),
so :func:`..train.convert.flax_to_state_dict` carries JAX variables
across. The grouping gathers go through :func:`..ops.sampling.index_points`,
so tables of at most 2048 rows read at least 2^20 times take the gather
kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.sampling import (farthest_point_sample, index_points,
                            query_ball_point)
from .layers import BatchNorm, Linear


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor]):
    """FPS ``npoint`` centres (from index 0), ball-query ``nsample``
    neighbours, centre-relative coordinates, optional feature concat ->
    ``(new_xyz [B, S, 3], grouped [B, S, nsample, 3 (+D)])``."""
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint))
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    return new_xyz, _group(xyz, points, new_xyz, idx)


def _group(xyz, points, new_xyz, idx):
    grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return grouped
    return torch.cat([grouped, index_points(points, idx)], dim=-1)


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor]):
    """One group of the whole cloud around the origin ->
    ``(zeros [B, 1, 3], grouped [B, 1, N, 3 (+D)])``."""
    new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped


class _GroupMLP(nn.Module):
    """Shared Dense-BN-ReLU stack on the last axis (``mlp_i``, ``bn_i``)."""

    def __init__(self, in_channel: int, widths: Sequence[int]):
        super().__init__()
        self.depth = len(widths)
        for i, w in enumerate(widths):
            self.add_module(f"mlp_{i}", Linear(in_channel, w))
            self.add_module(f"bn_{i}", BatchNorm(w))
            in_channel = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"mlp_{i}")(x)))
        return x


class PointNetSetAbstraction(nn.Module):
    """SA layer: group -> shared MLP -> max over each group.
    ``in_channel`` is the grouped width, 3 + D."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.group_mlp = _GroupMLP(in_channel, mlp)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(self.npoint, self.radius,
                                                self.nsample, xyz, points)
        return new_xyz, self.group_mlp(grouped).amax(dim=2)


class PointNetSetAbstractionMsg(nn.Module):
    """Multi-scale-grouping SA layer: one ball query and MLP (``scale_i``)
    per radius on shared FPS centres, the maxes concatenated.
    ``in_channel`` is the feature width D (0 without features)."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channel: int,
                 mlp_list: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = radius_list, nsample_list
        for i, widths in enumerate(mlp_list):
            self.add_module(f"scale_{i}", _GroupMLP(in_channel + 3, widths))

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        feats = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                  self.nsample_list)):
            idx = query_ball_point(radius, nsample, xyz, new_xyz)
            grouped = _group(xyz, points, new_xyz, idx)
            feats.append(getattr(self, f"scale_{i}")(grouped).amax(dim=2))
        return new_xyz, torch.cat(feats, dim=-1)


class PointNetFeaturePropagation(nn.Module):
    """Inverse-distance interpolation from the 3 nearest of ``xyz2`` onto
    ``xyz1``, concatenated after ``points1``, then the shared MLP.
    ``in_channel`` is D1 + D2. The 3 nearest are the first three of a
    stable sort of the squared distances (JAX sorts and argsorts them)."""

    def __init__(self, in_channel: int, mlp: Sequence[int]):
        super().__init__()
        self.group_mlp = _GroupMLP(in_channel, mlp)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor], points2: torch.Tensor):
        b, n = xyz1.shape[0], xyz1.shape[1]
        if xyz2.shape[1] == 1:
            interpolated = points2.expand(b, n, points2.shape[-1])
        else:
            diff = xyz1[:, :, None, :] - xyz2[:, None, :, :]
            d = (diff * diff).sum(dim=-1)                  # [B, N, S]
            d3, idx = torch.sort(d, dim=-1, stable=True)
            d3, idx = d3[..., :3], idx[..., :3].to(torch.int32)
            w = 1.0 / (d3 + 1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            interpolated = (index_points(points2, idx) * w[..., None]).sum(
                dim=2)
        x = (interpolated if points1 is None
             else torch.cat([points1, interpolated], dim=-1))
        return self.group_mlp(x)
