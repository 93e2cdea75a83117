"""Point sampling / grouping ops.

PyTorch twins of the JAX package's ``ops/sampling.py``. ``index_points``
and ``knn_indices`` keep the JAX package's routing gates, so the same
calls reach the kernels (and the launch counts match the JAX path's).
``index_points`` is differentiable: above the gate through
:class:`~.kernels.GatherRowsFn` (backward: the segment-sum kernel), below
it through ``torch.gather``.

``nearest_assign``, ``farthest_point_sample``, ``query_ball_point`` and
``random_downsample_indices`` are XLA ops in the JAX package (no Pallas
kernel): plain PyTorch here on either device. Their draws take an
explicit ``torch.Generator`` where the JAX package takes a PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``[..., N, C] x [..., M, C] -> [..., N, M]``
    by the matmul expansion (reference models/pointnet_util.py:19-33)."""
    d = -2.0 * torch.einsum("...nc,...mc->...nm", src, dst)
    d = d + (src ** 2).sum(dim=-1)[..., :, None]
    return d + (dst ** 2).sum(dim=-1)[..., None, :]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: ``points [B, M, C]``, ``idx [B, ...]`` int32 ->
    ``[B, ..., C]``.

    The JAX package's gate (``sampling.py:52``) is kept on purpose: tables
    of at most 2048 rows read at least 2^20 (rows x table) times go to the
    gather kernel, with indices clamped into range first as the JAX path
    does; all other calls are a plain ``torch.gather``, as the JAX package
    uses ``take_along_axis`` there.
    """
    b, m = points.shape[0], points.shape[1]
    flat = idx.reshape(b, -1)
    if points.ndim == 3 and m <= 2048 and flat.shape[1] * m >= (1 << 20):
        out = kernels.GatherRowsFn.apply(points, flat.clamp(0, m - 1))
    else:
        gidx = flat.long()[..., None].expand(b, flat.shape[1],
                                             points.shape[-1])
        out = torch.gather(points, 1, gidx)
    return out.reshape(idx.shape + (points.shape[-1],))


def knn_indices(xyz: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours of ``query`` in ``xyz``: ``[B, M, k]`` int32.

    Batched 3-d clouds of at most 4096 points go to the knn kernel (the JAX
    gate at ``sampling.py:77``); others take the plain sort of
    :func:`square_distance` rows.
    """
    if (xyz.ndim == 3 and xyz.shape[-1] == 3
            and xyz.shape[1] <= kernels.KNN_MAX_POINTS):
        return kernels.knn(xyz, query, k)
    d = square_distance(query, xyz)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def nearest_assign(points: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """1-NN assignment ``[..., N, 3] x [..., M, 3] -> [..., N]`` int32 by
    the first minimum of the :func:`square_distance` rows (reference
    dataset/KittiDataset.py:363-367's cKDTree query)."""
    return torch.argmin(square_distance(points, centers),
                        dim=-1).to(torch.int32)


def farthest_point_sample(pts: torch.Tensor, num_samples: int,
                          generator: Optional[torch.Generator] = None,
                          init_idx=None) -> torch.Tensor:
    """Farthest-point sampling indices ``[B, num_samples]`` int32 of
    ``pts [B, N, 3]`` (``[num_samples]`` of ``[N, 3]``): the min-distance
    recurrence of the JAX package's ``_fps_single`` (reference
    dataset/KittiDataset.py:107-126), each step taking the FIRST farthest
    point, as ``jnp.argmax`` does. The start is ``init_idx`` (a scalar or
    ``[B]``), else a draw from ``generator``, else index 0."""
    single = pts.ndim == 2
    if single:
        pts = pts[None]
    b, n = pts.shape[0], pts.shape[1]
    if init_idx is None:
        if generator is not None:
            init_idx = torch.randint(0, n, (b,), generator=generator,
                                     device=generator.device)
        else:
            init_idx = torch.zeros(b, dtype=torch.int64)
    init = torch.as_tensor(init_idx).to(pts.device, torch.int64)
    init = init.reshape(-1).expand(b)
    rows = torch.arange(b, device=pts.device)

    def dist_to(i):                                   # i: [B] indices
        return ((pts - pts[rows, i][:, None, :]) ** 2).sum(dim=-1)

    idx = torch.empty((b, num_samples), dtype=torch.int64, device=pts.device)
    idx[:, 0] = init
    dists = dist_to(init)
    for i in range(1, num_samples):
        far = torch.argmax(dists, dim=-1)
        idx[:, i] = far
        dists = torch.minimum(dists, dist_to(far))
    idx = idx.to(torch.int32)
    return idx[0] if single else idx


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query (reference models/pointnet_util.py:73-93): for each
    centre of ``new_xyz [B, S, 3]`` the first ``nsample`` indices, in index
    order, of the points of ``xyz [B, N, 3]`` within ``radius`` (squared
    distance not above ``radius**2``), the rest padded with the first ->
    ``[B, S, nsample]`` int32. The smallest ``nsample`` of the masked
    index row are the sorted row's first ``nsample`` (JAX sorts it
    whole)."""
    n = xyz.shape[1]
    d = square_distance(new_xyz, xyz)                 # [B, S, N]
    arange = torch.arange(n, dtype=torch.int32, device=xyz.device)
    group_idx = torch.where(d > radius ** 2, torch.full_like(arange, n),
                            arange)
    group_idx = torch.topk(group_idx, nsample, dim=-1, largest=False,
                           sorted=True).values
    first = group_idx[..., :1].expand_as(group_idx)
    return torch.where(group_idx == n, first, group_idx).to(torch.int32)


def random_downsample_indices(generator: torch.Generator, n_in: int,
                              n_out: int) -> torch.Tensor:
    """Indices ``[n_out]`` that downsample or pad a cloud of ``n_in``
    points (reference dataset/KittiDataset.py:182-196): a random
    permutation's first ``n_out`` when there are enough points; else every
    point ``n_out // n_in`` times over, then ``n_out % n_in`` distinct
    random extras. Drawn from ``generator``, on its device."""
    dev = generator.device
    perm = torch.randperm(n_in, generator=generator, device=dev)
    if n_in >= n_out:
        return perm[:n_out]
    fixed = torch.arange(n_in, device=dev).repeat(n_out // n_in)
    return torch.cat([fixed, perm[:n_out - fixed.shape[0]]])
