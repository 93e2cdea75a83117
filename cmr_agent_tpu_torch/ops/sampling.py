"""Point sampling / grouping ops of the serving path.

PyTorch twins of the JAX package's ``ops/sampling.py``. ``index_points``
and ``knn_indices`` keep the JAX package's routing gates, so the same
calls reach the kernels (and the launch counts match the JAX path's).
"""

from __future__ import annotations

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
        out = kernels.gather_rows(points, flat.clamp(0, m - 1))
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
