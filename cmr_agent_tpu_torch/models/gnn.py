"""EdgeConv GNN embedding + siamese residual MLP (PyTorch twin of the JAX
package's ``models/gnn.py``; reference models/PointNN.py:10-93 and
:235-257). Channels-last throughout.

The point encoder's ``use_gnn_embedding`` branch runs :class:`MiniGNN`
on the raw points over the dataset's host-built knn (``pc_knn``). The
reference's branch is dead upstream (PointViT.py:51-56 ends in ``pass``),
so its ``state_dict`` names nothing here: the port names these modules
after the JAX package's (``embed_0``, ``edge_convs.<i>`` for its
``edge_<i>``, ``final``), and the weight bridge maps them one to one.

Like the JAX package's layers, which declare no compute dtype, these run
in f32 at least (flax promotes a bf16 input against the f32 parameters).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.sampling import index_points
from .layers import BatchNorm, DenseBN, Linear, ResDenseBlock, leaky


class EdgeConv(nn.Module):
    """One DGCNN edge conv: Dense-BN-LeakyReLU of ``[x_j - x_i, x_i]``,
    then the max over the ``K`` neighbours. ``x [B, N, C]``, ``knn_idx
    [B, N, K]`` -> ``[B, N, F]``.

    The neighbour table has N rows; above the gather kernel's gate of 2048
    rows (every full-size cloud) it is ``torch.gather``, as the JAX package
    takes ``take_along_axis`` there."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.layer = DenseBN(2 * cin, features)

    def forward(self, x: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
        neigh = index_points(x, knn_idx)                      # [B, N, K, C]
        center = x[:, :, None, :].expand_as(neigh)
        edge = torch.cat([neigh - center, center], dim=-1)
        return self.layer(edge).amax(dim=2)


class MiniGNN(nn.Module):
    """Static-knn EdgeConv stack (PointNN.py:10-93): a two-layer point
    embedding, five edge convs, a final pointwise layer."""

    def __init__(self, cin: int = 3, edge_conv_dim: int = 64,
                 out_features: int = 64):
        super().__init__()
        e, o = edge_conv_dim, out_features
        self.embed_0 = DenseBN(cin, e)
        self.embed_1 = DenseBN(e, e)
        dims = [e, e, o, o, o]
        self.edge_convs = nn.ModuleList(
            EdgeConv(c, d) for c, d in zip([e] + dims[:-1], dims))
        self.final = DenseBN(o, o)

    def forward(self, x: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        h = self.embed_1(self.embed_0(x))
        for conv in self.edge_convs:
            h = conv(h, knn_idx)
        return self.final(h)


class SiameseResMLP(nn.Module):
    """Residual pointwise MLP tower (PointNN.py:235-257): ``num_block``
    residual blocks, then Dense-BN-LeakyReLU-Dense. Its first block
    projects ``cin`` channels to ``features`` where they differ."""

    def __init__(self, features: int, num_block: int = 5, cin: int = None):
        super().__init__()
        cin = features if cin is None else cin
        self.res = nn.ModuleList(
            ResDenseBlock(cin if i == 0 else features, features)
            for i in range(num_block))
        self.out_0 = Linear(features, features)
        self.out_bn = BatchNorm(features)
        self.out_1 = Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        for blk in self.res:
            x = blk(x)
        return self.out_1(leaky(self.out_bn(self.out_0(x))))
