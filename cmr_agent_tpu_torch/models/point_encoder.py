"""Point branch: grouped/knn point transformers + proxy ViT (PyTorch twin
of the JAX package's ``models/point_encoder.py``; reference
models/PointNN.py:126-232 and PointViT.py:8-205).

The group softmax goes through the segment-softmax kernel, the node/point
gathers through ``index_points`` (gather kernel above the JAX package's
gate) and the node neighbourhood through the knn kernel.

With ``use_gnn_embedding`` the points (not the nodes) are embedded by the
EdgeConv :class:`~.gnn.MiniGNN` over the batch's ``pc_knn`` plus a
pointwise positional MLP, as the JAX package completes the reference's
dead branch (PointViT.py:16-28, 51-56).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..config import Config
from ..ops.sampling import index_points, knn_indices
from ..ops.scatter import batched_segment_softmax_attend
from .gnn import MiniGNN
from .layers import DenseBN, Linear, MiniPointNet, ViTBlock


def _mlp2(cin: int, f: int, dtype) -> nn.Sequential:
    """Linear-ReLU-Linear (the reference's ``fc_delta`` / ``fc_gamma``)."""
    return nn.Sequential(Linear(cin, f, dtype=dtype), nn.ReLU(),
                         Linear(f, f, dtype=dtype))


class GroupPointTransformer(nn.Module):
    """Point-transformer attention from N points into their node
    (PointNN.py:126-185): ``xyz [B,N,3], x_feat [B,N,F], node [B,M,3],
    node_feat [B,M,F], idx [B,N]`` -> node features ``[B,M,F]``."""

    def __init__(self, f: int, dtype=None):
        super().__init__()
        self.fc1_0 = Linear(f, f, dtype=dtype)
        self.fc1_1 = Linear(f, f, dtype=dtype)
        self.fc2 = Linear(f, f, dtype=dtype)
        self.fc_delta = _mlp2(3, f, dtype)
        self.fc_gamma = _mlp2(f, f, dtype)
        self.w_qs = Linear(f, f, bias=False, dtype=dtype)
        self.w_ks = Linear(f, f, bias=False, dtype=dtype)
        self.w_vs = Linear(f, f, bias=False, dtype=dtype)

    def forward(self, xyz, x_feat, node, node_feat, idx):
        f = node_feat.shape[-1]
        m = node.shape[1]
        x = self.fc1_0(x_feat)
        q = self.w_qs(self.fc1_1(node_feat))                  # [B, M, F]
        k, v = self.w_ks(x), self.w_vs(x)                     # [B, N, F]
        q_at_pt = index_points(q, idx)
        centers = index_points(node, idx)
        pos = self.fc_delta((xyz - centers).to(x_feat.dtype))
        attn = self.fc_gamma(q_at_pt - k + pos)
        attn = attn / math.sqrt(f)
        # the kernel reads f32 or bf16 as given and widens in registers
        # (exact, the JAX package's cast to f32); its output is f32
        agg = batched_segment_softmax_attend(
            attn.contiguous(), (v + pos).contiguous(), idx, m)
        return self.fc2(agg.to(attn.dtype)) + node_feat


class KnnPointTransformer(nn.Module):
    """Vector attention over k nearest neighbours (PointNN.py:188-232)."""

    def __init__(self, f: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(f, f, dtype=dtype)
        self.fc2 = Linear(f, f, dtype=dtype)
        self.fc_delta = _mlp2(3, f, dtype)
        self.fc_gamma = _mlp2(f, f, dtype)
        self.w_qs = Linear(f, f, bias=False, dtype=dtype)
        self.w_ks = Linear(f, f, bias=False, dtype=dtype)
        self.w_vs = Linear(f, f, bias=False, dtype=dtype)

    def forward(self, xyz, feat, knn_idx):
        f = feat.shape[-1]
        knn_xyz = index_points(xyz, knn_idx)                  # [B, M, k, 3]
        x = self.fc1(feat)
        q = self.w_qs(x)
        k = index_points(self.w_ks(x), knn_idx)
        v = index_points(self.w_vs(x), knn_idx)
        pos = self.fc_delta((xyz[:, :, None, :] - knn_xyz).to(feat.dtype))
        attn = self.fc_gamma(q[:, :, None, :] - k + pos)
        attn = torch.softmax(attn / math.sqrt(f), dim=-2)
        res = (attn * (v + pos)).sum(dim=-2)                  # [B, M, F]
        return self.fc2(res) + feat


class PointEmbeddings(nn.Module):
    def __init__(self, cfg: Config, dtype=None):
        super().__init__()
        f, fused = cfg.embed_dim, cfg.fused_geo
        self.raw_point_mlp = MiniPointNet(3, f, dtype, fused)
        self.group_transformer_0 = GroupPointTransformer(f, dtype)
        self.point_mlp_0 = MiniPointNet(2 * f, f, dtype, fused)
        self.group_transformer_1 = GroupPointTransformer(f, dtype)
        self.point_mlp_1 = MiniPointNet(2 * f, f, dtype, fused)
        self.group_transformer_node = GroupPointTransformer(f, dtype)
        self.knn_transformers = nn.ModuleList(
            KnnPointTransformer(f, dtype) for _ in range(3))
        self.group_transformer_proxy = GroupPointTransformer(f, dtype)
        if cfg.use_gnn_embedding:
            self.mini_gnn = MiniGNN(3, 64, f)
            self.pos_embed_0 = DenseBN(3, 128, dtype)
            self.pos_embed_1 = Linear(128, f, dtype=dtype)


class PointTransformer(nn.Module):
    """Hierarchical point encoder: points -group-> nodes -knn-> nodes
    -group-> proxies (the first ``num_proxy`` FPS-ordered nodes) -> SA.

    Returns ``(proxy_feat [B,P,F], node2proxy [B,M] int32, pt_feat [B,N,F],
    node_feat [B,M,F])``. ``pc_knn [B,N,k]`` (the dataset's host knn of the
    points) is read with ``use_gnn_embedding`` and required there.
    """

    def __init__(self, cfg: Config):
        super().__init__()
        dt = cfg.torch_dtype()
        self.cfg = cfg
        self.dtype = dt
        self.embeddings = PointEmbeddings(cfg, dt)
        self.sa_encoder_layers = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_head, cfg.mlp_dim, dt,
                     cfg.attention_dropout, cfg.mlp_dropout)
            for _ in range(cfg.num_sa_layer))

    def forward(self, pc, node, pt2node, pc_knn=None):
        cfg, e = self.cfg, self.embeddings
        pc_c = pc.to(self.dtype)
        if cfg.use_gnn_embedding:
            if pc_knn is None:
                raise ValueError("use_gnn_embedding needs the dataset's "
                                 "pc_knn key")
            feat = e.mini_gnn(pc_c, pc_knn)
            pos = e.pos_embed_1(e.pos_embed_0(pc_c))
            x_feat = (feat + pos).to(self.dtype)
        else:
            x_feat = e.raw_point_mlp(pc_c)
        node_feat = e.raw_point_mlp(node.to(self.dtype))

        node_feat = e.group_transformer_0(pc, x_feat, node, node_feat, pt2node)
        back = index_points(node_feat, pt2node)
        x_feat = e.point_mlp_0(torch.cat([x_feat, back], dim=-1))
        node_feat = e.group_transformer_1(pc, x_feat, node, node_feat, pt2node)
        back = index_points(node_feat, pt2node)
        x_feat = e.point_mlp_1(torch.cat([x_feat, back], dim=-1))
        node_feat = e.group_transformer_node(pc, x_feat, node, node_feat,
                                             pt2node)

        # the 3 knn layers share one neighbourhood (coordinates are fixed)
        knn_idx = knn_indices(node, node, cfg.knn_k)
        for layer in e.knn_transformers:
            node_feat = layer(node, node_feat, knn_idx)

        proxy = node[:, :cfg.num_proxy]
        proxy_feat = node_feat[:, :cfg.num_proxy]
        d = torch.linalg.norm(node[:, :, None, :] - proxy[:, None, :, :],
                              dim=-1)
        node2proxy = torch.argmin(d, dim=-1).to(torch.int32)
        proxy_feat = e.group_transformer_proxy(node, node_feat, proxy,
                                               proxy_feat, node2proxy)
        for blk in self.sa_encoder_layers:
            proxy_feat = blk(proxy_feat)
        return proxy_feat, node2proxy, x_feat, node_feat
