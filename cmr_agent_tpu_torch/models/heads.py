"""Prediction heads, eval outputs (PyTorch twin of the JAX package's
``models/heads.py``; reference MultiHeadModel.py:24-272). Losses come
with the training slice."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops.sampling import index_points
from .layers import Conv2d, Linear, ResDenseBlock, ResidualBlock2D


class _Head(nn.Module):
    """Shared topology of both heads: node->point fusion + residual
    pointwise stack + point MLP; residual conv blocks + 1x1 conv image MLP.
    Attribute names follow the reference (``pc_<kind>_head`` etc.)."""

    def __init__(self, cfg: Config, kind: str, hidden: int, out_dim: int):
        super().__init__()
        dt = cfg.torch_dtype()
        f = cfg.embed_dim
        self.kind = kind
        self.point_fuse_convs = nn.ModuleList(
            ResDenseBlock(2 * f if i == 0 else f, f, dt)
            for i in range(cfg.pt_head_res_num))
        self.img_res_convs = nn.ModuleList(
            ResidualBlock2D(f, f, 1, dt) for _ in range(cfg.img_fuse_res_num))
        self.add_module(f"pc_{kind}_head", nn.Sequential(
            Linear(f, hidden, dtype=dt), nn.LeakyReLU(0.2),
            Linear(hidden, out_dim, dtype=dt)))
        self.add_module(f"img_{kind}_head", nn.Sequential(
            Conv2d(f, hidden, 1, dtype=dt), nn.LeakyReLU(0.2),
            Conv2d(hidden, out_dim, 1, dtype=dt)))

    def forward(self, feats):
        node_at_pt = index_points(feats["fused_node_feat"], feats["pt2node"])
        x = torch.cat([feats["pt_feat"], node_at_pt], dim=-1)
        for blk in self.point_fuse_convs:
            x = blk(x)
        pc_out = getattr(self, f"pc_{self.kind}_head")(x).float()
        img = feats["fused_img_feat"].permute(0, 3, 1, 2)
        for blk in self.img_res_convs:
            img = blk(img)
        img_out = getattr(self, f"img_{self.kind}_head")(img).float()
        return pc_out, img_out.permute(0, 2, 3, 1)          # NHWC


class OverlapDetectionHead(_Head):
    """Per-point and per-pixel 2-class overlap logits."""

    def __init__(self, cfg: Config):
        super().__init__(cfg, "overlap", 32, 2)

    def forward(self, feats):
        pc_logits, img_logits = super().forward(feats)
        return {"pc_overlap_logits": pc_logits,
                "img_overlap_logits": img_logits}


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class GeometricDistanceHead(_Head):
    """L2-normalised metric features for points and pixels."""

    def __init__(self, cfg: Config):
        super().__init__(cfg, "geo", cfg.embed_dim, cfg.embed_dim)

    def forward(self, feats):
        pc_geo, img_geo = super().forward(feats)
        return {"pc_geo_feat": _l2_normalise(pc_geo),
                "img_geo_feat": _l2_normalise(img_geo)}
