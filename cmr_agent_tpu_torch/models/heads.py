"""Prediction heads with their training losses (PyTorch twin of the JAX
package's ``models/heads.py:20-152``; reference MultiHeadModel.py:24-272):
focal losses on the overlap logits (alpha 0.75 per point, 0.5 per pixel)
with precision/recall/accuracy, and the circle loss on the sampled
pixel<->point pairs. Losses are computed when ``labels`` (the batch) are
given."""

from __future__ import annotations

import torch
import torch.distributed
import torch.nn as nn

from ..config import Config
from ..ops.losses import circle_loss, focal_loss
from ..ops.sampling import index_points
from ..parallel import mesh as _mesh
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
            ResDenseBlock(2 * f if i == 0 else f, f, dt, cfg.fused_geo)
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
    """Per-point and per-pixel 2-class overlap logits (+ focal losses and
    P/R/A metrics against ``pc_mask [B,N]`` and ``img_mask [B,H,W]``)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg, "overlap", 32, 2)

    def forward(self, feats, labels=None):
        pc_logits, img_logits = super().forward(feats)
        out = {"pc_overlap_logits": pc_logits,
               "img_overlap_logits": img_logits}
        if labels is not None:
            b = img_logits.shape[0]
            pc_label = labels["pc_mask"]
            img_label = labels["img_mask"].reshape(b, -1)
            img_flat = img_logits.reshape(b, -1, 2)
            out["pc_overlap_loss"] = focal_loss(pc_logits, pc_label, 0.75)
            out["img_overlap_loss"] = focal_loss(img_flat, img_label, 0.5)
            out.update(pr_metrics("pc_overlap", pc_logits.argmax(-1),
                                  pc_label))
            out.update(pr_metrics("img_overlap", img_flat.argmax(-1),
                                  img_label))
        return out


def pr_metrics(prefix: str, pred: torch.Tensor, label: torch.Tensor):
    """Precision, recall and accuracy of binary predictions (JAX
    ``heads.py:_pr_metrics``); under a mesh whose ``dp`` spans several
    ranks, of the global batch (the counts all-reduced over ``dp``)."""
    pred_f, label_f = pred.float(), label.float()
    tp = (pred_f * label_f).sum()
    dp = _mesh.axis_group("dp")
    if dp is not None:
        counts = torch.stack([tp, pred_f.sum(), label_f.sum(),
                              (pred == label).float().sum(),
                              tp.new_tensor(float(pred.numel()))])
        torch.distributed.all_reduce(counts, group=dp[0])
        tp, n_pred, n_label, n_right, n = counts.unbind(0)
        return {f"{prefix}_precision": tp / n_pred.clamp_min(1.0),
                f"{prefix}_recall": tp / n_label.clamp_min(1.0),
                f"{prefix}_accuracy": n_right / n}
    return {
        f"{prefix}_precision": tp / pred_f.sum().clamp_min(1.0),
        f"{prefix}_recall": tp / label_f.sum().clamp_min(1.0),
        f"{prefix}_accuracy": (pred == label).float().mean(),
    }


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class GeometricDistanceHead(_Head):
    """L2-normalised metric features for points and pixels (+ the circle
    loss on the ``circle_loss_num`` sampled pairs)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg, "geo", cfg.embed_dim, cfg.embed_dim)
        self.image_w = cfg.image_w

    def forward(self, feats, labels=None):
        pc_geo, img_geo = super().forward(feats)
        out = {"pc_geo_feat": _l2_normalise(pc_geo),
               "img_geo_feat": _l2_normalise(img_geo)}
        if labels is not None:
            xy_int = labels["pc_xy_int_for_circle_loss"]      # [B, 2, S]
            b, f = img_geo.shape[0], img_geo.shape[-1]
            pix_ids = xy_int[:, 1] * self.image_w + xy_int[:, 0]
            pixel_feat = index_points(out["img_geo_feat"].reshape(b, -1, f),
                                      pix_ids)
            point_feat = index_points(out["pc_geo_feat"],
                                      labels["pc_idx_for_circle_loss"])
            xy_float = labels["pc_xy_float_for_circle_loss"]   # [B, 2, S]
            delta = xy_float[..., :, None] - xy_int[..., None, :].to(
                xy_float.dtype)
            dmap = torch.sqrt((delta * delta).sum(dim=1))      # [B, S, S]
            out["geometric_loss"], _ = circle_loss(pixel_feat, point_feat,
                                                   dmap)
        return out
