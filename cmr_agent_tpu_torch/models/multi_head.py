"""MultiHeadModel (PyTorch twin of the JAX package's
``models/multi_head.py:22-71``; reference MultiHeadModel.py:275-353): the
forward, and with ``with_loss=True`` the head losses and their total."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from .fusion import IMGPCEnDecoder
from .heads import GeometricDistanceHead, OverlapDetectionHead


class MultiHeadModel(nn.Module):
    """The one-shot cross-modal geo model.

    ``batch`` holds ``img [B,H,W,3]``, ``pc [B,N,3]``, ``node [B,M,3]`` and
    ``pt2node [B,N]`` int32 (with ``use_gnn_embedding`` also ``pc_knn
    [B,N,k]`` int32; and, for ``with_loss=True``, the labels
    ``pc_mask``, ``img_mask`` and the ``*_for_circle_loss`` samples).
    Returns the feature dict, the overlap and metric head outputs and the
    derived predictions the agent consumes; with ``with_loss`` also the
    head losses, the P/R/A metrics and ``loss`` (their sum). ``train()``
    mode uses batch statistics and dropout (see :mod:`.layers`).
    """

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder_decoder = IMGPCEnDecoder(cfg)
        self.overlap_head = OverlapDetectionHead(cfg)
        self.geo_head = GeometricDistanceHead(cfg)

    def forward(self, batch, with_loss: bool = False):
        labels = batch if with_loss else None
        feats = self.encoder_decoder(batch["img"], batch["pc"], batch["node"],
                                     batch["pt2node"], batch.get("pc_knn"))
        feats["pt2node"] = batch["pt2node"]
        out = dict(feats)
        out["pc"] = batch["pc"]
        out.update(self.overlap_head(feats, labels))
        out.update(self.geo_head(feats, labels))
        if with_loss:
            out["loss"] = (out["pc_overlap_loss"] + out["img_overlap_loss"]
                           + out["geometric_loss"])
        pc_prob = torch.softmax(out["pc_overlap_logits"], dim=-1)[..., 1]
        out["pc_overlap_pred"] = pc_prob > 0.5
        out["pc_overlap_pred_standby"] = pc_prob > 0.8
        out["pc_is_in_cam_scores"] = pc_prob
        out["img_overlap_pred"] = torch.softmax(
            out["img_overlap_logits"], dim=-1)[..., 1]
        b = batch["pc"].shape[0]
        out["matrix_accumulated"] = torch.eye(
            4, device=batch["pc"].device).expand(b, 4, 4)
        return out


def matching_inlier_ratio(pc_geo_feat, img_geo_feat, pc_mask, point_xy_all,
                          image_w: int, image_h: int, px_thresh: float = 3.0,
                          chunk: int = 8192):
    """Feature-NN matching inlier ratio of one sample (the JAX package's
    ``models/multi_head.py:74-92``; reference Test_Geo.py:109-119): the
    share of the masked points whose feature-nearest pixel lies within
    ``px_thresh`` of the point's true projection. ``pc_geo_feat [N, F]``,
    ``img_geo_feat [H, W, F]``, ``pc_mask [N]`` bool, ``point_xy_all [2,
    N]``. Returns a 0-d tensor."""
    _, inlier = matching_centers(pc_geo_feat, img_geo_feat, pc_mask,
                                 point_xy_all, image_w, px_thresh, chunk)
    return (inlier & pc_mask).sum() / pc_mask.sum().clamp_min(1)


def matching_centers(pc_geo_feat, img_geo_feat, pc_mask, point_xy_all,
                     image_w: int, px_thresh: float = 3.0,
                     chunk: int = 8192):
    """Each point's feature-nearest pixel ``(x, y)`` and whether it lies
    within ``px_thresh`` of the true projection (reference
    MultiHeadModel.py:285-315) -> ``(pred_xy [2, N], inlier [N] bool)``.

    The squared distances are ``|a|^2 + |b|^2 - 2 a.b`` in the features'
    dtype, as the JAX package computes them, one ``[chunk, H W]`` block of
    points at a time (a KITTI sample's whole matrix is 0.84 GB in f32); the
    nearest pixel is the first of equal distances, as ``argmin`` takes it.
    """
    f = pc_geo_feat.shape[-1]
    pix = img_geo_feat.reshape(-1, f)
    pix_sq = (pix ** 2).sum(dim=-1)[None, :]
    min_idx = torch.cat([
        ((a ** 2).sum(dim=-1)[:, None] + pix_sq - 2.0 * (a @ pix.T)
         ).argmin(dim=-1)
        for a in pc_geo_feat.split(chunk)])
    px = (min_idx % image_w).float()
    py = (min_idx // image_w).float()
    err = torch.sqrt((px - point_xy_all[0]) ** 2
                     + (py - point_xy_all[1]) ** 2)
    inlier = (err <= px_thresh) & pc_mask
    return torch.stack([px, py]), inlier
