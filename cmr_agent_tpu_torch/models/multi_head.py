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
    ``pt2node [B,N]`` int32 (and, for ``with_loss=True``, the labels
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
                                     batch["pt2node"])
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
