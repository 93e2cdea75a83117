"""IterModel: the pose-hypothesis cost volume scored by convolutions
(PyTorch twin of the JAX package's ``models/cost_volume.py``; reference
models/IterModel.py:24-475).

An ``nlabel^3`` grid of (yaw, x, z) pose hypotheses; the cloud's metric
features are warped into the image under every hypothesis, stacked as
``[image features | warped point features | occupancy | image overlap]``
and scored by a 2-D tower with the hypotheses folded into the batch (every
Conv3d of the reference has a (1, 3, 3) kernel, so it never mixes
hypotheses); the decode takes the per-axis marginal argmax and composes the
accumulated pose.

The port follows the JAX package's accelerator path: the masked cloud is
compacted once to its ``warp_topk`` highest-scoring points, and each eval
chunk of hypotheses warps that shared set through
:func:`..ops.kernels.segment_sum_shared` (the CUDA kernel on the card, its
plain version on the CPU). ``warp_dropped_points`` reports how many masked
points the compaction left out (0: the warp is exact).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..config import Config
from ..ops import kernels
from ..ops.geometry import (angle2matrix_sxyz, make_se3, se3_inverse,
                            transform_points)
from ..ops.losses import softmax_cross_entropy
from .layers import BatchNorm, Conv2d, GlobalMean


def sample_pose_grid(r_amplitude: torch.Tensor, t_amplitude: torch.Tensor,
                     nlabel: int):
    """Pose hypothesis grid (reference IterModel.py:132-172) ->
    ``(delta_rt_inv [B, nlabel^3, 4, 4], delta_r [B, nlabel], delta_t
    [B, nlabel])``; the flat hypothesis order is (yaw, x, z) row-major."""
    if nlabel % 2 != 1:
        raise ValueError("hypothesis grid must be odd (centred on 0)")
    n = nlabel
    half = (n - 1) // 2
    base = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=r_amplitude.device)
    delta_r = (2.0 * r_amplitude[:, None] / (n - 1)) * base       # [B, n]
    delta_t = (2.0 * t_amplitude[:, None] / (n - 1)) * base
    b = r_amplitude.shape[0]
    zeros = torch.zeros_like(delta_r)
    R = angle2matrix_sxyz(torch.stack([zeros, delta_r, zeros], dim=-1))
    tx = delta_t[:, :, None].expand(b, n, n)
    tz = delta_t[:, None, :].expand(b, n, n)
    T = torch.stack([tx, torch.zeros_like(tx), tz], dim=-1)       # [B,n,n,3]
    R_grid = R[:, :, None, None].expand(b, n, n, n, 3, 3)
    T_grid = T[:, None].expand(b, n, n, n, 3)
    rt = make_se3(R_grid, T_grid).reshape(b, n ** 3, 4, 4)
    return se3_inverse(rt), delta_r, delta_t


def _stable_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def _yaw_pose(ry: torch.Tensor, tx: torch.Tensor, tz: torch.Tensor):
    """``se3_inverse`` of the (yaw, x, z) step, the ``matrix_i``
    convention."""
    zero = torch.zeros_like(ry)
    eul = torch.stack([zero, ry, zero], dim=-1)
    t_vec = torch.stack([tx, zero, tz], dim=-1)
    return se3_inverse(make_se3(angle2matrix_sxyz(eul), t_vec))


def decode_topk_yaw_poses(logits: torch.Tensor, r_amplitude: torch.Tensor,
                          t_amplitude: torch.Tensor, nlabel: int, k: int):
    """The ``k`` most probable distinct yaw bins, each with its conditional
    translation decode (argmax of p(tx|ry) and p(tz|ry)), as candidate
    per-step poses ``[B, k, 4, 4]`` in the ``matrix_i`` convention.

    ``k`` may exceed ``nlabel`` (up to ``2 * nlabel``): candidates beyond
    the distinct yaw bins re-nominate the most probable bins with the best
    joint (tx, tz) cell that differs from their first nomination.
    """
    b, nl = logits.shape[0], nlabel
    if k > 2 * nl:
        raise ValueError(f"k={k} exceeds 2*nlabel={2 * nl} candidates "
                         "(rank-1 + rank-2 translation per yaw bin)")
    _, delta_r, delta_t = sample_pose_grid(r_amplitude, t_amplitude, nl)
    pred = torch.softmax(logits, dim=-1).reshape(b, nl, nl, nl)
    p_ry = pred.sum(dim=(2, 3))                                   # [B, nl]
    k_yaw = min(k, nl)
    ry_idx = _stable_topk(p_ry, k_yaw)                            # [B, k_yaw]
    cond = torch.gather(pred, 1, ry_idx[:, :, None, None].expand(
        b, k_yaw, nl, nl))                                        # [B,k,nl,nl]
    tx_idx = cond.sum(dim=3).argmax(dim=-1)
    tz_idx = cond.sum(dim=2).argmax(dim=-1)
    if k > nl:
        extra = k - nl
        top2 = _stable_topk(cond.reshape(b, k_yaw, nl * nl), 2)
        rank1 = tx_idx * nl + tz_idx
        pick = torch.where(top2[..., 0] == rank1, top2[..., 1], top2[..., 0])
        ry_idx = torch.cat([ry_idx, ry_idx[:, :extra]], dim=1)
        tx_idx = torch.cat([tx_idx, (pick // nl)[:, :extra]], dim=1)
        tz_idx = torch.cat([tz_idx, (pick % nl)[:, :extra]], dim=1)
    return _yaw_pose(torch.gather(delta_r, 1, ry_idx),
                     torch.gather(delta_t, 1, tx_idx),
                     torch.gather(delta_t, 1, tz_idx))


def _tower(f: int, dtype) -> nn.Sequential:
    """The reference's ``cost_volume_convs`` Sequential, index for index
    (conv at 0, 3, 6, ...; BN at 1, 7, 13, 19; 1x1 convs at 24, 26), as
    2-D layers over ``[B * P, C, H, W]``."""
    lrelu = lambda: nn.LeakyReLU(0.01)
    widths = [(f, f), (f // 2, f // 2), (f // 4, f // 4), (f // 4, f // 8)]
    layers, cin = [], 2 * f + 2
    for stage, (w0, w1) in enumerate(widths):
        layers += [Conv2d(cin, w0, 3, 1, 1, dtype), BatchNorm(w0, dim=1),
                   lrelu(), Conv2d(w0, w1, 3, 1, 1, dtype), lrelu(),
                   nn.AvgPool2d(2) if stage < 3 else GlobalMean()]
        cin = w1
    layers += [Conv2d(cin, f // 16, 1, dtype=dtype), lrelu(),
               Conv2d(f // 16, 1, 1, dtype=dtype)]
    return nn.Sequential(*layers)


class IterModel(nn.Module):
    """Scores the hypothesis grid and updates the accumulated pose.

    ``state``: ``pc_i [B,N,3]``, ``K [B,3,3]``, ``pc_geo_feat [B,N,F]``,
    ``img_geo_feat [B,H,W,F]``, ``pc_overlap_pred [B,N]`` (and optionally
    ``pc_overlap_pred_standby``), ``pc_is_in_cam_scores [B,N]``,
    ``img_overlap_pred [B,H,W]``, ``matrix_accumulated [B,4,4]``,
    ``R_amplitude [B]``, ``T_amplitude [B]`` and, for the loss,
    ``label_R / label_T_x / label_T_z [B, nlabel]``. Returns
    ``cost_volume_logits [B, nlabel^3]``, ``warp_dropped_points [B]``,
    the decoded ``pred_ry/tx/tz``, the per-step pose ``matrix_i``, the
    updated ``matrix_accumulated``, the re-transformed ``pc_i`` and, with
    labels, ``cost_volume_label`` and ``cost_volume_loss``.

    ``eval()`` mode scores the grid in chunks of
    ``cfg.cost_volume_eval_chunk`` hypotheses; ``train()`` mode scores it
    in one shot (BatchNorm batch statistics span all hypotheses).
    """

    def __init__(self, cfg: Config, warp_topk: int = 8192):
        super().__init__()
        self.cfg = cfg
        self.warp_topk = warp_topk
        self.dtype = cfg.torch_dtype()
        self.cost_volume_convs = _tower(cfg.embed_dim, self.dtype)

    def _compact(self, state, mask):
        """Top-K of the masked cloud by in-camera score, shared by every
        hypothesis: ``(pc_k [B,K,3], aug [B,K,F+2] = [feat | score | 1],
        mask_k [B,K], dropped [B])``."""
        pc, scores = state["pc_i"], state["pc_is_in_cam_scores"]
        k_pts = min(self.warp_topk, pc.shape[1])
        # -1 sinks unmasked points below every score
        ranked = torch.where(mask, scores, torch.full_like(scores, -1.0))
        sel = _stable_topk(ranked, k_pts)                         # [B, K]

        def take(x):
            return torch.gather(x, 1, sel[..., None].expand(
                -1, -1, x.shape[-1]))

        scores_k = torch.gather(scores, 1, sel)
        aug = torch.cat([take(state["pc_geo_feat"]).float(),
                         scores_k[..., None],
                         torch.ones_like(scores_k)[..., None]], dim=-1)
        n_masked = mask.sum(dim=1).to(torch.int32)
        return (take(pc), aug.contiguous(), torch.gather(mask, 1, sel),
                (n_masked - k_pts).clamp_min(0))

    def _warp(self, poses_c, K, pc_k, aug, mask_k):
        """Pose chunk ``[B,C,4,4]`` -> ``(mean feat [B,C,npix,F], occupancy
        [B,C,npix])``: project the compacted cloud under every hypothesis
        (the projection guard and rounding as the raster kernel does
        them), route points outside the frame out, and sum the shared
        rows per pixel."""
        cfg = self.cfg
        h, w, f = cfg.image_h, cfg.image_w, cfg.embed_dim
        npix = h * w
        R, t = poses_c[..., :3, :3], poses_c[..., :3, 3]
        pc_w = torch.einsum("bpij,bkj->bpki", R, pc_k) + t[:, :, None, :]
        proj = torch.einsum("bij,bpkj->bpki", K, pc_w)
        z = proj[..., 2]
        zs = torch.where(z.abs() < 1e-10, torch.full_like(z, 1e-10), z)
        x, y = proj[..., 0] / zs, proj[..., 1] / zs
        valid = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z > 0)
                 & mask_k[:, None, :])
        pix = torch.round(y).to(torch.int32) * w + torch.round(x).to(
            torch.int32)
        ids = torch.where(valid, pix, torch.full_like(pix, npix))
        sums = kernels.segment_sum_shared(aug, ids.contiguous(), npix)
        counts = sums[..., -1]
        return (sums[..., :f] / counts.clamp_min(1.0)[..., None],
                sums[..., f])

    def _score(self, poses_c, state, compacted):
        """Warp + stack + tower for a pose chunk -> logits ``[B, C]``."""
        cfg = self.cfg
        h, w, f = cfg.image_h, cfg.image_w, cfg.embed_dim
        b, n_p = poses_c.shape[:2]
        warped, occ = self._warp(poses_c, state["K"], *compacted)
        dt = self.dtype
        vol = torch.cat([
            state["img_geo_feat"].to(dt)[:, None].expand(b, n_p, h, w, f),
            warped.reshape(b, n_p, h, w, f).to(dt),
            occ.reshape(b, n_p, h, w, 1).to(dt),
            state["img_overlap_pred"].to(dt)[:, None, :, :, None].expand(
                b, n_p, h, w, 1)], dim=-1)                # [B,C,H,W,2F+2]
        x = vol.reshape(b * n_p, h, w, 2 * f + 2).permute(0, 3, 1, 2)
        return self.cost_volume_convs(x).reshape(b, n_p).float()

    def forward(self, state: Dict[str, torch.Tensor],
                with_loss: bool = True) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        nl = cfg.nlabel
        pc = state["pc_i"]
        b = pc.shape[0]

        # the standby (p > 0.8) mask where the p > 0.5 mask is empty
        # (reference IterModel.py:272-274)
        primary = state["pc_overlap_pred"]
        standby = state.get("pc_overlap_pred_standby", primary)
        mask = torch.where(primary.any(dim=1, keepdim=True), primary, standby)
        if cfg.cost_volume_unmasked:
            mask = torch.ones_like(mask)

        poses, delta_r, delta_t = sample_pose_grid(
            state["R_amplitude"], state["T_amplitude"], nl)
        n_pose = nl ** 3
        *compacted, warp_dropped = self._compact(state, mask)

        ec = cfg.cost_volume_eval_chunk
        if not self.training and ec and ec < n_pose and n_pose % ec == 0:
            logits = torch.cat([
                self._score(poses[:, i:i + ec], state, compacted)
                for i in range(0, n_pose, ec)], dim=1)
        else:
            logits = self._score(poses, state, compacted)

        out = {"cost_volume_logits": logits,
               "warp_dropped_points": warp_dropped}
        if with_loss and "label_R" in state:
            label = (state["label_R"].float()[:, :, None, None]
                     * state["label_T_x"].float()[:, None, :, None]
                     * state["label_T_z"].float()[:, None, None, :]
                     ).reshape(b, -1)
            out["cost_volume_label"] = label
            out["cost_volume_loss"] = softmax_cross_entropy(
                logits, label.argmax(dim=-1))

        # decode: per-axis marginal argmax (IterModel.py:443-456)
        pred = torch.softmax(logits, dim=-1).reshape(b, nl, nl, nl)

        def pick(table, marginal):
            return torch.gather(table, 1,
                                marginal.argmax(dim=-1)[:, None])[:, 0]

        ry = pick(delta_r, pred.sum(dim=(2, 3)))
        tx = pick(delta_t, pred.sum(dim=(1, 3)))
        tz = pick(delta_t, pred.sum(dim=(1, 2)))
        matrix_i = _yaw_pose(ry, tx, tz)
        out["pred_ry"], out["pred_tx"], out["pred_tz"] = ry, tx, tz
        out["matrix_i"] = matrix_i
        out["matrix_accumulated"] = matrix_i @ state["matrix_accumulated"]
        out["pc_i"] = transform_points(pc, matrix_i[:, :3, :3],
                                       matrix_i[:, :3, 3])
        return out
