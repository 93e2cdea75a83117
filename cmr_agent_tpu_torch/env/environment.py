"""Registration environment of the serving episode (PyTorch twin of the JAX
package's ``env/environment.py``: ``init_poses``, the ranked top-K
compaction, the projection-fused ("mega") observation raster in the nc
layout, and ``apply_action``; reference environment/environment.py)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import kernels
from ..ops.geometry import (euler_angles_to_matrix_xyz, frustum_mask,
                            project_points, transform_points_disentangled)


def init_poses(batch):
    """Identity source pose + ground-truth target (environment.py:129-140)."""
    b = batch["pc"].shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=batch["pc"].device)
    return eye.expand(b, 4, 4).clone(), batch["P"].float()


def compact_observation_state(state, k: int):
    """Compact the rasterisation inputs to ``k`` rows once per episode.

    Only predicted-overlap points reach the 2-D observation and that mask is
    fixed for the episode. Rows are ranked by ``pc_is_in_cam_scores`` when
    the state has it (else by the overlap flag itself, i.e. index order)
    with a -inf filler for non-overlap points, so valid rows always come first (the
    raster's ``counts`` prefix relies on it); beyond ``k`` the lowest-score
    overlap points are dropped. The stable descending sort breaks ties to
    the lower index, as ``lax.top_k`` does.

    Adds ``raster_pc [B,k,3]``, ``raster_pcT [B,3,k]`` f32, ``raster_feat
    [B,k,F]``, ``raster_valid [B,k]`` and ``raster_dropped [B]``.
    """
    overlap = state["pc_overlap_pred"]
    scores = state.get("pc_is_in_cam_scores", overlap).float()
    ranked = torch.where(overlap, scores, torch.full_like(scores, -torch.inf))
    sel = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :k]

    def take(x):
        return torch.gather(x, 1, sel[..., None].expand(-1, -1, x.shape[-1]))

    out = dict(state)
    out["raster_pc"] = take(state["pc"])
    out["raster_pcT"] = out["raster_pc"].transpose(1, 2).float().contiguous()
    out["raster_feat"] = take(state["pc_geo_feat"]).contiguous()
    out["raster_valid"] = torch.gather(overlap, 1, sel)
    n_overlap = overlap.sum(dim=1).to(torch.int32)
    out["raster_dropped"] = (n_overlap - k).clamp_min(0)
    return out


def mega_raster(feats, R, t, image_h: int, image_w: int, raster_dtype,
                mean: torch.Tensor) -> torch.Tensor:
    """Projection-fused 2-D observation raster.

    Folds the disentangled SE(3) transform and the pinhole projection into a
    12-float affine per sample (``A = K R``, ``b = K (mean + t - R mean)``)
    and hands the compacted valid-first cloud to the raster kernel
    (environment.py:350-381). Returns ``[B, h, w, F]`` means.
    """
    K_ = feats["K"].float()
    Rf, tf = R.float(), t.float()
    A = K_ @ Rf
    bv = torch.einsum("bij,bj->bi", K_,
                      mean + tf - torch.einsum("bij,bj->bi", Rf, mean))
    ab = torch.cat([A.reshape(-1, 9), bv], dim=1).contiguous()
    counts = feats["raster_valid"].sum(dim=1).to(torch.int32)
    means, _ = kernels.segment_mean_count_image_project(
        feats["raster_pcT"], feats["raster_feat"], ab, counts, image_h,
        image_w, compute_dtype=raster_dtype)
    b, f = means.shape[0], means.shape[-1]
    return means.reshape(b, image_h, image_w, f)


def observation_from_pose(feats, pose, image_h: int, image_w: int,
                          raster_dtype: Optional[torch.dtype] = None):
    """2-D and 3-D observations under the current pose estimate (nc layout,
    mega raster branch; environment.py:443-449, 481-505).

    ``feats`` must be compacted (:func:`compact_observation_state`).
    Returns ``(observation_2d [B,H,W,2F], observation_3d [B,N,5])``.
    """
    pc = feats["pc"]
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    # disentangled transforms rotate about the FULL cloud centroid
    mean_full = pc.mean(dim=1)
    proj_feat = mega_raster(feats, R, t, image_h, image_w, raster_dtype,
                            mean_full)
    moved = transform_points_disentangled(pc, R, t)
    in_cam = frustum_mask(project_points(moved, feats["K"]), w=image_w,
                          h=image_h)
    observation_2d = torch.cat([feats["img_geo_feat"], proj_feat], dim=-1)
    observation_3d = torch.cat(
        [pc, feats["pc_overlap_pred"][..., None].to(pc.dtype),
         in_cam[..., None].to(pc.dtype)], dim=-1)
    return observation_2d, observation_3d


def apply_action(action_r, action_t, pose_source, r_steps, t_steps):
    """Left-compose the discrete yaw / (x, z) step onto the pose (4-DoF;
    environment.py:653-669)."""
    zero = torch.zeros_like(r_steps[action_r[:, 0]])
    move_r = torch.stack([zero, r_steps[action_r[:, 0]], zero], dim=-1)
    move_t = torch.stack([t_steps[action_t[:, 0]], zero,
                          t_steps[action_t[:, 1]]], dim=-1)
    pose = pose_source.clone()
    pose[:, :3, :3] = euler_angles_to_matrix_xyz(move_r) @ pose_source[:, :3, :3]
    pose[:, :3, 3] = pose_source[:, :3, 3] + move_t
    return pose
