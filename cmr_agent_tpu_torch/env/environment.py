"""Registration environment (PyTorch twin of the JAX package's
``env/environment.py``; reference environment/environment.py):
``init_poses``, the episode's compaction (ranked top-K, or the mask-pack
kernel), the observation in the nc layout with either raster (the
projection-fused "mega" raster of eval episodes, or the pixel-id "flat"
raster of training episodes), ``apply_action``, the training episode's
``expert_action`` and ``step_reward``, and what the coarse-to-fine
composition needs: ``bearing_init_pose``, ``apply_coarse_pose``,
``compose_disentangled`` and the ground-truth-free verification statistics
``alignment_stats`` / ``nn_alignment_stats``."""

from __future__ import annotations

from typing import Optional

import math

import torch

from ..ops import kernels
from ..ops.geometry import (euler_angles_to_matrix_xyz, frustum_mask,
                            make_se3, matrix_to_euler_xyz_extrinsic,
                            project_points, se3_inverse,
                            transform_points_disentangled)
from ..ops.scatter import scatter_mean_image


def init_poses(batch):
    """Identity source pose + ground-truth target (environment.py:129-140)."""
    b = batch["pc"].shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=batch["pc"].device)
    return eye.expand(b, 4, 4).clone(), batch["P"].float()


def bearing_init_pose(state):
    """Coarse yaw initialisation from the predicted-overlap bearing
    (environment.py:40-71): the disentangled ``[B, 4, 4]`` pure yaw (about
    the cloud centroid, no translation) that turns the predicted-overlap
    sector's centroid onto the camera's +z axis in the x-z plane. With an
    empty overlap prediction the bearing is atan2(0, 0) = 0 and the pose
    is the identity."""
    pc = state["pc"].float()
    w = state["pc_overlap_pred"].float()[..., None]
    mean = pc.mean(dim=1, keepdim=True)
    c = ((pc - mean) * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    theta = torch.atan2(c[:, 0], c[:, 2])
    cos, sin = torch.cos(-theta), torch.sin(-theta)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    # R_y(-theta) maps (sin t, y, cos t) r onto (0, y, r)
    return torch.stack([
        torch.stack([cos, zeros, sin, zeros], dim=-1),
        torch.stack([zeros, ones, zeros, zeros], dim=-1),
        torch.stack([-sin, zeros, cos, zeros], dim=-1),
        torch.stack([zeros, zeros, zeros, ones], dim=-1)], dim=-2)


def apply_coarse_pose(batch, coarse):
    """Re-base the registration problem under a coarse pose estimate
    (environment.py:74-106): a new batch whose cloud and nodes are moved
    by ``coarse [B, 4, 4]`` (entangled) and whose target, when the batch
    has one, becomes the residual ``P @ coarse^-1``. Every other key
    passes through."""
    R, t = coarse[..., :3, :3].float(), coarse[..., :3, 3].float()

    def xform(x):
        return torch.einsum("bij,bnj->bni", R, x.float()) + t[:, None, :]

    out = dict(batch)
    out["pc"] = xform(batch["pc"])
    if "node" in batch:
        out["node"] = xform(batch["node"])
    if "P" in batch:
        out["P"] = batch["P"].float() @ se3_inverse(coarse.float())
    return out


def _project_under(state, final_pose, image_h: int, image_w: int):
    """``(proj [B,N,3], in-frame mask [B,N])`` of the cloud moved by the
    disentangled ``final_pose``."""
    aligned = transform_points_disentangled(
        state["pc"].float(), final_pose[..., :3, :3].float(),
        final_pose[..., :3, 3].float())
    proj = project_points(aligned, state["K"].float())
    return proj, frustum_mask(proj, image_w, image_h)


def alignment_stats(state, final_pose, image_h: int, image_w: int):
    """Per-sample ``[B]`` feature-alignment statistics of a pose estimate
    (environment.py:134-183): the cosine between each in-frame point's
    metric descriptor and the image descriptor at its projected pixel.
    ``sum_norm`` (sum / N), ``mean_valid`` (sum / #valid), ``smooth_mean``
    (sum / (#valid + 0.1 N)), ``frac_valid``, ``above50_norm`` and
    ``above70_norm`` (#(valid and sim > tau) / N). ``state`` holds ``pc``,
    ``K``, ``pc_geo_feat`` and ``img_geo_feat``; ``final_pose`` is
    disentangled."""
    proj, valid = _project_under(state, final_pose, image_h, image_w)
    xi = torch.round(proj[..., 0]).long().clamp(0, image_w - 1)
    yi = torch.round(proj[..., 1]).long().clamp(0, image_h - 1)
    b, n = valid.shape
    f = state["pc_geo_feat"].shape[-1]
    img = state["img_geo_feat"].float().reshape(b, image_h * image_w, f)
    img_f = torch.gather(img, 1, (yi * image_w + xi)[..., None].expand(
        b, n, f))
    sim = (state["pc_geo_feat"].float() * img_f).sum(dim=-1)
    sim_sum = torch.where(valid, sim, torch.zeros_like(sim)).sum(dim=1)
    n_valid = valid.sum(dim=1).float()
    return {
        "sum_norm": sim_sum / n,
        "mean_valid": sim_sum / n_valid.clamp_min(1.0),
        "smooth_mean": sim_sum / (n_valid + 0.1 * n),
        "frac_valid": n_valid / n,
        "above50_norm": (valid & (sim > 0.5)).sum(dim=1) / n,
        "above70_norm": (valid & (sim > 0.7)).sum(dim=1) / n,
    }


def alignment_score(state, final_pose, image_h: int, image_w: int):
    """``alignment_stats(...)["sum_norm"]``."""
    return alignment_stats(state, final_pose, image_h, image_w)["sum_norm"]


def compose_disentangled(final_pose, coarse, pc_orig):
    """The single entangled cloud-frame transform equal to "apply
    ``coarse``, then ``final_pose`` disentangled about the rebased cloud's
    centroid" (environment.py:186-209). ``pc_orig [B,N,3]`` is the cloud
    before the rebase; its rebased centroid is ``R_c mean + t_c``."""
    R_c, t_c = coarse[..., :3, :3].float(), coarse[..., :3, 3].float()
    c = torch.einsum("bij,bj->bi", R_c, pc_orig.float().mean(dim=1)) + t_c
    R_f, t_f = final_pose[..., :3, :3].float(), final_pose[..., :3, 3].float()
    t_ent = t_f + c - torch.einsum("bij,bj->bi", R_f, c)
    return make_se3(R_f, t_ent) @ coarse.float()


def nn_alignment_stats(state, final_pose, image_h: int, image_w: int,
                       radius_px: float = 3.0, chunk: int = 2048):
    """Spatial-consistency statistics ``[B]`` (environment.py:212-273):
    a point is an inlier when it lands in the frame and its feature-nearest
    pixel over the whole image lies within ``radius_px`` of where the pose
    projects it. The nearest-pixel search ignores the pose. One ``[chunk,
    H W]`` cosine product per chunk of points. ``ir_norm`` (inliers / N),
    ``ir_mean`` (inliers / #in-frame), ``ir_smooth`` (inliers / (#in-frame
    + 0.1 N))."""
    proj, valid = _project_under(state, final_pose, image_h, image_w)
    b, n = valid.shape
    f = state["pc_geo_feat"].shape[-1]
    img = state["img_geo_feat"].float().reshape(b, image_h * image_w, f)
    imgT = img.transpose(1, 2)
    feats = state["pc_geo_feat"].float()
    nn_idx = torch.cat([(feats[:, s:s + chunk] @ imgT).argmax(dim=-1)
                        for s in range(0, n, chunk)], dim=1)     # [B, N]
    nn_x = (nn_idx % image_w).float()
    nn_y = (nn_idx // image_w).float()
    d2 = (nn_x - proj[..., 0]) ** 2 + (nn_y - proj[..., 1]) ** 2
    n_inl = (valid & (d2 <= radius_px * radius_px)).sum(dim=1).float()
    n_valid = valid.sum(dim=1).float()
    return {
        "ir_norm": n_inl / n,
        "ir_mean": n_inl / n_valid.clamp_min(1.0),
        "ir_smooth": n_inl / (n_valid + 0.1 * n),
    }


def compact_observation_state(state, k: int, mode: str = "topk"):
    """Compact the rasterisation inputs to ``k`` rows once per episode.

    Only predicted-overlap points reach the 2-D observation and that mask is
    fixed for the episode. Valid rows always come first (the raster's
    ``counts`` prefix relies on it); which rows are kept beyond ``k``
    depends on ``mode``:

    * ``"topk"``: rows ranked by ``pc_is_in_cam_scores`` when the state has
      it (else by the overlap flag itself, i.e. index order) with a -inf
      filler for non-overlap points; the lowest-score overlap points are
      dropped. The stable descending sort breaks ties to the lower index,
      as ``lax.top_k`` does.
    * ``"pack"``: :func:`..ops.kernels.mask_compact_pack`, no sort and no
      gathers: overlap rows in index order, the highest indices dropped,
      rows past the count zero. Eval episodes only (no gradient).

    Adds ``raster_pc [B,k,3]``, ``raster_pcT [B,3,k]`` f32, ``raster_feat
    [B,k,F]``, ``raster_valid [B,k]`` and ``raster_dropped [B]``.
    """
    overlap = state["pc_overlap_pred"]
    out = dict(state)
    n_overlap = overlap.sum(dim=1).to(torch.int32)
    out["raster_dropped"] = (n_overlap - k).clamp_min(0)
    if mode == "pack":
        pcT = state["pc"].transpose(1, 2).float().contiguous()
        feat_k, pcT_k = kernels.mask_compact_pack(
            overlap, pcT, state["pc_geo_feat"].contiguous(), k)
        out["raster_feat"], out["raster_pcT"] = feat_k, pcT_k
        out["raster_pc"] = pcT_k.transpose(1, 2).to(state["pc"].dtype)
        row = torch.arange(k, device=overlap.device)[None, :]
        out["raster_valid"] = row < n_overlap.clamp_max(k)[:, None]
        return out
    if mode != "topk":
        raise ValueError(f"unknown compaction mode {mode!r}")
    scores = state.get("pc_is_in_cam_scores", overlap).float()
    ranked = torch.where(overlap, scores, torch.full_like(scores, -torch.inf))
    sel = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :k]

    def take(x):
        return torch.gather(x, 1, sel[..., None].expand(-1, -1, x.shape[-1]))

    out["raster_pc"] = take(state["pc"])
    out["raster_pcT"] = out["raster_pc"].transpose(1, 2).float().contiguous()
    out["raster_feat"] = take(state["pc_geo_feat"]).contiguous()
    out["raster_valid"] = torch.gather(overlap, 1, sel)
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


def flat_raster(feats, R, t, image_h: int, image_w: int, raster_dtype,
                mean: torch.Tensor) -> torch.Tensor:
    """Pixel-id raster of the compacted rows (the training episodes'
    path, environment.py:450-467): move them about the full-cloud
    centroid ``mean [B,3]``, project, round to a pixel, and route rows
    outside the frame or past the valid prefix out through
    :func:`..ops.scatter.scatter_mean_image`. Returns ``[B, h, w, F]``."""
    mean = mean[:, None, :]
    moved = (torch.einsum("bij,bnj->bni", R, feats["raster_pc"] - mean)
             + mean + t[:, None, :])
    proj = project_points(moved, feats["K"])
    valid = frustum_mask(proj, w=image_w, h=image_h) & feats["raster_valid"]
    xi = torch.round(proj[..., 0]).to(torch.int32)
    yi = torch.round(proj[..., 1]).to(torch.int32)
    return scatter_mean_image(feats["raster_feat"], yi * image_w + xi, valid,
                              image_h, image_w, compute_dtype=raster_dtype)


def observation_from_pose(feats, pose, image_h: int, image_w: int,
                          raster_dtype: Optional[torch.dtype] = None,
                          raster_mode: str = "mega",
                          pose_aware: bool = False,
                          bearing_channels: bool = False):
    """2-D and 3-D observations under the current pose estimate (nc layout;
    environment.py:443-469, 481-505).

    ``feats`` must be compacted (:func:`compact_observation_state`).
    ``raster_mode`` "mega" (the projection-fused kernel, eval episodes) or
    "flat" (projection in PyTorch, then the pixel-id kernel; training
    episodes, whose JAX raster has a VJP). ``pose_aware`` feeds the 3-D
    observation the cloud moved by the current estimate instead of the
    static cloud; ``bearing_channels`` appends the unit (x, z) bearing of
    the predicted-overlap sector's centroid under the current estimate as
    two constant per-point channels. Returns ``(observation_2d
    [B,H,W,2F], observation_3d [B,N,5 (+2)])``.
    """
    pc = feats["pc"]
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    # disentangled transforms rotate about the FULL cloud centroid
    mean_full = pc.mean(dim=1)
    if raster_mode == "mega":
        raster = mega_raster
    elif raster_mode == "flat":
        raster = flat_raster
    else:
        raise ValueError(f"unknown raster_mode {raster_mode!r}")
    proj_feat = raster(feats, R, t, image_h, image_w, raster_dtype, mean_full)
    moved = transform_points_disentangled(pc, R, t)
    in_cam = frustum_mask(project_points(moved, feats["K"]), w=image_w,
                          h=image_h)
    observation_2d = torch.cat([feats["img_geo_feat"], proj_feat], dim=-1)
    overlap = feats["pc_overlap_pred"]
    channels = [moved if pose_aware else pc, overlap[..., None].to(pc.dtype),
                in_cam[..., None].to(pc.dtype)]
    if bearing_channels:
        w = overlap.to(pc.dtype)[..., None]
        cxz = ((moved[..., (0, 2)] * w).sum(dim=1)
               / w.sum(dim=1).clamp_min(1.0))                      # [B, 2]
        unit = cxz / (torch.linalg.norm(cxz, dim=-1, keepdim=True) + 1e-6)
        channels.append(unit[:, None, :].expand(-1, pc.shape[1], -1)
                        .to(pc.dtype))
    observation_3d = torch.cat(channels, dim=-1)
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


def expert_action(pose_source, pose_target, r_steps, t_steps):
    """Discrete 4-DoF expert action toward the target
    (environment.py:608-650; reference environment.py:143-176).

    The rotation delta is taken as extrinsic-xyz euler angles; where the
    roll exceeds 3 rad (the R(pi) ambiguity) roll and pitch are zeroed and
    the yaw reflected about +-pi, the reference's disambiguation. Each
    component then takes the nearest step (first on a tie). Returns
    ``(action_r [B,1] yaw, action_t [B,2] x/z)`` int64 indices.
    """
    delta_t = pose_target[:, :3, 3] - pose_source[:, :3, 3]
    delta_R = pose_target[:, :3, :3] @ pose_source[:, :3, :3].transpose(1, 2)
    delta_r = matrix_to_euler_xyz_extrinsic(delta_R)
    flip = delta_r[:, 0] > 3.0
    ry = delta_r[:, 1]
    ry_flipped = torch.where(ry > 0, math.pi - ry,
                             torch.where(ry < 0, -math.pi - ry, ry))
    zero = torch.zeros_like(ry)
    delta_r = torch.stack([torch.where(flip, zero, delta_r[:, 0]),
                           torch.where(flip, ry_flipped, ry),
                           torch.where(flip, zero, delta_r[:, 2])], dim=-1)
    action_r = (delta_r[..., None] - r_steps).abs().argmin(dim=-1)
    action_t = (delta_t[..., None] - t_steps).abs().argmin(dim=-1)
    return action_r[:, 1:2], action_t[:, 0::2]


def step_reward(pose, state, prev_distance=None, apply_pose: bool = True):
    """Dense +-0.5 reward on the improvement of the masked mean squared
    point distance to ``pc_in_cam_space`` (environment.py:672-701).

    ``apply_pose=True`` moves the cloud by ``pose`` (disentangled) first;
    ``False`` keeps the reference's committed behaviour, whose distance
    never changes. Returns ``(reward [B,1,1], distance [B,1,1])``; the
    reward is 0 without ``prev_distance``.
    """
    pc_target = state["pc_in_cam_space"]
    mask = state["pc_mask"].to(pc_target.dtype)
    pc = state["pc"]
    if apply_pose:
        diff = pc_target - transform_points_disentangled(
            pc, pose[:, :3, :3], pose[:, :3, 3])
    else:
        diff = pc_target - (pc - pc.mean(dim=1, keepdim=True))
    d = ((diff * diff).sum(dim=-1) * mask).sum(dim=1) \
        / mask.sum(dim=1).clamp_min(1.0)
    d = d[:, None, None]
    if prev_distance is None:
        return torch.zeros_like(d), d
    better = (d < prev_distance).to(d.dtype) * 0.5
    worse = (d > prev_distance).to(d.dtype) * 0.5
    return better - worse, d
