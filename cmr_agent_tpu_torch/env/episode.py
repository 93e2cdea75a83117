"""The registration episode (PyTorch twin of the JAX package's
``env/episode.py:run_episode``): the deterministic eval episode, and the
stochastic training rollout with expert labels, rewards and the
trajectory for BC/PPO. The ``lax.scan`` becomes a Python loop."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..models.agent import action_from_logits, action_logprob_and_entropy
from .environment import (apply_action, compact_observation_state,
                          expert_action, observation_from_pose, step_reward)


def raster_dtype_for(cfg: Config, training: bool = False
                     ) -> Optional[torch.dtype]:
    """The raster's operand type: f32 in f32 episodes; in bf16 episodes
    int8 with ``raster_int8`` on eval episodes, bf16 otherwise, so a
    training episode never rasters in int8 (episode.py:151-155)."""
    if cfg.compute_dtype != "bfloat16":
        return None
    return torch.int8 if cfg.raster_int8 and not training else torch.bfloat16


def run_episode(agent, state: dict, pose_init: torch.Tensor, cfg: Config,
                raster_topk: Optional[int] = None, *,
                pose_target: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                with_expert: bool = False,
                collect_trajectory: bool = False,
                reward_apply_pose: bool = True,
                expert_beta: Optional[float] = None,
                ) -> Tuple[torch.Tensor,
                           List[Tuple[torch.Tensor, torch.Tensor]],
                           Optional[Dict[str, torch.Tensor]]]:
    """Run the ``cfg.action_num``-step registration episode.

    ``state`` holds ``pc, K, pc_overlap_pred, pc_geo_feat, img_geo_feat``
    (and optionally ``pc_is_in_cam_scores``, the compaction's ranking),
    plus ``pc_in_cam_space`` and ``pc_mask`` when the trajectory (with its
    rewards) is collected. The observation set is compacted once to
    ``raster_topk`` rows (``None``: all ``num_pt`` rows, which rasters the
    same pixels as the JAX package's uncompacted path).

    Eval episodes (the defaults) raster with the projection-fused kernel,
    after the ranked top-K compaction (``cfg.raster_mode`` "megatopk") or
    the mask-pack kernel's ("pack", "mega"). Training episodes
    (``collect_trajectory``) keep the JAX package's rules for them: the
    ranked top-K, the flat pixel-id raster, in bf16 or f32 but never
    int8. ``cfg.pose_aware_observation`` and ``cfg.obs_bearing_channels``
    shape the 3-D observation of both. ``deterministic=False`` samples actions from ``generator``;
    ``with_expert`` labels each step with :func:`expert_action` toward
    ``pose_target``; ``expert_beta`` (DAgger scheduled sampling, needs
    ``with_expert``) takes the expert's action instead with that
    probability per sample and step, drawn from ``generator`` after the
    step's actions. The trajectory records the action actually taken.

    Returns ``(final_pose [B,4,4], [(r_logits, t_logits)] per step,
    trajectory or None)``; the trajectory's tensors are stacked over the
    step axis: ``state_2d [K,B,H,W,2F]``, ``state_3d [K,B,N,5 (+2)]``,
    ``value`` and ``reward [K,B,1,1]``, ``expert_action_r/t`` (with the
    expert), ``action_r [K,B,1]``, ``action_t [K,B,2]``,
    ``action_logprob`` and ``entropy [K,B,3]``.
    """
    device = pose_init.device
    r_steps = torch.as_tensor(cfg.r_steps_array(), device=device)
    t_steps = torch.as_tensor(cfg.t_steps_array(), device=device)
    if expert_beta is not None and not with_expert:
        raise ValueError("expert_beta needs with_expert=True")
    k = raster_topk if raster_topk is not None else state["pc"].shape[1]
    packed = cfg.raster_mode in ("pack", "mega") and not collect_trajectory
    state = compact_observation_state(state, k,
                                      mode="pack" if packed else "topk")
    raster_dtype = raster_dtype_for(cfg, training=collect_trajectory)
    raster_mode = "flat" if collect_trajectory else "mega"
    pose = pose_init
    if collect_trajectory:
        _, dist = step_reward(pose, state, apply_pose=reward_apply_pose)
    steps, records = [], []
    for _ in range(cfg.action_num):
        if with_expert:
            exp_r, exp_t = expert_action(pose, pose_target, r_steps, t_steps)
        obs2d, obs3d = observation_from_pose(state, pose, cfg.image_h,
                                             cfg.image_w, raster_dtype,
                                             raster_mode,
                                             cfg.pose_aware_observation,
                                             cfg.obs_bearing_channels)
        r_logits, t_logits, value = agent(obs2d, obs3d)
        action_r, action_t = action_from_logits(
            r_logits, t_logits, generator, deterministic)
        if expert_beta is not None:
            mix = torch.rand((action_r.shape[0], 1), generator=generator,
                             device=device) < expert_beta
            action_r = torch.where(mix, exp_r, action_r)
            action_t = torch.where(mix, exp_t, action_t)
        pose = apply_action(action_r, action_t, pose, r_steps, t_steps)
        steps.append((r_logits, t_logits))
        if collect_trajectory:
            reward, dist = step_reward(pose, state, dist,
                                       apply_pose=reward_apply_pose)
            logprob, entropy = action_logprob_and_entropy(
                r_logits, t_logits, action_r, action_t)
            rec = {"state_2d": obs2d, "state_3d": obs3d, "value": value,
                   "reward": reward, "action_r": action_r,
                   "action_t": action_t, "action_logprob": logprob,
                   "entropy": entropy}
            if with_expert:
                rec["expert_action_r"], rec["expert_action_t"] = exp_r, exp_t
            records.append(rec)
    trajectory = None
    if collect_trajectory:
        trajectory = {key: torch.stack([r[key] for r in records])
                      for key in records[0]}
    return pose, steps, trajectory
