"""The registration episode (PyTorch twin of the JAX package's
``env/episode.py:run_episode``): the deterministic eval episode, and the
stochastic training rollout with expert labels, rewards and the
trajectory for BC/PPO. The ``lax.scan`` becomes a Python loop."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..models.agent import action_from_logits, action_logprob_and_entropy
from ..parallel.mesh import rand_shard
from .environment import (apply_action, compact_observation_state,
                          expert_action, observation_from_pose, step_reward)

# the raster modes whose eval episodes end in the projection-fused kernel
PROJECTED_MODES = ("megatopk", "pack", "mega")


def raster_dtype_for(cfg: Config, training: bool = False
                     ) -> Optional[torch.dtype]:
    """The raster's operand type: f32 in f32 episodes; in bf16 episodes
    int8 with ``raster_int8`` on eval episodes, bf16 otherwise, so a
    training episode never rasters in int8 (episode.py:151-155)."""
    if cfg.compute_dtype != "bfloat16":
        return None
    return torch.int8 if cfg.raster_int8 and not training else torch.bfloat16


def step_tables(cfg: Config, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotation (radians) and translation step tables, f32, made on
    ``device`` from the config's scalars by fill operations: no copy from
    the host, so a traced episode holds them as device operations, which a
    CUDA graph captures."""
    def table(values):
        return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                       device=device)
                            for v in values])
    return table(cfg.r_steps_array()), table(cfg.t_steps_array())


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
    rewards) is collected. Callers pass ``cfg.episode_raster_topk()``.

    The observation set is compacted once to ``raster_topk`` rows when it
    is given, and under the projection-fused modes ("megatopk", "pack",
    "mega") always (``None``: all ``num_pt`` rows, which rasters the same
    pixels as the JAX package's uncompacted path). Eval episodes then
    raster with the projection-fused kernel, after the ranked top-K
    compaction ("megatopk") or the mask-pack kernel's ("pack", "mega");
    under "topk" with the pixel-id raster of the ranked top-K; under
    "flat" and "compact" (no compaction) with the pixel-id or the
    compacting raster of the whole cloud. Training episodes
    (``collect_trajectory``) keep the JAX package's rules for them: under
    the projection-fused modes the ranked top-K and the pixel-id raster,
    in bf16 or f32 but never int8. With ``cfg.fused_agent`` or
    ``cfg.obs3d_cn`` an eval episode hands the agent channel-major
    observations (built from ``pcT``, made once here).
    ``cfg.pose_aware_observation`` and ``cfg.obs_bearing_channels`` shape
    the 3-D observation of both; with ``cfg.obs3d_source="compact"`` an
    eval episode given a ``raster_topk`` observes the compacted rows only
    (episode.py:172). ``cfg.is_6_dof`` takes 3 + 3 actions a step.

    ``deterministic=False`` samples actions from ``generator``;
    ``with_expert`` labels each step with :func:`expert_action` toward
    ``pose_target``; ``expert_beta`` (DAgger scheduled sampling, needs
    ``with_expert``) takes the expert's action instead with that
    probability per sample and step, drawn from ``generator`` after the
    step's actions. The trajectory records the action actually taken.
    Under a dp mesh (:func:`..parallel.mesh.use_mesh`) ``state`` holds
    this rank's rows and every draw is made at the global batch's shape,
    so the ranks take the actions one process takes.

    Returns ``(final_pose [B,4,4], [(r_logits, t_logits)] per step,
    trajectory or None)``; the trajectory's tensors are stacked over the
    step axis: ``state_2d [K,B,H,W,2F]``, ``state_3d [K,B,N,5 (+2)]``,
    ``value`` and ``reward [K,B,1,1]``, ``expert_action_r/t`` (with the
    expert), ``action_r [K,B,1]``, ``action_t [K,B,2]``,
    ``action_logprob`` and ``entropy [K,B,3]`` (6-DoF: ``[K,B,3]``,
    ``[K,B,3]``, ``[K,B,6]``).
    """
    device = pose_init.device
    r_steps, t_steps = step_tables(cfg, device)
    if expert_beta is not None and not with_expert:
        raise ValueError("expert_beta needs with_expert=True")
    projected = cfg.raster_mode in PROJECTED_MODES
    if raster_topk is not None or projected:
        k = raster_topk if raster_topk is not None else state["pc"].shape[1]
        packed = cfg.raster_mode in ("pack", "mega") and not collect_trajectory
        state = compact_observation_state(state, k,
                                          mode="pack" if packed else "topk")
    raster_dtype = raster_dtype_for(cfg, training=collect_trajectory)
    if projected:
        raster_mode = "flat" if collect_trajectory else "mega"
    else:
        raster_mode = "compact" if cfg.raster_mode == "compact" else "flat"
    obs3d_layout = ("cn" if (cfg.fused_agent or cfg.obs3d_cn)
                    and not collect_trajectory else "nc")
    obs3d_compact = (cfg.obs3d_source == "compact" and not collect_trajectory
                     and raster_topk is not None)
    if obs3d_layout == "cn":
        state = dict(state, pcT=state["pc"].transpose(1, 2).float()
                     .contiguous())
    pose = pose_init
    if collect_trajectory:
        _, dist = step_reward(pose, state, apply_pose=reward_apply_pose)
    steps, records = [], []
    for _ in range(cfg.action_num):
        if with_expert:
            exp_r, exp_t = expert_action(pose, pose_target, r_steps, t_steps,
                                         cfg.is_6_dof)
        obs2d, obs3d = observation_from_pose(state, pose, cfg.image_h,
                                             cfg.image_w, raster_dtype,
                                             raster_mode,
                                             cfg.pose_aware_observation,
                                             cfg.obs_bearing_channels,
                                             obs3d_layout, obs3d_compact)
        r_logits, t_logits, value = agent(obs2d, obs3d)
        action_r, action_t = action_from_logits(
            r_logits, t_logits, generator, deterministic)
        if expert_beta is not None:
            mix = rand_shard((action_r.shape[0], 1), generator,
                             device) < expert_beta
            action_r = torch.where(mix, exp_r, action_r)
            action_t = torch.where(mix, exp_t, action_t)
        pose = apply_action(action_r, action_t, pose, r_steps, t_steps,
                            cfg.is_6_dof)
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
