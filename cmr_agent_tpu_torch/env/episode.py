"""The deterministic eval episode (PyTorch twin of the JAX package's
``env/episode.py:run_episode`` with ``deterministic=True``,
``with_expert=False``, ``collect_trajectory=False``). The ``lax.scan``
becomes a Python loop."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..config import Config
from ..models.agent import action_from_logits
from .environment import (apply_action, compact_observation_state,
                          observation_from_pose)


def raster_dtype_for(cfg: Config) -> Optional[torch.dtype]:
    """The raster's operand type: int8 in bf16 episodes with
    ``raster_int8``, bf16 in other bf16 episodes, f32 otherwise
    (episode.py:151-155)."""
    if cfg.compute_dtype != "bfloat16":
        return None
    return torch.int8 if cfg.raster_int8 else torch.bfloat16


def run_episode(agent, state: dict, pose_init: torch.Tensor, cfg: Config,
                raster_topk: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Run the ``cfg.action_num``-step registration episode.

    ``state`` holds ``pc, K, pc_overlap_pred, pc_geo_feat, img_geo_feat``
    (and optionally ``pc_is_in_cam_scores``, the compaction's ranking). The observation set is compacted once to
    ``raster_topk`` rows (``None``: all ``num_pt`` rows, which rasters the
    same pixels as the JAX package's uncompacted path).

    Returns ``(final_pose [B,4,4], [(r_logits, t_logits)] per step)``.
    """
    device = pose_init.device
    r_steps = torch.as_tensor(cfg.r_steps_array(), device=device)
    t_steps = torch.as_tensor(cfg.t_steps_array(), device=device)
    k = raster_topk if raster_topk is not None else state["pc"].shape[1]
    state = compact_observation_state(state, k)
    raster_dtype = raster_dtype_for(cfg)
    pose = pose_init
    steps = []
    for _ in range(cfg.action_num):
        obs2d, obs3d = observation_from_pose(state, pose, cfg.image_h,
                                             cfg.image_w, raster_dtype)
        r_logits, t_logits, _ = agent(obs2d, obs3d)
        action_r, action_t = action_from_logits(r_logits, t_logits)
        pose = apply_action(action_r, action_t, pose, r_steps, t_steps)
        steps.append((r_logits, t_logits))
    return pose, steps
