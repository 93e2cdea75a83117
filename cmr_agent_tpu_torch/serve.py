"""Serving entry point: the PyTorch counterpart of ``bench.py``'s
``build_workload`` — KITTI-shaped synthetic batch, random weights from a
seed, geo forward + deterministic refinement episode.

Runs on the card unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises instead of falling back to the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from .config import Config
from .data import SyntheticDataset, collate
from .env.environment import init_poses
from .env.episode import run_episode
from .models.agent import CMRAgent
from .models.multi_head import MultiHeadModel
from .ops.geometry import to_disentangled

BATCH_KEYS = ("img", "pc", "node", "pt2node", "K", "P")
# what the train steps read besides: the geo heads' labels and the agent's
# reward target
TRAIN_KEYS = BATCH_KEYS + ("pc_mask", "img_mask", "pc_idx_for_circle_loss",
                           "pc_xy_float_for_circle_loss",
                           "pc_xy_int_for_circle_loss", "pc_in_cam_space")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: every Linear/Conv2d weight
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the JAX package's torch-style
    init), biases 0; norms keep their identity init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                u = torch.rand(m.weight.shape, generator=generator)
                m.weight.copy_((2.0 * u - 1.0) * bound)
                if m.bias is not None:
                    m.bias.zero_()


def serve_episode(model: MultiHeadModel, agent: CMRAgent, cfg: Config,
                  batch: Dict[str, torch.Tensor]) -> dict:
    """Geo forward -> ``init_poses`` -> ``to_disentangled`` -> episode.

    Returns ``{"final_pose": [B,4,4], "pose_target": [B,4,4] (disentangled
    ground truth, what an evaluation compares against), "steps": per-step
    (r_logits, t_logits)}``.
    """
    with torch.inference_mode():
        out = model(batch)
        # the keys bench.py's workload hands the episode (no scores: the
        # compaction ranks by the overlap flag, i.e. keeps index order)
        state = {
            "pc": out["pc"],
            "K": batch["K"],
            "pc_overlap_pred": out["pc_overlap_pred"],
            "pc_geo_feat": out["pc_geo_feat"],
            "img_geo_feat": out["img_geo_feat"],
        }
        pose_src, pose_tgt = init_poses(batch)
        final, steps, _ = run_episode(agent, state, pose_src, cfg,
                                      raster_topk=cfg.episode_raster_topk())
        return {"final_pose": final, "steps": steps,
                "pose_target": to_disentangled(pose_tgt, state["pc"])}


def synthetic_batch(cfg: Config, batch_size: int, device="cuda",
                    seed: int = 0, keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """``keys`` of a batch of the synthetic dataset (seeded with ``seed``)
    as tensors on ``device``."""
    dev = resolve_device(device)
    ds = SyntheticDataset(cfg, length=batch_size, seed=seed)
    batch_np = collate([ds[i] for i in range(batch_size)])
    return {k: torch.from_numpy(batch_np[k]).to(dev) for k in keys}


def build_workload(cfg: Config, batch_size: int, device="cuda", seed: int = 0
                   ) -> Tuple[Dict[str, torch.Tensor], MultiHeadModel, CMRAgent,
                              Callable[[Dict[str, torch.Tensor]], torch.Tensor]]:
    """The serving workload: ``(batch, model, agent, episode)``.

    ``batch`` holds the tensors the path reads, made by the synthetic
    dataset from ``seed``; ``model`` and ``agent`` carry random weights from
    a ``torch.Generator`` seeded with ``seed`` and are in eval mode;
    ``episode(batch)`` returns the final poses ``[B, 4, 4]``.
    """
    dev = resolve_device(device)
    batch = synthetic_batch(cfg, batch_size, dev, seed)
    gen = torch.Generator().manual_seed(seed)
    model, agent = MultiHeadModel(cfg), CMRAgent(cfg)
    init_random_(model, gen)
    init_random_(agent, gen)
    model.to(dev).eval()
    agent.to(dev).eval()

    def episode(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        return serve_episode(model, agent, cfg, b)["final_pose"]

    return batch, model, agent, episode
