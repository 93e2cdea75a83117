"""Trajectory buffer, discounted returns and GAE (PyTorch twin of the JAX
package's ``env/buffer.py:25-100``; reference environment/buffer.py).

A rollout arrives as a dict of ``[K, B, ...]`` tensors (one
:func:`..env.episode.run_episode` trajectory); the buffer holds
``num_trajectory`` of them and ``samples()`` flattens trajectories x
steps x batch into training rows with per-trajectory returns and GAE
advantages. Every key flattens in the same (step, batch) order, the JAX
package's deliberate fix of the reference, whose returns and advantages
came out in (batch, step) order against (step, batch) states.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def discounted_returns(vals: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reverse discounted cumulative sum over the leading (step) axis."""
    out = torch.empty_like(vals)
    g = torch.zeros_like(vals[0])
    for k in range(vals.shape[0] - 1, -1, -1):
        g = vals[k] + gamma * g
        out[k] = g
    return out


def gae_advantage(rewards: torch.Tensor, values: torch.Tensor, gamma: float,
                  gae_lambda: float) -> torch.Tensor:
    """Generalized advantage estimation over the leading step axis, the
    terminal value bootstrapped with 0; ``gae_lambda == 0`` gives
    ``returns - values``."""
    if gae_lambda == 0:
        return discounted_returns(rewards, gamma) - values
    v_next = torch.cat([values[1:], torch.zeros_like(values[:1])], dim=0)
    deltas = rewards + gamma * v_next - values
    return discounted_returns(deltas, gamma * gae_lambda)


class TrajectoryBuffer:
    """Collects ``num_trajectory`` rollouts, then yields flat samples."""

    KEYS = ("state_2d", "state_3d", "value", "expert_action_r",
            "expert_action_t", "action_r", "action_t", "action_logprob")

    def __init__(self, gamma: float, gae_lambda: float):
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self._trajectories: List[Dict[str, torch.Tensor]] = []

    def __len__(self) -> int:
        return len(self._trajectories)

    def add(self, rollout: Dict[str, torch.Tensor]) -> None:
        self._trajectories.append(rollout)

    def clear(self) -> None:
        self._trajectories.clear()

    def samples(self) -> Dict[str, torch.Tensor]:
        """``[T*K*B, ...]`` rows of every key, plus ``returns`` and
        ``advantage``."""
        if not self._trajectories:
            raise ValueError("empty buffer")
        out: Dict[str, List[torch.Tensor]] = {
            k: [] for k in self.KEYS + ("returns", "advantage")}
        for traj in self._trajectories:
            rewards, values = traj["reward"], traj["value"]
            derived = {
                "returns": discounted_returns(rewards, self.gamma),
                "advantage": gae_advantage(rewards, values, self.gamma,
                                           self.gae_lambda)}
            for k in out:
                x = derived[k] if k in derived else traj[k]
                out[k].append(x.reshape((-1,) + x.shape[2:]))
        return {k: torch.cat(v, dim=0) for k, v in out.items()}
