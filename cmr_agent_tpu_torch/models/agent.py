"""CMRAgent: the actor-critic refinement policy, eval forward (PyTorch twin
of the JAX package's ``models/agent.py:190-300``, channels-last layout;
reference models/CMRAgent.py:17-144).

``state_2d`` is NHWC ``[B, H, W, 2F]``, ``state_3d`` is ``[B, N, 5]``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..config import Config
from .layers import BatchNorm, Conv2d, Linear, ResDenseBlock


class _GlobalMean(nn.Module):
    """Mean over H, W keeping dims (the reference's AvgPool(H/8, W/8))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


def _state_2d_embed(c: int, dtype) -> nn.Sequential:
    """The reference's ``state_2d_embed`` Sequential, index for index
    (conv at 0, 3, 6, ...; BN at 1, 7, 13, 19; 1x1 convs at 24, 26)."""
    lrelu = lambda: nn.LeakyReLU(0.01)  # torch's default slope
    layers = []
    for _ in range(3):
        layers += [Conv2d(c, c, 3, 1, 1, dtype), BatchNorm(c, dim=1), lrelu(),
                   Conv2d(c, c, 3, 1, 1, dtype), lrelu(), nn.AvgPool2d(2)]
    layers += [Conv2d(c, c, 3, 1, 1, dtype), BatchNorm(c, dim=1), lrelu(),
               Conv2d(c, c, 3, 1, 1, dtype), lrelu(), _GlobalMean(),
               Conv2d(c, c, 1, dtype=dtype), lrelu(),
               Conv2d(c, c, 1, dtype=dtype)]
    return nn.Sequential(*layers)


def _mlp_head(cin: int, hidden: int, out: int, dtype) -> nn.Sequential:
    return nn.Sequential(Linear(cin, hidden, dtype=dtype), nn.LeakyReLU(0.01),
                         Linear(hidden, hidden, dtype=dtype),
                         nn.LeakyReLU(0.01), Linear(hidden, out, dtype=dtype))


class CMRAgent(nn.Module):
    """Policy/value network: 4-stage pointwise-residual PointNet with
    global-max re-broadcast (3-D branch) + conv/avg-pool CNN (2-D branch),
    concatenated into a 4F state read by three MLP heads."""

    def __init__(self, cfg: Config):
        super().__init__()
        dt = cfg.torch_dtype()
        f = cfg.embed_dim
        self.cfg = cfg
        self.dtype = dt
        self.state_3d_embed = nn.ModuleList([
            ResDenseBlock(cfg.obs3d_channels, f, dt),
            ResDenseBlock(2 * f, f, dt),
            ResDenseBlock(2 * f, f, dt),
            ResDenseBlock(2 * f, 2 * f, dt),
        ])
        self.state_2d_embed = _state_2d_embed(2 * f, dt)
        self.policy_r = _mlp_head(4 * f, 4 * f, cfg.degree_r * cfg.num_steps, dt)
        self.policy_t = _mlp_head(4 * f, 4 * f, cfg.degree_t * cfg.num_steps, dt)
        self.value = _mlp_head(4 * f, f, 1, dt)

    def forward(self, state_2d: torch.Tensor, state_3d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        s3 = state_3d.to(self.dtype)
        feat = self.state_3d_embed[0](s3)
        for blk in self.state_3d_embed[1:]:
            pooled = feat.amax(dim=1, keepdim=True).expand_as(feat)
            feat = blk(torch.cat([feat, pooled], dim=-1))
        embed_3d = feat.amax(dim=1)                                # [B, 2F]
        x = self.state_2d_embed(state_2d.to(self.dtype).permute(0, 3, 1, 2))
        embed_2d = x.flatten(1)                                    # [B, 2F]
        state = torch.cat([embed_2d, embed_3d], dim=-1)
        b = state.shape[0]
        r_logits = self.policy_r(state).float().reshape(
            b, cfg.degree_r, cfg.num_steps)
        t_logits = self.policy_t(state).float().reshape(
            b, cfg.degree_t, cfg.num_steps)
        value = self.value(state).float()[:, :, None]              # [B,1,1]
        return r_logits, t_logits, value


def action_from_logits(r_logits: torch.Tensor, t_logits: torch.Tensor):
    """Deterministic (argmax) discrete actions (CMRAgent.py:117-127)."""
    return r_logits.argmax(dim=-1), t_logits.argmax(dim=-1)
