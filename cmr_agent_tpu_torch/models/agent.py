"""CMRAgent: the actor-critic refinement policy (PyTorch twin of the JAX
package's ``models/agent.py:190-321``, channels-last layout; reference
models/CMRAgent.py:17-144), with the action sampling and the log-prob and
entropy of the PPO update.

``state_2d`` is NHWC ``[B, H, W, 2F]``, ``state_3d`` is ``[B, N, 5]``, or
``[B, N, 7]`` with ``cfg.obs_bearing_channels``.
``train()`` mode normalises with batch statistics (see :mod:`.layers`), as
the JAX agent's ``train=True`` does in the update; rollouts run it in
``eval()`` mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..config import Config
from .layers import BatchNorm, Conv2d, GlobalMean, Linear, ResDenseBlock


def _state_2d_embed(c: int, dtype) -> nn.Sequential:
    """The reference's ``state_2d_embed`` Sequential, index for index
    (conv at 0, 3, 6, ...; BN at 1, 7, 13, 19; 1x1 convs at 24, 26)."""
    lrelu = lambda: nn.LeakyReLU(0.01)  # torch's default slope
    layers = []
    for _ in range(3):
        layers += [Conv2d(c, c, 3, 1, 1, dtype), BatchNorm(c, dim=1), lrelu(),
                   Conv2d(c, c, 3, 1, 1, dtype), lrelu(), nn.AvgPool2d(2)]
    layers += [Conv2d(c, c, 3, 1, 1, dtype), BatchNorm(c, dim=1), lrelu(),
               Conv2d(c, c, 3, 1, 1, dtype), lrelu(), GlobalMean(),
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
        if cfg.policy_aux_state and not cfg.obs_bearing_channels:
            raise ValueError("policy_aux_state requires the bearing "
                             "observation channels (obs_bearing_channels)")
        # policy_aux_state: the two bearing channels join the heads' input
        s = 4 * f + (2 if cfg.policy_aux_state else 0)
        self.policy_r = _mlp_head(s, 4 * f, cfg.degree_r * cfg.num_steps, dt)
        self.policy_t = _mlp_head(s, 4 * f, cfg.degree_t * cfg.num_steps, dt)
        self.value = _mlp_head(s, f, 1, dt)

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
        if cfg.policy_aux_state:
            # the bearing channels are constant per sample, so any point's
            # row carries the statistic; it skips the max-pool stack
            if s3.shape[-1] != 7:
                raise ValueError("policy_aux_state needs state_3d [B,N,7]; "
                                 f"got {s3.shape[-1]} channels")
            state = torch.cat([state, s3[:, 0, 5:]], dim=-1)
        b = state.shape[0]
        r_logits = self.policy_r(state).float().reshape(
            b, cfg.degree_r, cfg.num_steps)
        t_logits = self.policy_t(state).float().reshape(
            b, cfg.degree_t, cfg.num_steps)
        value = self.value(state).float()[:, :, None]              # [B,1,1]
        return r_logits, t_logits, value


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits [..., S]`` from ``softmax(logits)``
    by the Gumbel-max trick (as ``jax.random.categorical`` draws), with
    uniforms from ``generator`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def action_from_logits(r_logits: torch.Tensor, t_logits: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True):
    """Discrete actions (CMRAgent.py:117-127): the argmax, or with
    ``deterministic=False`` one categorical draw each from ``generator``
    (rotation first, then translation)."""
    if deterministic:
        return r_logits.argmax(dim=-1), t_logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("sampling actions needs a generator")
    return (sample_categorical(r_logits, generator),
            sample_categorical(t_logits, generator))


def action_logprob_and_entropy(r_logits, t_logits, action_r, action_t):
    """Log-prob of the chosen actions and the entropy of each categorical
    (agent.py:307-321; CMRAgent.py:129-144) -> ``(logprob [B, dr+dt],
    entropy [B, dr+dt])``."""

    def lp_ent(logits, action):
        logp = torch.log_softmax(logits, dim=-1)
        picked = torch.gather(logp, -1, action.long()[..., None])[..., 0]
        return picked, -(logp.exp() * logp).sum(dim=-1)

    lp_r, ent_r = lp_ent(r_logits, action_r)
    lp_t, ent_t = lp_ent(t_logits, action_t)
    return torch.cat([lp_r, lp_t], dim=-1), torch.cat([ent_r, ent_t], dim=-1)
