"""CMRAgent: the actor-critic refinement policy (PyTorch twin of the JAX
package's ``models/agent.py:190-321``, channels-last layout; reference
models/CMRAgent.py:17-144), with the action sampling and the log-prob and
entropy of the PPO update.

``state_2d`` is NHWC ``[B, H, W, 2F]``, ``state_3d`` is ``[B, N, 5]``, or
``[B, N, 7]`` with ``cfg.obs_bearing_channels``; with ``cfg.fused_agent``
the eval episode hands it channel-major ``[B, 5 (+2), N]`` instead, told
apart by the channel count as in the JAX agent (``agent.py:211-216``).
``train()`` mode normalises with batch statistics (see :mod:`.layers`), as
the JAX agent's ``train=True`` does in the update; rollouts run it in
``eval()`` mode, where with ``cfg.fused_agent`` the 3-D branch runs as
four fused dense chains (JAX ``_ResDenseSplitBlock`` and
``_ResDenseConcatBlock``, ``agent.py:61-187``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..config import Config
from ..ops import kernels
from ..parallel.mesh import rand_shard
from .layers import (BatchNorm, Conv2d, GlobalMean, Linear, ResDenseBlock,
                     fold_dense_bn)


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


def _fused_virtual_concat_block(blk: ResDenseBlock, feat: torch.Tensor,
                                pooled: torch.Tensor, cn: bool
                                ) -> torch.Tensor:
    """``blk`` (eval mode, folded) on the virtual ``concat(feat,
    broadcast(pooled))`` as one fused dense chain, never materialising the
    concat: the pooled half of each input kernel folds into a per-sample
    bias ``pooled32 @ W[f_in:] + b``, and an identity shortcut adds the
    pooled half in the kernel (residual "identity_split"). ``feat`` is
    ``[B,N,f]`` or, with ``cn``, ``[B,f,N]``; ``pooled [B,f]``."""
    f_in = feat.shape[1 if cn else -1]
    pooled32 = pooled.float()
    w0, b0 = fold_dense_bn(blk.net[0], blk.net[1])
    w1, b1 = fold_dense_bn(blk.net[3], blk.net[4])
    bias0 = pooled32 @ w0[f_in:] + b0
    if blk.shortcut is None:
        return kernels.dense_chain(feat, (w0[:f_in], w1), (bias0, b1),
                                   pooled=pooled32, slopes=(0.2, None),
                                   residual="identity_split",
                                   final_slope=0.2, cn=cn)
    w2, b2 = fold_dense_bn(blk.shortcut[0], blk.shortcut[1])
    return kernels.dense_chain(feat, (w0[:f_in], w1), (bias0, b1), w2[:f_in],
                               pooled32 @ w2[f_in:] + b2, slopes=(0.2, None),
                               residual="proj", final_slope=0.2, cn=cn)


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
            ResDenseBlock(cfg.obs3d_channels, f, dt, cfg.fused_agent),
            ResDenseBlock(2 * f, f, dt, cfg.fused_agent),
            ResDenseBlock(2 * f, f, dt, cfg.fused_agent),
            ResDenseBlock(2 * f, 2 * f, dt, cfg.fused_agent),
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
        first = self.state_3d_embed[0]
        cn = s3.shape[-1] not in (5, 7)                            # [B, C, N]
        if cn and not first.fusing:
            s3, cn = s3.transpose(1, 2), False
        pool_dim = 2 if cn else 1
        feat = first(s3.contiguous(), cn=cn)
        for blk in self.state_3d_embed[1:]:
            pooled = feat.amax(dim=pool_dim)                       # [B, F]
            if blk.fusing:
                feat = _fused_virtual_concat_block(blk, feat, pooled, cn)
            else:
                feat = blk(torch.cat([feat, pooled[:, None, :].expand_as(
                    feat)], dim=-1))
        embed_3d = feat.amax(dim=pool_dim)                         # [B, 2F]
        x = self.state_2d_embed(state_2d.to(self.dtype).permute(0, 3, 1, 2))
        embed_2d = x.flatten(1)                                    # [B, 2F]
        state = torch.cat([embed_2d, embed_3d], dim=-1)
        if cfg.policy_aux_state:
            # the bearing channels are constant per sample, so any point's
            # row carries the statistic; it skips the max-pool stack
            n_ch = s3.shape[1] if cn else s3.shape[-1]
            if n_ch != 7:
                raise ValueError("policy_aux_state needs 7 observation "
                                 f"channels; got {n_ch}")
            aux = s3[:, 5:, 0] if cn else s3[:, 0, 5:]
            state = torch.cat([state, aux], dim=-1)
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
    uniforms from ``generator`` (on the logits' device). Under a dp mesh
    the logits are this rank's rows and the uniforms are drawn at the
    global batch's shape (:func:`..parallel.mesh.rand_shard`), so the
    ranks sample what one process samples."""
    u = rand_shard(logits.shape, generator, logits.device)
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
