"""LoFTR-style linear attention (PyTorch twin of the JAX package's
``models/linear_attention.py``; reference LinearAttention.py:8-73).

Sequence parallelism: under a mesh whose ``sp`` axis spans several ranks
(:func:`..parallel.mesh.use_mesh`, JAX's ambient ``set_mesh``), each rank
of the sp group takes its shard of the query and key tokens, reduces its
key shard's ``KV`` / ``K``-sum, all-reduces them over ``sp``
(:func:`..parallel.sp.sp_linear_attention_message`), finishes its query
shard, and the shards are gathered back; the value guard divides by the
global key count. That route is the sharded eval forward's: in ``train()``
mode or with gradients on it raises, as no entry point trains under ``sp``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh as _mesh
from .layers import Dropout, LayerNorm, Linear


class LinearAttention(nn.Module):
    """``x [B, L, C]`` attends to ``y [B, S, C]`` in O(L + S); dropout
    (0.1) on the message and inside and after the MLP (JAX
    ``linear_attention.py:68,74,77``)."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-6,
                 dtype=None, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.q_proj = Linear(d, d, bias=False, dtype=dtype)
        self.k_proj = Linear(d, d, bias=False, dtype=dtype)
        self.v_proj = Linear(d, d, bias=False, dtype=dtype)
        self.merge = Linear(d, d, bias=False, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.mlp = nn.Sequential(Linear(2 * d, 2 * d, bias=False, dtype=dtype),
                                 nn.ReLU(), self.dropout,
                                 Linear(2 * d, d, bias=False, dtype=dtype))
        self.norm1 = LayerNorm(d, 1e-5, dtype)
        self.norm2 = LayerNorm(d, 1e-5, dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sp = _mesh.axis_group("sp")
        if sp is not None:
            return self._forward_sp(x, y, *sp)
        b, l, d = x.shape
        s = y.shape[1]
        h = self.num_heads
        q = F.elu(self.q_proj(x).reshape(b, l, h, d // h)) + 1.0
        k = F.elu(self.k_proj(y).reshape(b, s, h, d // h)) + 1.0
        v = self.v_proj(y).reshape(b, s, h, d // h) / s  # overflow guard
        kv = torch.einsum("bshd,bshv->bhdv", k, v)
        z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + self.eps)
        msg = torch.einsum("blhd,bhdv,blh->blhv", q, kv, z) * s
        return self._finish(x, msg.reshape(b, l, d))

    def _finish(self, x: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        msg = self.dropout(self.norm1(self.merge(msg)))
        out = self.norm2(self.dropout(self.mlp(torch.cat([x, msg], dim=-1))))
        return x + out

    def _forward_sp(self, x, y, group, rank: int, size: int):
        from ..parallel.sp import sp_linear_attention_message
        if self.training or (torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters())):
            raise NotImplementedError(
                "the sp route of LinearAttention is the sharded eval "
                "forward's; run it in eval() mode under torch.no_grad()")
        b, l, d = x.shape
        s = y.shape[1]
        if l % size or s % size:
            raise ValueError(f"{l} query and {s} key tokens do not split "
                             f"over sp={size}")
        h, ls, ss = self.num_heads, l // size, s // size
        x_l = x.narrow(1, rank * ls, ls)
        y_l = y.narrow(1, rank * ss, ss)
        q = F.elu(self.q_proj(x_l).reshape(b, ls, h, d // h)) + 1.0
        k = F.elu(self.k_proj(y_l).reshape(b, ss, h, d // h)) + 1.0
        v = self.v_proj(y_l).reshape(b, ss, h, d // h) / s   # global S
        msg = sp_linear_attention_message(q, k, v, group, self.eps) * s
        out = self._finish(x_l, msg.reshape(b, ls, d))
        return _mesh.gather_rows(out, group, rank, size, dim=1)
