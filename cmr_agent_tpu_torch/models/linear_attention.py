"""LoFTR-style linear attention (PyTorch twin of the JAX package's
``models/linear_attention.py``; reference LinearAttention.py:8-73)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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
        b, l, d = x.shape
        s = y.shape[1]
        h = self.num_heads
        q = F.elu(self.q_proj(x).reshape(b, l, h, d // h)) + 1.0
        k = F.elu(self.k_proj(y).reshape(b, s, h, d // h)) + 1.0
        v = self.v_proj(y).reshape(b, s, h, d // h) / s  # overflow guard
        kv = torch.einsum("bshd,bshv->bhdv", k, v)
        z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + self.eps)
        msg = torch.einsum("blhd,bhdv,blh->blhv", q, kv, z) * s
        msg = self.dropout(self.norm1(self.merge(msg.reshape(b, l, d))))
        out = self.norm2(self.dropout(self.mlp(torch.cat([x, msg], dim=-1))))
        return x + out
