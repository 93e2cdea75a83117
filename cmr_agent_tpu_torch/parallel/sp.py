"""Sequence-parallel linear attention (counterpart of the JAX package's
``parallel/sp.py``).

The linear attention's ``KV = sum_s K_s^T V_s`` and ``K``-sum are plain
reductions over the key tokens, so with the queries and the keys/values
each split over the ranks of an ``sp`` group, every rank reduces its own
key shard, all-reduces the ``O(H*D*D)`` partials (constant in the
sequence length) and finishes its own query shard.
"""

from __future__ import annotations

import torch


def linear_attention_message(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, eps: float = 1e-6
                             ) -> torch.Tensor:
    """Unsharded message: ``q [B, L, H, D]``, ``k``/``v [B, S, H, D]``
    (feature-mapped; reference models/LinearAttention.py:53-60 without the
    value scaling by S, which cancels)."""
    kv = torch.einsum("bshd,bshv->bhdv", k, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv,blh->blhv", q, kv, z)


def sp_linear_attention_message(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, group=None,
                                eps: float = 1e-6) -> torch.Tensor:
    """This rank's query shard of the message: ``q`` is this rank's shard
    of the queries, ``k`` / ``v`` its shard of the keys and values. The
    partial ``KV`` and ``K``-sum are all-reduced over ``group``
    (differentiably); the result is the rows of the unsharded message
    that ``q`` holds."""
    from torch.distributed.nn.functional import all_reduce
    kv = all_reduce(torch.einsum("bshd,bshv->bhdv", k, v), group=group)
    ksum = all_reduce(k.sum(dim=1), group=group)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, ksum) + eps)
    return torch.einsum("blhd,bhdv,blh->blhv", q, kv, z)
