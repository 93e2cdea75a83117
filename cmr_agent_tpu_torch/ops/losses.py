"""Loss functions of the training path (PyTorch twin of the JAX package's
``ops/losses.py:19-89``), channels-last:

* softmax cross-entropy over integer labels (the agent's imitation term);
* focal loss with kornia's quirks (reference models/focal_loss.py:55-112):
  ``p = softmax + eps`` and a one-hot target carrying ``+1e-6``;
* circle loss on sampled pixel<->point pairs with detached hinge weights
  (reference models/MultiHeadModel.py:141-178).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE; ``logits [..., C]``, integer ``labels [...]``."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float,
               gamma: float = 2.0, reduction: str = "mean",
               eps: float = 1e-8) -> torch.Tensor:
    """Multiclass focal loss ``-alpha (1 - p)^gamma log(p)`` with kornia's
    ``p = softmax + eps`` and ``one_hot + 1e-6`` target."""
    p = torch.softmax(logits, dim=-1) + eps
    # one_hot by comparison: F.one_hot may read the labels back to the
    # host, which a CUDA graph capture cannot do
    classes = torch.arange(logits.shape[-1], device=labels.device)
    onehot = (labels.long()[..., None] == classes).to(logits.dtype) + 1e-6
    focal = -alpha * torch.pow(1.0 - p, gamma) * torch.log(p)
    loss = (onehot * focal).sum(dim=-1)
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction!r}")


def circle_loss(img_features: torch.Tensor, pc_features: torch.Tensor,
                distance_map: torch.Tensor, dist_thres: float = 1.0,
                pos_margin: float = 0.1, neg_margin: float = 1.4,
                log_scale: float = 10.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional circle loss; ``img_features [B,M,F]``,
    ``pc_features [B,N,F]`` (N == M), ``distance_map [B,N,M]`` pixel
    distances. Positives are pairs within ``dist_thres`` px; the hinge
    weights are detached. Returns ``(loss, feature distances [B,N,M])``."""
    pos_mask = (distance_map <= dist_thres).to(img_features.dtype)
    neg_mask = 1.0 - pos_mask
    diff = pc_features[..., :, None, :] - img_features[..., None, :, :]
    dists = torch.sqrt((diff * diff).sum(dim=-1).clamp_min(0.0))

    pos = dists - 1e5 * neg_mask
    pos_weight = (pos - pos_margin).clamp_min(0.0).detach()
    pos_term = log_scale * (pos - pos_margin) * pos_weight
    neg = dists + 1e5 * pos_mask
    neg_weight = (neg_margin - neg).clamp_min(0.0).detach()
    neg_term = log_scale * (neg_margin - neg) * neg_weight

    loss_col = F.softplus(torch.logsumexp(pos_term, dim=-1)
                          + torch.logsumexp(neg_term, dim=-1)) / log_scale
    loss_row = F.softplus(torch.logsumexp(pos_term, dim=-2)
                          + torch.logsumexp(neg_term, dim=-2)) / log_scale
    return (loss_col + loss_row).mean(), dists
