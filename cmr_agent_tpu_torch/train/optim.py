"""Optimizer and learning-rate schedules with the JAX package's semantics
(``train/optim.py:17-57``; reference Train_Geo.py:65-96,173).

The chain, per step: clip every gradient element to
``±cfg.grad_clip_value``; add ``cfg.weight_decay * param`` (coupled L2, as
torch's Adam does, not AdamW); Adam(0.9, 0.99, eps 1e-8 outside the square
root, bias-corrected) or SGD with momentum (``optax.trace``: ``t = g +
momentum t``); scale by the learning rate of the schedule evaluated at the
step count BEFORE the increment (the first step uses ``lr(0)``). The moment
updates are ``torch.optim.Adam`` / ``torch.optim.SGD``, whose arithmetic is
that chain's; the schedule sets their learning rate before each step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from ..config import Config


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """Epoch-granular schedule evaluated per optimizer step: StepLR,
    ExponentialLR, or CosineAnnealingLR (optax's cosine decay over 10
    epochs down to ``1e-4``)."""
    spe = max(steps_per_epoch, 1)
    if cfg.lr_scheduler == "StepLR":
        return lambda step: cfg.lr * cfg.scheduler_gamma ** (
            (step // spe) // cfg.step_size)
    if cfg.lr_scheduler == "ExponentialLR":
        return lambda step: cfg.lr * cfg.scheduler_gamma ** (step // spe)
    if cfg.lr_scheduler == "CosineAnnealingLR":
        decay_steps = 10 * spe
        alpha = 1e-4 / cfg.lr

        def cosine(step):
            frac = min(step, decay_steps) / decay_steps
            return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)
        return cosine
    raise ValueError(f"unknown scheduler {cfg.lr_scheduler!r}")


class Optimizer:
    """``clip -> coupled L2 -> Adam | SGD -> lr schedule`` over ``params``.

    ``step()`` applies one update from the parameters' ``.grad`` (a
    parameter without one takes a zero gradient, as the JAX package's
    dense gradient trees do) and advances ``count``.
    """

    def __init__(self, cfg: Config, params: Iterable[torch.nn.Parameter],
                 steps_per_epoch: int = 1000):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.clip_value = cfg.grad_clip_value
        if cfg.optimizer == "ADAM":
            self.inner = torch.optim.Adam(
                self.params, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-8,
                weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "SGD":
            self.inner = torch.optim.SGD(
                self.params, lr=cfg.lr, momentum=cfg.momentum,
                weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.count = 0

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
