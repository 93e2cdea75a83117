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

The capturable form (:meth:`Optimizer.make_capturable`, Adam on CUDA
parameters only) is for a step captured into a CUDA graph
(:func:`.train_geo.make_geo_multi_step`): the learning rate lives in a
device tensor that the host sets before each replay
(:meth:`Optimizer.set_lr`), every parameter keeps an allocated gradient that
``zero_grad`` zeroes in place, and Adam runs its ``capturable`` form (the
same chain; its bias corrections are computed on the card, so its last bits
may differ from the eager form's).
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
    dense gradient trees do) and advances ``count``. Inside a CUDA graph
    capture (capturable form only) it leaves the learning rate to the
    host: :meth:`set_lr` before each replay.
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
        self.lr_tensor = None           # the capturable form's learning rate

    @property
    def capturable(self) -> bool:
        return self.lr_tensor is not None

    def make_capturable(self) -> None:
        """Switch to the capturable form, in place (idempotent): a device
        learning rate, Adam's ``capturable`` path with its step counts on
        the card, and a zero gradient allocated for every parameter."""
        if self.capturable:
            return
        if not isinstance(self.inner, torch.optim.Adam):
            raise NotImplementedError("the capturable form is Adam's only")
        dev = self.params[0].device
        if dev.type != "cuda":
            raise ValueError(f"the capturable form needs CUDA parameters, "
                             f"not {dev}")
        self.lr_tensor = torch.zeros((), dtype=torch.float32, device=dev)
        self._adopt_capturable()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def _adopt_capturable(self) -> None:
        """Point every param group at the device learning rate and move
        Adam's step counts onto the card (also after a state load, which
        replaces the groups)."""
        for group in self.inner.param_groups:
            group["capturable"] = True
            group["lr"] = self.lr_tensor
        for p in self.params:
            st = self.inner.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)

    def load_state_dict(self, state: dict) -> None:
        """``torch.optim`` state of either form into this one's form."""
        self.inner.load_state_dict(state)
        if self.capturable:
            self._adopt_capturable()
            return
        for group in self.inner.param_groups:
            if group.get("capturable"):
                group["capturable"] = False
            group["lr"] = float(group["lr"])
        for p in self.params:
            st = self.inner.state.get(p)
            if st and "step" in st and st["step"].device.type != "cpu":
                st["step"] = st["step"].cpu()

    def set_lr(self) -> None:
        """The schedule's learning rate at ``count`` into the groups (or,
        capturable, into the device tensor a captured step reads)."""
        lr = self.schedule(self.count)
        if self.capturable:
            self.lr_tensor.fill_(lr)
        else:
            for group in self.inner.param_groups:
                group["lr"] = lr

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=not self.capturable)

    def step(self) -> None:
        if not self.capturable:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        if not (self.capturable and torch.cuda.is_current_stream_capturing()):
            self.set_lr()
        self.inner.step()
        self.count += 1
