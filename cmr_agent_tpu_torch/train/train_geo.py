"""Geo-model training step (PyTorch twin of the JAX package's
``train/train_geo.py:23-139``; reference Train_Geo.py).

One step = train-mode forward (batch-statistics BatchNorm, dropout from
the step's generator) with the head losses -> backward (the segment-softmax
and gather kernels' backward passes on the card) -> clipped Adam update ->
the BatchNorm running stats moved by the forward. Where the JAX step
returns a new state, the port updates the module and the optimizer in
place (PyTorch's idiom; no copy of the parameters is kept).

Not ported: ``make_geo_multi_step`` (a ``lax.scan`` over several steps to
spread dispatch cost; in PyTorch a loop of :func:`make_geo_train_step`
calls, with a CUDA graph as the later tool, ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..models.layers import set_dropout_generator
from ..models.multi_head import MultiHeadModel
from ..serve import init_random_, resolve_device
from .optim import Optimizer

METRIC_KEYS = (
    "loss", "geometric_loss", "pc_overlap_loss", "img_overlap_loss",
    "pc_overlap_precision", "pc_overlap_recall", "pc_overlap_accuracy",
    "img_overlap_precision", "img_overlap_recall", "img_overlap_accuracy",
)


@dataclasses.dataclass
class GeoTrainState:
    model: MultiHeadModel
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_geo_state(cfg: Config, device="cuda", seed: int = 0,
                     steps_per_epoch: int = 1000) -> GeoTrainState:
    """A ``MultiHeadModel`` with random weights from a generator seeded
    with ``seed`` (torch-style uniform init, as :mod:`..serve` makes them),
    on ``device`` (CUDA unless asked otherwise), and its optimizer."""
    model = MultiHeadModel(cfg)
    init_random_(model, torch.Generator().manual_seed(seed))
    model.to(resolve_device(device))
    return GeoTrainState(model, Optimizer(cfg, model.parameters(),
                                          steps_per_epoch))


def make_geo_train_step(cfg: Config) -> Callable:
    """``(state, batch, generator=None) -> metrics``: one optimizer step
    on ``batch`` (the synthetic/loader batch dict as tensors on the
    model's device); ``generator`` (on that device) draws the dropout
    masks. Metrics are 0-d tensors (no host sync)."""

    def train_step(state: GeoTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        state.model.train()
        set_dropout_generator(state.model, generator)
        state.optimizer.zero_grad()
        out = state.model(batch, with_loss=True)
        out["loss"].backward()
        state.optimizer.step()
        return {k: out[k].detach() for k in METRIC_KEYS}

    return train_step


def make_geo_eval_step(cfg: Config) -> Callable:
    """``(state, batch) -> metrics`` in eval mode (running BatchNorm)."""

    def eval_step(state: GeoTrainState, batch: Dict[str, torch.Tensor]):
        state.model.eval()
        with torch.no_grad():
            out = state.model(batch, with_loss=True)
        return {k: out[k] for k in METRIC_KEYS}

    return eval_step


def make_geo_forward(cfg: Config, with_loss: bool = False) -> Callable:
    """Frozen eval forward ``(model, batch) -> output dict`` (the agent
    stage's geo outputs)."""

    def forward(model: MultiHeadModel, batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            return model(batch, with_loss=with_loss)

    return forward
