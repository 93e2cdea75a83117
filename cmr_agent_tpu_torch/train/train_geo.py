"""Geo-model training step (PyTorch twin of the JAX package's
``train/train_geo.py:23-139``; reference Train_Geo.py).

One step = train-mode forward (batch-statistics BatchNorm, dropout from
the step's generator) with the head losses -> backward (the segment-softmax
and gather kernels' backward passes on the card) -> clipped Adam update ->
the BatchNorm running stats moved by the forward. Where the JAX step
returns a new state, the port updates the module and the optimizer in
place (PyTorch's idiom; no copy of the parameters is kept).

:func:`make_geo_multi_step` is the port of the JAX package's one
dispatched ``lax.scan`` over several steps: on the card it replays one
captured CUDA graph of the train step per step, so the host launches one
graph where the eager step launches hundreds of kernels; on the CPU it is
a loop of :func:`make_geo_train_step`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

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


LOSS_KEYS = METRIC_KEYS[:4]


def require_compute_dtype(cfg: Config, model: nn.Module) -> None:
    """Raises unless every layer of ``model`` that fixes a compute dtype
    (the dense and conv layers) computes in ``cfg``'s: a model built
    under another config would train in its own dtype, silently, behind
    the step's ``--dtype``."""
    want = cfg.torch_dtype()
    got = {m.compute_dtype for m in model.modules()
           if getattr(m, "compute_dtype", None) is not None}
    if got - {want}:
        raise ValueError(f"the model computes in {sorted(map(str, got))}, "
                         f"the config asks for {want}: build the model "
                         f"from the step's config")


def make_geo_train_step(cfg: Config, mesh=None) -> Callable:
    """``(state, batch, generator=None) -> metrics``: one optimizer step
    on ``batch`` (the synthetic/loader batch dict as tensors on the
    model's device); ``generator`` (on that device) draws the dropout
    masks. Metrics are 0-d tensors (no host sync).

    With a :class:`..parallel.mesh.Mesh`, ``batch`` is this rank's dp rows
    of a global batch: the forward and the backward run under the mesh
    (global BatchNorm statistics, dropout masks and P/R/A counts; with an
    ``sp`` axis larger than 1 the ``LinearAttention`` modules on their
    sp route), the gradients (:func:`..parallel.mesh.reduce_gradients`
    when the sp route is live) and the losses are averaged over dp, so
    every rank takes the step one process takes on the global batch. A
    model whose layers compute in another dtype than ``cfg.compute_dtype``
    is refused at its first step (:func:`require_compute_dtype`)."""
    from ..parallel.mesh import (average_gradients, mean_over,
                                 reduce_gradients, use_mesh)
    checked = weakref.WeakSet()
    reduce = (reduce_gradients if mesh is not None and mesh.size("sp") > 1
              else average_gradients)

    def train_step(state: GeoTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        if state.model not in checked:
            require_compute_dtype(cfg, state.model)
            checked.add(state.model)
        state.model.train()
        set_dropout_generator(state.model, generator)
        state.optimizer.zero_grad()
        with use_mesh(mesh):
            out = state.model(batch, with_loss=True)
            out["loss"].backward()
        if mesh is not None:
            reduce(state.model, mesh)
        state.optimizer.step()
        metrics = {k: out[k].detach() for k in METRIC_KEYS}
        return metrics if mesh is None else mean_over(metrics, LOSS_KEYS,
                                                      mesh)

    return train_step


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` warms up and captures
    on. The kernels keep a scratch buffer per stream (``ops.kernels.
    _scratch``), so a fresh stream per capture would keep one more buffer
    (~87 MB at KITTI width) for each capture a process makes."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _CapturedStep:
    """One train step of ``state`` captured into a CUDA graph: the batch
    is copied into static buffers before each replay, dropout draws from
    ``generator`` (registered with the graph, so each replay consumes and
    advances its offsets as the eager step does), BatchNorm's running
    stats and the optimizer's state update in place inside the graph.

    Capture needs warm-up steps (the autograd graph, cuBLAS and cuDNN
    handles, the optimizer's state) on the capture stream; their effect on
    the parameters, buffers, optimizer state, ``count`` and the generator
    is undone afterwards, so the first replay starts where the caller
    left the state."""

    WARMUP = 2

    def __init__(self, step: Callable, state: "GeoTrainState",
                 batch: Dict[str, torch.Tensor], generator: torch.Generator):
        self.state, self.generator = state, generator
        opt = state.optimizer
        opt.make_capturable()
        self.static = {k: v.clone() for k, v in batch.items()}
        tensors = list(state.model.parameters()) + list(state.model.buffers())
        saved = [t.detach().clone() for t in tensors]
        had_state = {p: {k: v.clone() for k, v in opt.inner.state[p].items()}
                     for p in opt.params if p in opt.inner.state}
        count, rng = opt.count, generator.get_state()
        stream = _capture_stream(next(iter(batch.values())).device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP):
                step(state, self.static, generator)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=stream):
            self.metrics = step(state, self.static, generator)
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
            for p in opt.params:
                for k, v in opt.inner.state.get(p, {}).items():
                    if p in had_state:
                        v.copy_(had_state[p][k])
                    else:
                        v.zero_()       # Adam's fresh state: zero moments
        opt.count = count
        generator.set_state(rng)

    def matches(self, state, batch, generator) -> bool:
        return (state is self.state and generator is self.generator
                and batch.keys() == self.static.keys()
                and all(v.shape == self.static[k].shape
                        and v.dtype == self.static[k].dtype
                        for k, v in batch.items()))

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        for k, v in batch.items():
            self.static[k].copy_(v)
        opt = self.state.optimizer
        opt.set_lr()
        self.graph.replay()
        opt.count += 1
        return {k: v.clone() for k, v in self.metrics.items()}


def make_geo_multi_step(cfg: Config, steps_per_call: int,
                        mesh=None) -> Callable:
    """``(state, stacked_batch, generator) -> metrics``: ``steps_per_call``
    optimizer steps (JAX ``train/train_geo.py:83-116``) on
    ``stacked_batch``, whose tensors carry a leading ``[S, B, ...]`` step
    axis; each metric comes back stacked ``[S]``. ``generator`` (on the
    model's device) draws every step's dropout masks in turn.

    On the card the step is captured once into a CUDA graph (for the state,
    generator and batch shapes of the first call; another of those
    captures anew) and replayed ``S`` times; the state's optimizer turns
    capturable (:meth:`.optim.Optimizer.make_capturable`). Capture failing
    raises: the card never falls back to eager steps. On the CPU it is a
    loop of :func:`make_geo_train_step`. It is one process's: given a
    ``mesh`` it raises (a sharded run steps through
    :func:`..parallel.mesh.make_sharded_geo_train_step`, one step a
    call)."""
    if mesh is not None:
        raise ValueError("make_geo_multi_step runs in one process; train "
                         "under a mesh with parallel.mesh."
                         "make_sharded_geo_train_step, one step a call")
    step = make_geo_train_step(cfg)
    captured: Optional[_CapturedStep] = None

    def multi_step(state: GeoTrainState, stacked: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        nonlocal captured
        n = next(iter(stacked.values())).shape[0]
        if n != steps_per_call:
            raise ValueError(f"stacked batch of {n} steps, expected "
                             f"{steps_per_call}")
        batches = [{k: v[i] for k, v in stacked.items()} for i in range(n)]
        if next(iter(stacked.values())).device.type != "cuda":
            metrics = [step(state, b, generator) for b in batches]
        else:
            if generator is None:
                raise ValueError("a captured step needs an explicit CUDA "
                                 "generator")
            if captured is None or not captured.matches(state, batches[0],
                                                        generator):
                captured = _CapturedStep(step, state, batches[0], generator)
            metrics = [captured(b) for b in batches]
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return multi_step


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


def wrap_oracle_overlap(fwd: Callable) -> Callable:
    """Oracle-perception ablation (JAX ``train/train_geo.py:142-161``):
    wraps a :func:`make_geo_forward` forward ``(model, batch) -> out`` so
    that the ground-truth overlap flags (``batch["pc_mask"]``) stand in for
    the geo head's predictions. Every result produced through it is an
    ablation and must be labelled as one."""

    def wrapped(model: nn.Module, batch: Dict[str, torch.Tensor]):
        out = dict(fwd(model, batch))
        out["pc_overlap_pred"] = batch["pc_mask"].bool()
        out["pc_is_in_cam_scores"] = batch["pc_mask"].float()
        return out

    return wrapped
