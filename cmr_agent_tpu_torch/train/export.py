"""Serving export: the port's inference programs as ``torch.export``
artifacts (PyTorch twin of the JAX package's ``train/export.py``).

The JAX package serialises each jitted inference function to StableHLO
and runs it later from any process without the model code or a re-trace.
Here each program is traced once by ``torch.export`` (eval mode, no
gradient) into an ``ExportedProgram`` whose graph holds the port's kernels
as ``cmr::`` operators (``ops/kernels.py``), saved with
``torch.export.save``. Three artifacts cover the inference surfaces:

* :func:`export_geo_forward`: the one-shot geo forward, batch -> overlap
  predictions + geo features;
* :func:`export_episode`: the deterministic K-step refinement episode as
  one program, from the bearing yaw under ``cfg.bearing_init`` (else the
  identity), on the geo state of :data:`EPISODE_KEYS` (no ground truth);
* :func:`export_composed_pipeline`: the coarse-to-fine pipeline
  (``serve.CoarseToFine`` with the JAX export's options) as one program.

The weights are baked into the artifact (re-export when they change).
:func:`load_exported` needs the port's kernels module and ``torch`` only;
its ``.call`` runs the program on the CPU as it is and, on the card, as
one CUDA graph captured at the first call and replayed after.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils import _pytree

#: what :func:`export_geo_forward`'s program returns
GEO_OUTPUT_KEYS = ("pc_geo_feat", "img_geo_feat", "pc_overlap_pred",
                   "pc_overlap_pred_standby", "pc_is_in_cam_scores",
                   "img_overlap_pred")
#: what the deterministic episode reads (export.py:33-38): notably not the
#: ground-truth pose, which a client registering a new scan has none of
EPISODE_KEYS = ("pc", "K", "pc_overlap_pred", "pc_is_in_cam_scores",
                "pc_geo_feat", "img_geo_feat")
_META = "cmr_export.json"


class _Program(nn.Module):
    """``body`` over ``modules`` as one module, whose parameters and
    buffers are the modules' (each once), so that the export bakes them
    in; takes one dict of tensors."""

    def __init__(self, body: Callable, modules: Sequence[nn.Module]):
        super().__init__()
        unique = []
        for m in modules:
            if all(m is not u for u in unique):
                unique.append(m)
        self.parts = nn.ModuleList(unique)
        self.body = body

    def forward(self, inputs: Dict[str, torch.Tensor]):
        return self.body(inputs)


@contextlib.contextmanager
def _counting_plain_nodes(count: list):
    """While tracing, count into ``count[0]`` the graph nodes that a plain
    version of ``ops/kernels.py`` adds: each name of the kernels module
    bound to a function of ``kernels.PLAIN`` (a plain version, or a
    wrapper swapped for one) is shimmed to measure the traced graph's
    growth over its outermost calls, at least one node a call. 0 when
    every kernel on the path was traced as its ``cmr::`` operator."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    from ..ops import kernels

    plain_ids = {id(fn) for fn in kernels.PLAIN.values()}
    saved = {name: fn for name, fn in vars(kernels).items()
             if id(fn) in plain_ids}
    depth = [0]

    def graph_size():
        mode = get_proxy_mode()
        return len(mode.tracer.graph.nodes) if mode is not None else 0

    def shim(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            before = graph_size()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                count[0] += max(graph_size() - before, 1)
        return counted

    try:
        for name, fn in saved.items():
            setattr(kernels, name, shim(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def geo_forward_body(geo: nn.Module) -> Callable:
    """The traced body of :func:`export_geo_forward`: batch -> the six
    outputs of :data:`GEO_OUTPUT_KEYS`."""
    def body(batch):
        out = geo(batch)
        return {k: out[k] for k in GEO_OUTPUT_KEYS}
    return body


def episode_body(cfg, agent: nn.Module) -> Callable:
    """The traced body of :func:`export_episode`: geo state -> final
    disentangled pose ``[B, 4, 4]`` (``serve.refine_episode``: the bearing
    yaw or the identity, ``cfg.episode_raster_topk()``)."""
    from ..serve import refine_episode

    def body(state):
        return refine_episode(cfg, agent, state)[0]
    return body


def _export(body: Callable, modules: Sequence[nn.Module],
            inputs: Dict[str, torch.Tensor], kind: str,
            path: Optional[str]) -> bytes:
    """Trace ``body`` on ``inputs`` with ``modules`` in eval mode and
    without gradients (not under ``torch.inference_mode``, whose tensors do
    not export), save the program with its description; returns (and
    optionally writes) the artifact's bytes."""
    # tensors made under inference_mode cannot be traced; their copies can
    inputs = {k: v.clone() if v.is_inference() else v
              for k, v in inputs.items()}
    devices = {v.device for v in inputs.values()}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on several devices: {devices}")
    was_training = [m.training for m in modules]
    plain = [0]
    try:
        for m in modules:
            m.eval()
        with torch.no_grad(), _counting_plain_nodes(plain):
            program = torch.export.export(_Program(body, modules), (inputs,),
                                          strict=False)
    finally:
        for m, mode in zip(modules, was_training):
            m.train(mode)
    meta = {"kind": kind, "device": str(devices.pop()),
            "plain_nodes": plain[0],
            "inputs": {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                       for k, v in inputs.items()}}
    # the artifact takes its inputs from the caller: the example batch would
    # be saved inside it otherwise (at KITTI width, B = 8, ~100 MB)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_geo_forward(cfg, geo: nn.Module, example_batch: Dict,
                       path: Optional[str] = None) -> bytes:
    """Serialise the eval-mode geo forward on the keys of
    ``example_batch``; returns (and optionally writes) the artifact's
    bytes. ``cfg`` is the model's configuration (the JAX signature's
    first argument; ``geo`` carries it)."""
    return _export(geo_forward_body(geo), [geo], dict(example_batch),
                   "geo_forward", path)


def export_episode(cfg, agent: nn.Module, example_state: Dict,
                   path: Optional[str] = None) -> bytes:
    """Serialise the deterministic ``cfg.action_num``-step episode (geo
    state -> final pose) on the keys of ``example_state`` among
    :data:`EPISODE_KEYS`."""
    state = {k: v for k, v in example_state.items() if k in EPISODE_KEYS}
    return _export(episode_body(cfg, agent), [agent], state, "episode", path)


def export_composed_pipeline(cfg, geo: nn.Module, iter_model: nn.Module,
                             agent: nn.Module, example_batch: Dict, *,
                             fine_geo: Optional[nn.Module] = None,
                             hypotheses: int = 1, iter_iters: int = 1,
                             iter_shrink: float = 1.0,
                             hypo_score: str = "smooth_mean",
                             refine_rounds: int = 0,
                             refine_beam: tuple = (),
                             beam_score: Optional[str] = None,
                             beam_frame: str = "own",
                             path: Optional[str] = None) -> bytes:
    """Serialise the coarse-to-fine registration pipeline as one program:
    ``serve.composed_pipeline`` (the body ``serve.CoarseToFine`` with the
    JAX export's acceptance by each member's own statistic and its
    compaction ranked by ``pc_is_in_cam_scores``) on the inputs of
    ``serve.COMPOSED_KEYS`` -> ``pose [B,4,4]`` (absolute), ``score [B]``
    and ``candidate_scores [B, hypotheses]``. ``fine_geo`` (default
    ``geo``) perceives the fine stages."""
    from ..serve import COMPOSED_KEYS, composed_pipeline

    pipeline = composed_pipeline(
        cfg, geo, iter_model, agent, fine_geo=fine_geo,
        hypotheses=hypotheses, iter_iters=iter_iters,
        iter_shrink=iter_shrink, hypo_score=hypo_score,
        refine_rounds=refine_rounds, refine_beam=refine_beam,
        beam_score=beam_score, beam_frame=beam_frame)
    modules = [geo, iter_model, agent] + (
        [fine_geo] if fine_geo is not None else [])
    batch = {k: example_batch[k] for k in COMPOSED_KEYS}
    return _export(pipeline, modules, batch, "composed_pipeline", path)


class LoadedProgram:
    """A loaded artifact. ``call(args)`` takes a dict with (at least) the
    artifact's input keys, each of the exported shape and dtype on the
    exported device, and returns what the program returns:

    * on the CPU it runs the program's module;
    * on the card, at the first call, it runs the module once on a side
      stream (the kernels' first launches set their attributes there,
      outside the capture), then captures it into one
      ``torch.cuda.CUDAGraph`` over
      static input buffers; each call copies its inputs in, replays the
      graph and returns clones of the outputs. A capture that fails
      raises: there is no eager retry.

    ``run(args)`` runs the module without the graph, on any device.
    ``program`` is the ``ExportedProgram``, ``meta`` its description
    (``kind``, ``device``, ``inputs``: key -> [shape, dtype], and
    ``plain_nodes``: the nodes that plain versions of the kernels added to
    the graph, 0 where every kernel is a ``cmr::`` operator)."""

    def __init__(self, program, meta: dict):
        self.program, self.meta = program, meta
        self.keys = tuple(meta["inputs"])
        self.device = torch.device(meta["device"])
        self.module = program.module()
        self.graph = None
        self._static_in = self._static_out = None

    def _inputs(self, args: Dict) -> Dict[str, torch.Tensor]:
        """The artifact's inputs from ``args``, in its order; raises on a
        missing key or a shape, dtype or device that differs."""
        missing = [k for k in self.keys if k not in args]
        if missing:
            raise KeyError(f"inputs missing from the call: {missing}")
        inputs = {}
        for k in self.keys:
            v, (shape, dtype) = args[k], self.meta["inputs"][k]
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"{k}: expected a tensor, got {type(v)}")
            if list(v.shape) != shape:
                raise ValueError(f"{k}: shape {list(v.shape)}, the artifact "
                                 f"takes {shape}")
            if v.dtype != getattr(torch, dtype):
                raise TypeError(f"{k}: dtype {v.dtype}, the artifact takes "
                                f"torch.{dtype}")
            if v.device.type != self.device.type:
                raise ValueError(f"{k}: on {v.device}, the artifact runs on "
                                 f"{self.device}")
            inputs[k] = v
        return inputs

    def run(self, args: Dict):
        """The program's module on ``args``, without a CUDA graph."""
        with torch.no_grad():
            return self.module(self._inputs(args))

    def call(self, args: Dict):
        inputs = self._inputs(args)
        if self.device.type != "cuda":
            with torch.no_grad():
                return self.module(inputs)
        if self.graph is None:
            self._capture(inputs)
        for k, v in inputs.items():
            self._static_in[k].copy_(v)
        self.graph.replay()
        return _pytree.tree_map(torch.clone, self._static_out)

    def _capture(self, inputs: Dict[str, torch.Tensor]) -> None:
        # the warm-up and the capture run on the device's one capture
        # stream (train_geo's): the kernels keep an eager scratch buffer
        # per stream, so a fresh stream per artifact would keep one more
        # buffer for every capture the process makes
        from .train_geo import _capture_stream
        static = {k: v.clone() for k, v in inputs.items()}
        dev = self.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad():
            with torch.cuda.stream(side):
                self.module(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = self.module(static)
        self.graph, self._static_in, self._static_out = graph, static, out


def load_exported(blob_or_path) -> LoadedProgram:
    """Deserialise an artifact (bytes, or a path) -> :class:`LoadedProgram`.
    Imports the port's kernels first, which registers the ``cmr::``
    operators its graph calls."""
    from ..ops import kernels  # noqa: F401  (registers cmr::)

    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return LoadedProgram(program, json.loads(extra[_META]))


def kernel_nodes(program) -> Dict[str, int]:
    """The ``cmr::`` operators in ``program``'s graph (an
    ``ExportedProgram`` or a :class:`LoadedProgram`): wrapper name ->
    count, each kernel once per node."""
    program = getattr(program, "program", program)
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and \
                getattr(node.target, "namespace", None) == "cmr":
            name = node.target.name().split("::", 1)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def host_data_nodes(program) -> int:
    """The tensors ``program``'s graph makes from data of the host each
    call (``lift_fresh_copy`` of a constant the trace lifted: a
    ``torch.tensor`` of Python or numpy data, an index list, a scalar
    assigned into a tensor). On the card each is a copy from the host,
    which a CUDA graph cannot capture; the port's traced bodies make none,
    so this is 0."""
    program = getattr(program, "program", program)
    return sum(node.target is torch.ops.aten.lift_fresh_copy.default
               for node in program.graph.nodes)
