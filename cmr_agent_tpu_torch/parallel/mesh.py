"""Process meshes and the sharded geo step and forward (counterpart of the
JAX package's ``parallel/mesh.py``).

A :class:`Mesh` names the job's processes along a ``dp`` (batch) axis and
an optional ``sp`` (token) axis, with a process group per axis
(``torch.distributed.device_mesh``). Where the JAX package keeps global
arrays and lets XLA place the collectives, each rank here holds its own
rows and the modules reduce across ranks themselves, so that a rank's
result is what one process computes on the whole batch:

* under :func:`use_mesh`, the port's ``BatchNorm`` in ``train()`` mode
  all-reduces its sums over ``dp`` (differentiably), so the statistics and
  the running stats are the global batch's; ``Dropout`` draws the global
  batch's mask from its (identically seeded) generator and keeps its own
  rows; the P/R/A metrics count over ``dp``; ``LinearAttention`` takes the
  sequence-parallel route of :mod:`.sp` when ``sp`` is larger than 1, in
  the eval forward and in training;
* every other draw from a generator on a sharded path goes through
  :func:`rand_shard`, so the stochastic rollout under dp samples the
  actions one process samples;
* :func:`make_sharded_geo_train_step` averages the gradients and the
  losses over ``dp``; with the sp route live, :func:`reduce_gradients`
  first sums over ``sp`` the gradients of the modules that the route
  marked (:func:`mark_sp_partial`), the only gradients that are partial
  there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import Config
from . import distributed


class Mesh:
    """Named axes over the job's processes: each axis's size, this rank's
    coordinate on it, its process group (None when the job is one
    process) and the device the ranks' tensors live on."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = torch.device(device)
        self.device_mesh = device_mesh

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp",), device="cuda") -> Mesh:
    """A mesh over the job's processes (default: all of them on ``dp``);
    ``mesh_shape`` must multiply to the process count. Tensors live on
    ``device`` (several gloo ranks may share one card)."""
    world = distributed.process_count()
    if mesh_shape is None:
        mesh_shape = (world,) + (1,) * (len(axis_names) - 1)
    if math.prod(mesh_shape) != world:
        raise ValueError(f"mesh {tuple(mesh_shape)} over {world} processes")
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(torch.device(device).type,
                                       tuple(mesh_shape),
                                       mesh_dim_names=tuple(axis_names))
    return Mesh(mesh_shape, axis_names, device, device_mesh)


_CURRENT: list = [None]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """The ambient mesh of the modules inside the block (JAX's
    ``jax.sharding.set_mesh``)."""
    saved = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = saved


def axis_group(axis: str):
    """``(group, rank, size)`` of the ambient mesh's ``axis`` when it spans
    more than one process, else None."""
    mesh = _CURRENT[0]
    if mesh is None or mesh.size(axis) <= 1:
        return None
    return mesh.group(axis), mesh.rank(axis), mesh.size(axis)


_TOKEN_DIM: list = [None]


@contextlib.contextmanager
def token_shards(dim: int = 1):
    """Within it, this rank's tensors are also its ``sp`` shard of the
    global ones along tensor axis ``dim`` (the token axis of a module that
    works on a token shard, as the sp route of ``LinearAttention`` does)."""
    saved = _TOKEN_DIM[0]
    _TOKEN_DIM[0] = dim
    try:
        yield
    finally:
        _TOKEN_DIM[0] = saved


def row_shards():
    """``[(tensor axis, index, count)]``: how this rank's tensors slice the
    global ones (the batch axis over ``dp``, and inside
    :func:`token_shards` the token axis over ``sp``)."""
    out = []
    dp = axis_group("dp")
    if dp is not None:
        out.append((0, dp[1], dp[2]))
    sp = axis_group("sp")
    if sp is not None and _TOKEN_DIM[0] is not None:
        out.append((_TOKEN_DIM[0], sp[1], sp[2]))
    return out


def rand_shard(shape, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's shard of a global tensor: the
    global shape is drawn from ``generator`` (seeded alike on every rank)
    and this rank's block kept (:func:`row_shards`), so the ranks together
    draw what one process draws for the whole tensor, as JAX draws at the
    global shape of a sharded array. Outside a mesh it is ``torch.rand``."""
    shards = row_shards()
    full = list(shape)
    for axis, _, count in shards:
        full[axis] *= count
    u = torch.rand(full, generator=generator, device=device)
    for axis, index, _ in shards:
        u = u.narrow(axis, index * shape[axis], shape[axis])
    return u


def _padded(x: torch.Tensor, rank: int, size: int, dim: int,
            dtype: torch.dtype) -> torch.Tensor:
    """``x`` as rank ``rank``'s block of a ``size`` times longer tensor
    along ``dim``, zeros elsewhere."""
    n = x.shape[dim]
    before = [n * rank if d == dim else s for d, s in enumerate(x.shape)]
    after = [n * (size - rank - 1) if d == dim else s
             for d, s in enumerate(x.shape)]
    return torch.cat([x.new_zeros(before, dtype=dtype), x.to(dtype),
                      x.new_zeros(after, dtype=dtype)], dim=dim)


class _GatherRows(torch.autograd.Function):
    """The gather of :func:`gather_rows`; its backward hands each rank its
    own slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, rank: int, size: int, dim: int):
        ctx.slice = (dim, rank * x.shape[dim], x.shape[dim])
        work_dtype = x.dtype if x.is_floating_point() else torch.int64
        full = _padded(x, rank, size, dim, work_dtype)
        dist.all_reduce(full, group=group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.slice).contiguous(), None, None, None, None


def gather_rows(x: torch.Tensor, group, rank: int, size: int,
                dim: int = 0) -> torch.Tensor:
    """The ranks' equal shards of ``x`` along ``dim`` concatenated in rank
    order on every rank. It is an all-reduce of each rank's shard placed in
    zeros (adding zeros is exact), so every backend that all-reduces
    does it, gloo with CUDA tensors included. Differentiable for a loss
    that every rank of ``group`` computes alike from the result (the sp
    route's): the backward hands each rank its own slice of the cotangent
    and sums nothing, because every rank holds the whole cotangent
    already; summing there, as an all-reduce's own backward does, would
    scale the gradient by the group's size."""
    return _GatherRows.apply(x, group, rank, size, dim)


class _TakeShard(torch.autograd.Function):
    """The slice of :func:`take_shard`; its backward gathers the ranks'
    cotangent slices into the whole cotangent on every rank."""

    @staticmethod
    def forward(ctx, x, group, rank: int, size: int, dim: int):
        ctx.args = (group, rank, size, dim)
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        group, rank, size, dim = ctx.args
        full = _padded(grad, rank, size, dim, grad.dtype)
        dist.all_reduce(full, group=group)
        return full, None, None, None, None


def take_shard(x: torch.Tensor, group, rank: int, size: int,
               dim: int = 1) -> torch.Tensor:
    """This rank's equal shard of ``x`` (whole and alike on every rank of
    ``group``) along ``dim``. Its backward all-gathers the ranks' cotangent
    slices, so what lies upstream (replicated over ``group``) gets the
    whole gradient on every rank, as one process would."""
    return _TakeShard.apply(x, group, rank, size, dim)


def replicate(tree, mesh: Mesh, src: int = 0):
    """Broadcast a module's parameters and buffers (or a dict of tensors)
    from process ``src`` to every process, so that all ranks start equal;
    returns ``tree``. A no-op in a single-process job."""
    tensors = (list(tree.state_dict().values())
               if isinstance(tree, torch.nn.Module) else list(tree.values()))
    if distributed.process_count() > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src)
    return tree


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor splits over the mesh: ``spec[d]`` names the mesh axis
    that tensor axis ``d`` is split over (None: whole on every rank)."""
    mesh: Mesh
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the global tensor ``x``, on the mesh's
        device; each split axis must divide evenly, as JAX's shardings
        require."""
        for d, axis in enumerate(self.spec):
            n = self.mesh.size(axis) if axis is not None else 1
            if n == 1:
                continue
            if x.shape[d] % n:
                raise ValueError(f"axis {d} of {tuple(x.shape)} does not "
                                 f"split over {axis}={n}")
            k = x.shape[d] // n
            x = x.narrow(d, self.mesh.rank(axis) * k, k)
        return x.to(self.mesh.device)


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: str = "dp"
                   ) -> Sharding:
    return Sharding(mesh, (batch_axis,) + (None,) * (ndim - 1))


def batch_token_sharding(mesh: Mesh, ndim: int, batch_axis: str = "dp",
                         token_axis: str = "sp") -> Sharding:
    """Axis 0 over dp and axis 1 (tokens / points) over sp."""
    return Sharding(mesh, (batch_axis, token_axis) + (None,) * (ndim - 2))


# Keys whose axis 1 is the point-token axis (shardable over 'sp').
_POINT_AXIS_KEYS = ("pc", "pt2node", "pc_mask", "pc_in_cam_space")


def shard_geo_batch(batch: Dict, mesh: Mesh, use_sp: bool = False) -> Dict:
    """This rank's shard of a global geo batch: the batch axis over dp,
    and with ``use_sp`` the point-token axis of the point keys over sp."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if use_sp and k in _POINT_AXIS_KEYS and v.ndim >= 2 \
                and "sp" in mesh.axis_names:
            out[k] = batch_token_sharding(mesh, v.ndim).shard(v)
        else:
            out[k] = batch_sharding(mesh, v.ndim).shard(v)
    return out


def all_reduce_flat(grads, group, divisor: int = 1) -> None:
    """``grads`` replaced by their sum over ``group`` (every process where
    None) divided by ``divisor``, as one all-reduce of the flattened
    tensors."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def average_gradients(module: torch.nn.Module, mesh: Mesh,
                      axis: str = "dp") -> None:
    """Each gradient of ``module`` replaced by its mean over ``axis`` (one
    all-reduce of the flattened gradients)."""
    if mesh.size(axis) <= 1:
        return
    all_reduce_flat([p.grad for p in module.parameters()
                     if p.grad is not None], mesh.group(axis),
                    mesh.size(axis))


_SP_PARTIAL: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()


def mark_sp_partial(module: torch.nn.Module) -> None:
    """Record that ``module`` works on a token shard over ``sp``, so that
    each rank's gradients of its own parameters are that shard's part of
    the whole (the sp route of ``LinearAttention`` calls it)."""
    _SP_PARTIAL.add(module)


def reduce_gradients(module: torch.nn.Module, mesh: Mesh) -> None:
    """The gradients of a step that ran under ``mesh``: the parameters of
    the submodules that worked on a token shard (:func:`mark_sp_partial`)
    summed over ``sp`` first, then every gradient averaged over ``dp``;
    one flattened all-reduce per group. The rest of the model is
    replicated over ``sp``, each of its ranks holding the whole gradient
    already, so nothing else is summed there."""
    if mesh.size("sp") > 1:
        all_reduce_flat([p.grad for m in module.modules()
                         if m in _SP_PARTIAL
                         for p in m.parameters()
                         if p.grad is not None], mesh.group("sp"))
    average_gradients(module, mesh, "dp")


def mean_over(metrics: Dict[str, torch.Tensor], keys, mesh: Mesh,
              axis: str = "dp") -> Dict[str, torch.Tensor]:
    """``metrics`` with the entries named in ``keys`` (equal-weight means
    over each rank's equal rows) averaged over ``axis``."""
    if mesh.size(axis) <= 1:
        return metrics
    keys = [k for k in keys if k in metrics]
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked, group=mesh.group(axis))
    stacked /= mesh.size(axis)
    return {**metrics, **dict(zip(keys, stacked.unbind(0)))}


def make_sharded_geo_train_step(cfg: Config, mesh: Mesh):
    """``(state, global_batch, generator=None) -> metrics``: the geo train
    step on this rank's dp rows of the global batch
    (:func:`..train.train_geo.make_geo_train_step` with ``mesh``): the
    BatchNorm statistics, dropout masks, losses, metrics and gradients are
    the global batch's. Every rank holds the same state (:func:`replicate`)
    and passes an identically seeded generator. On a mesh whose ``sp``
    axis spans several ranks (JAX's ``shard_geo_batch(..., use_sp=True)``
    under ``set_mesh``) the ``LinearAttention`` modules take the sp route
    over it, in the forward and the backward. ``cfg.compute_dtype``
    bfloat16 trains as one
    process does (f32 parameters and statistics, bf16 activations; the
    BatchNorm sums all-reduced in f32); a model built in another dtype
    than ``cfg``'s raises at the first step."""
    from ..train.train_geo import make_geo_train_step

    step = make_geo_train_step(cfg, mesh=mesh)

    def sharded_step(state, batch, generator=None):
        return step(state, shard_geo_batch(batch, mesh), generator)

    return sharded_step


def make_sharded_geo_forward(cfg: Config, mesh: Mesh, use_sp: bool = False):
    """``(model, global_batch) -> outputs``: the frozen forward of the
    global batch with each dp rank running its rows, ``LinearAttention``'s
    message split over sp with ``use_sp``, and the outputs gathered over
    dp, so that every rank returns the unsharded forward's outputs."""

    def run(model, batch):
        model.eval()
        with torch.no_grad(), use_mesh(mesh if use_sp else None):
            out = model(shard_geo_batch(batch, mesh), with_loss=False)
        dp = (mesh.group("dp"), mesh.rank("dp"), mesh.size("dp"))
        if dp[2] == 1:
            return out
        return {k: gather_rows(v, *dp) for k, v in out.items()}

    return run
