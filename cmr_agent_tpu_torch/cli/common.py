"""Shared CLI plumbing (counterpart of the JAX package's ``cli/common.py``):
the common flags, the config, the dataset and its loader, seeding, the
geo model's weights and the training CLIs' checks.

Differences from the JAX package's CLIs:

* ``--device`` (default ``cuda``): the entry points run on the card unless
  asked for the CPU, and asking for CUDA where there is none raises;
* ``--distributed``, ``--coordinator``, ``--num-processes`` and
  ``--process-id`` join a ``torch.distributed`` job
  (:func:`maybe_initialize_distributed`, first in every CLI's ``main``;
  NCCL on the card, gloo on the CPU). As in the JAX package they only
  initialise: the CLIs' loops do not split their batches;
* ``--debug-nans`` fails fast on the first NaN a module puts out in the
  forward and on the first in the backward (:func:`set_debug_nans`), where
  the JAX package sets ``jax_debug_nans``;
* the XLA compile cache has no counterpart (the port's compiled code is
  the ``nvcc`` build cache); ``--profile`` writes a ``torch.profiler``
  trace (:func:`..utils.profiling.trace_context`) where the JAX CLIs
  write a ``jax.profiler`` one;
* the training CLIs' f32 matmuls and convolutions run at TF32
  (:func:`tf32_precision`), where PyTorch's own default differs between
  the two (matmuls off, convolutions on). ``--dtype bfloat16`` trains as
  the JAX package does: parameters, optimizer state and BatchNorm running
  statistics f32, activations bf16, the heads' outputs and the losses
  f32; the segment-softmax VJP reads its bf16 operands as given and
  rounds its gradients once to bf16. :func:`tf32_precision` stays on
  then and covers only the matmuls and convolutions left in f32 (the
  coordinate transforms); the bf16 layers and the kernels ignore it;
* checkpoints are the port's own train checkpoints and stepless
  snapshots, the weight exports of :mod:`..train.checkpoint`, found from
  the Orbax paths the JAX package's commands name, or the reference's
  ``.pth`` files (:func:`..train.convert.torch_to_state_dict`), wherever
  the JAX package's CLIs take one.

``--dataset kitti`` and ``--dataset nuscenes`` read the reference's dumps
under ``--data-root`` (:mod:`..data.kitti`, :mod:`..data.nuscenes`);
``synthetic`` (or ``--tiny``) makes scenes from a seed.

``--raster-int8`` stays ``store_true`` as in the JAX package, so the same
command means the same in both; like there, it cannot turn the ``Config``
default (``raster_int8=True``) off.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import random

import numpy as np
import torch

from ..config import Config, kitti_config, nuscenes_config, tiny_config


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--dataset", default="kitti",
                   choices=["kitti", "nuscenes", "synthetic"])
    p.add_argument("--data-root", default="", help="dataset root directory")
    p.add_argument("--tiny", action="store_true",
                   help="miniature config for smoke runs")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="cap optimizer steps (debug)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--synthetic-length", type=int, default=64)
    p.add_argument("--val-length", type=int, default=0,
                   help="synthetic val/test split size (0 = same as "
                        "--synthetic-length)")
    p.add_argument("--synthetic-scene", default="random",
                   choices=["random", "structured"],
                   help="synthetic generator: 'structured' (persistent "
                        "ground+boxes, rendered image) stays observable at "
                        "the full +-10 m/+-pi perturbation protocol")
    p.add_argument("--num-workers", type=int, default=None,
                   help="loader workers; default min(cfg.num_workers, host "
                        "cores)")
    p.add_argument("--loader-backend",
                   choices=["auto", "threads", "processes", "sync"],
                   default="auto",
                   help="auto = process pool for the GIL-bound real "
                        "datasets when workers > 1, threads otherwise; "
                        "sync = in-line loading (debug)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype override (Config.compute_dtype)")
    p.add_argument("--raster-mode", default=None,
                   choices=["topk", "compact", "flat", "pack", "mega",
                            "megatopk"],
                   help="episode raster strategy override "
                        "(Config.raster_mode)")
    p.add_argument("--raster-int8", action="store_true",
                   help="int8 observation raster (Config.raster_int8, "
                        "already the default)")
    p.add_argument("--obs3d-compact", action="store_true",
                   help="eval-episode 3-D observation over the compacted "
                        "top-K set (Config.obs3d_source='compact')")
    p.add_argument("--stop-file", default="",
                   help="graceful stop of a training run when this file "
                        "appears")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the run to "
                        "<dir>/trace.json (combine with --steps for a "
                        "bounded capture)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on the first NaN a module puts out, in "
                        "the forward or the backward")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed job before device use "
                        "(needs --coordinator, --num-processes, "
                        "--process-id)")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port (multi-process)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def maybe_initialize_distributed(args) -> None:
    """Join the ``torch.distributed`` job the flags name (NCCL for a CUDA
    ``--device``, gloo for the CPU); call first in every CLI ``main``."""
    if getattr(args, "distributed", False) or getattr(args, "coordinator",
                                                      None):
        from ..parallel.distributed import initialize
        initialize(coordinator_address=args.coordinator,
                   num_processes=args.num_processes,
                   process_id=args.process_id,
                   device=getattr(args, "device", "cuda"))


_NAN_HOOK = [None]


def _raise_on_nan(module, inputs, output) -> None:
    stack = [output]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_floating_point() and torch.isnan(o).any():
                raise FloatingPointError(
                    f"NaN in the output of {type(module).__name__} "
                    "(--debug-nans)")
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (tuple, list)):
            stack.extend(o)


def set_debug_nans(on: bool = True) -> None:
    """``--debug-nans``: with ``on``, every module's forward output is
    checked and the first NaN raises ``FloatingPointError`` naming the
    module, and autograd's anomaly mode (``check_nan``) raises at the
    first backward function that returns a NaN; off restores both. NaNs
    only, as ``jax_debug_nans``: some paths fill with infinities on
    purpose. Each check reads the device back, so the run slows down."""
    if on and _NAN_HOOK[0] is None:
        _NAN_HOOK[0] = torch.nn.modules.module.register_module_forward_hook(
            _raise_on_nan)
    elif not on and _NAN_HOOK[0] is not None:
        _NAN_HOOK[0].remove()
        _NAN_HOOK[0] = None
    torch.autograd.set_detect_anomaly(on, check_nan=True)


@contextlib.contextmanager
def tf32_precision(on: bool = True):
    """cuBLAS's f32 matmuls and cuDNN's f32 convolutions on the TF32
    tensor cores (``on``: inputs rounded to 10 mantissa bits, f32 sums) or
    in full f32 inside the block, the previous settings after it. The
    training CLIs train at TF32, the f32 training mode: the JAX package's
    f32 at its default precision rounds these inputs further (to bf16 on
    the TPU), and full f32 takes the cost-volume tower ~10x as long. The
    port's kernels, and the bf16 layers of ``--dtype bfloat16``, are
    untouched by either setting."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build_config(args) -> Config:
    if getattr(args, "debug_nans", False):
        set_debug_nans(True)
    overrides = {}
    if args.batch_size is not None:
        overrides["train_batch_size"] = args.batch_size
        overrides["val_batch_size"] = args.batch_size
    if args.epochs is not None:
        overrides["epoch"] = args.epochs
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.logdir is not None:
        overrides["logdir"] = args.logdir
    if args.ckpt_dir is not None:
        overrides["ckpt_dir"] = args.ckpt_dir
    if getattr(args, "dtype", None) is not None:
        overrides["compute_dtype"] = args.dtype

    if args.tiny:
        return tiny_config(**overrides)
    if args.dataset == "nuscenes":
        return nuscenes_config(args.data_root, **overrides)
    return kitti_config(args.data_root, **overrides)


def apply_obs_overrides(cfg: Config, args) -> Config:
    """Fold the observation / optimizer / amplitude flags that the calling
    parser defines into the config (absent attributes are skipped), one
    flag -> config mapping for every CLI."""
    over = {}
    if getattr(args, "pose_aware", False):
        over["pose_aware_observation"] = True
    if getattr(args, "obs_bearing", False):
        over["obs_bearing_channels"] = True
    if getattr(args, "aux_head", False):
        # the aux head reads the bearing channels, so it implies them
        over["obs_bearing_channels"] = True
        over["policy_aux_state"] = True
    if getattr(args, "bearing_init", False):
        over["bearing_init"] = True
    if getattr(args, "lr", None) is not None:
        over["lr"] = args.lr
    if getattr(args, "t_amp", None) is not None:
        over["p_tx_amplitude"] = args.t_amp
        over["p_tz_amplitude"] = args.t_amp
    if getattr(args, "r_amp", None) is not None:
        over["p_ry_amplitude"] = args.r_amp
    if getattr(args, "w_entropy", None) is not None:
        over["w_entropy"] = args.w_entropy
    if getattr(args, "alpha", None) is not None:
        over["alpha"] = args.alpha
    if getattr(args, "unmasked_warp", False):
        over["cost_volume_unmasked"] = True
    if getattr(args, "remat", False):
        over["cost_volume_remat"] = True
    if getattr(args, "embed_dim", 0):
        over["embed_dim"] = args.embed_dim
    if getattr(args, "mlp_dim", 0):
        over["mlp_dim"] = args.mlp_dim
    if getattr(args, "raster_mode", None):
        over["raster_mode"] = args.raster_mode
    if getattr(args, "raster_int8", False):
        over["raster_int8"] = True
    if getattr(args, "obs3d_compact", False):
        over["obs3d_source"] = "compact"
    return dataclasses.replace(cfg, **over) if over else cfg


def build_dataset(cfg: Config, args, mode: str):
    """The ``mode`` ("train", "val", "test") split with the native host
    ops, as the JAX package builds it, so both packages read the same
    scenes: the synthetic dataset with seed 0 / 1 / 2, or the KITTI or
    nuScenes dump under ``cfg.dataset_root``."""
    from ..data import KittiDataset, NuScenesDataset, SyntheticDataset
    from ..native import get_fast_host_ops

    fps_fn, nn_fn = get_fast_host_ops()
    if args.dataset == "synthetic" or args.tiny:
        seed = {"train": 0, "val": 1, "test": 2}[mode]
        length = args.synthetic_length
        if mode != "train" and getattr(args, "val_length", 0):
            length = args.val_length
        return SyntheticDataset(cfg, length=length, seed=seed,
                                fps_fn=fps_fn, nn_fn=nn_fn,
                                scene=getattr(args, "synthetic_scene",
                                              "random"))
    if args.dataset == "nuscenes":
        return NuScenesDataset(cfg, mode, fps_fn=fps_fn, nn_fn=nn_fn)
    return KittiDataset(cfg, mode, fps_fn=fps_fn, nn_fn=nn_fn)


def make_loader(cfg: Config, args, dataset, *, batch_size: int,
                shuffle: bool = False, seed: int = 0):
    """A :class:`..data.loader.DataLoader` with ``--num-workers`` workers
    (default ``min(cfg.num_workers, host cores)``); ``auto`` takes the
    process pool for a GIL-bound dataset with more than one worker and
    threads otherwise."""
    from ..data.loader import DataLoader

    workers = (args.num_workers if getattr(args, "num_workers", None)
               is not None else min(cfg.num_workers, os.cpu_count() or 1))
    backend = getattr(args, "loader_backend", "auto")
    if backend == "sync":
        workers = 0
    gil_bound = getattr(dataset, "gil_bound",
                        getattr(args, "dataset", "") in ("kitti", "nuscenes"))
    use_processes = (backend == "processes"
                     or (backend == "auto" and gil_bound and workers > 1))
    return DataLoader(dataset, batch_size, shuffle=shuffle,
                      num_workers=workers, seed=seed,
                      use_processes=use_processes)


def require_batches(loader) -> None:
    """Raise ``StopIteration`` where ``loader`` yields no batch (an empty or
    missing ``--data-root``), as the JAX package's evaluation CLIs do when
    they take their first batch."""
    if len(loader) == 0:
        raise StopIteration(f"the {len(loader.dataset)}-sample split gives "
                            f"no batch of {loader.batch_size}")


def set_seed(seed: int) -> None:
    """Seed the host's generators and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def to_device(batch, device) -> dict:
    """A loader batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def load_model(cfg: Config, module: torch.nn.Module, ckpt: str, which: str,
               what: str, device) -> torch.nn.Module:
    """``module`` with the weights of checkpoint ``ckpt`` (any layout of
    :mod:`..train.checkpoint`: a port train checkpoint or stepless
    snapshot, a weight export or the Orbax tree it came from, a reference
    ``.pth``), or, with no ``ckpt``, random weights from seed 0 after a
    WARNING, as the JAX package's CLIs do; on ``device``, in eval mode."""
    from ..serve import init_random_
    from ..train.checkpoint import restore_state_dict

    if ckpt:
        module.load_state_dict(restore_state_dict(ckpt, cfg, which),
                               strict=True)
        print(f"loaded {what} checkpoint from {ckpt}")
    else:
        init_random_(module, torch.Generator().manual_seed(0))
        print(f"WARNING: no --{what}-ckpt; using a randomly initialised "
              f"{what} model")
    return module.to(device).eval()


def load_geo_variables(cfg: Config, args, device):
    """The geo model (``MultiHeadModel``) of ``--geo-ckpt`` on ``device``
    (counterpart of the JAX package's ``cli/train_agent.py:74-95``)."""
    from ..models.multi_head import MultiHeadModel
    return load_model(cfg, MultiHeadModel(cfg), args.geo_ckpt, "multihead",
                      "geo", device)
