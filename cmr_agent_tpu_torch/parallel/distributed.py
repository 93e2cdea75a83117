"""Multi-process entry point on ``torch.distributed`` (counterpart of the
JAX package's ``parallel/distributed.py``; the reference is one process on
one GPU, Train_Geo.py:8).

:func:`initialize` joins the job through a TCP rendezvous at the address it
is given (nothing on a single machine announces a cluster): NCCL for
``cuda``, gloo for the CPU, or the ``backend`` asked for (gloo also
all-reduces CUDA tensors, so several ranks can share one card). Each
process loads its own shard of the data (:func:`shard_range`) and hands
its rows to :func:`host_local_batch_to_global`; the global batch is the
rows of every dp rank in rank order. Besides the default group, every
initialised job keeps a gloo group for host-side work (:func:`barrier`,
:func:`psum_scalar`), so neither needs a device collective.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = [None]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device="cuda", backend: Optional[str] = None,
               timeout_s: float = 900.0) -> None:
    """Join the job: ``init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port``) as rank ``process_id``
    of ``num_processes``. ``backend`` defaults to NCCL for a ``cuda``
    ``device`` and gloo otherwise; ``local_device_ids`` picks this
    process's card (default: ``process_id`` modulo the cards in view).
    Must run before the process's first collective."""
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id: nothing on this "
                         "machine announces a cluster")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda is not "
                               "available; pass device='cpu'")
        torch.cuda.set_device(int(local_device_ids[0]) if local_device_ids
                              else int(process_id)
                              % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _HOST_GROUP[0] = (dist.group.WORLD if backend == "gloo"
                      else dist.new_group(backend="gloo", timeout=timeout))


def shutdown() -> None:
    """Leave the job (``destroy_process_group``); a no-op outside one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP[0] = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_range(n: int) -> range:
    """This process's contiguous shard of ``range(n)`` (dataset sharding)."""
    per = (n + process_count() - 1) // process_count()
    lo = process_index() * per
    return range(lo, min(lo + per, n))


def host_local_batch_to_global(batch: Dict[str, np.ndarray], mesh,
                               batch_axis: str = "dp"
                               ) -> Dict[str, torch.Tensor]:
    """This process's rows of one global batch, as tensors on the mesh's
    device: the process passes its local batch (global batch /
    ``mesh.size(batch_axis)`` rows), and the global batch is the rows of
    every rank along ``batch_axis`` in rank order, as JAX's global arrays
    are. The result feeds a step built for ``mesh``."""
    if batch_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {batch_axis!r}")
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
            for k, v in batch.items()}


def global_batch_size(local_batch_size: int) -> int:
    return local_batch_size * process_count()


def barrier(name: str, timeout_s: float = 900.0) -> None:
    """Wait until every process reaches the barrier called ``name``,
    without a device collective (gloo's ``monitored_barrier``, which names
    the ranks that did not arrive within ``timeout_s``). No-op in a
    single-process job."""
    if process_count() == 1:
        return
    try:
        dist.monitored_barrier(group=_HOST_GROUP[0],
                               timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def psum_scalar(x) -> float:
    """Cross-process scalar sum (a metric): every process's value, as f32,
    gathered on the host group and summed, as the JAX package's
    ``process_allgather`` then ``np.sum`` does."""
    local = torch.tensor([float(x)], dtype=torch.float32)
    if process_count() == 1:
        return float(local.numpy().sum())
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local, group=_HOST_GROUP[0])
    return float(torch.cat(parts).numpy().sum())
