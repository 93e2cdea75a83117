"""Data and sequence parallelism on ``torch.distributed`` (counterpart of
the JAX package's ``parallel/``): a process mesh with ``dp`` and ``sp``
axes, the sharded geo step and forward, the sp linear-attention message
and the multi-process entry point."""

from .mesh import (  # noqa: F401
    make_mesh, replicate, batch_sharding, batch_token_sharding,
    make_sharded_geo_train_step, make_sharded_geo_forward, use_mesh,
)
from .distributed import (  # noqa: F401
    initialize as initialize_distributed,
    host_local_batch_to_global, shard_range,
)
