"""Multi-card training and serving over ``torch.distributed`` — counterpart
of ``flowhigh_tpu/parallel``: the ``data`` x ``model`` mesh of ranks and its
sharding rules (``mesh``), the multi-process entry point
(``distributed``), and the tensor-parallel Linears (``tensor``)."""

from .distributed import (initialize, local_batch_slice, make_global_mesh,
                          shard_global_batch)
from .mesh import (batch_sharding, make_mesh, param_shardings,
                   replicated_sharding, shard_batch)

__all__ = [
    "make_mesh", "batch_sharding", "replicated_sharding", "param_shardings",
    "shard_batch", "initialize", "make_global_mesh", "local_batch_slice",
    "shard_global_batch",
]
