"""Meshes over ``torch.distributed`` ranks (port of
``torchrecsys_tpu/parallel``): :func:`init_distributed`, :func:`make_mesh`,
the state and batch shardings and the row-sharded embedding lookup."""

from torchrecsys_tpu_torch.parallel.distributed import (
    init_distributed,
    make_global_array,
    process_row_range,
    put_sharded,
)
from torchrecsys_tpu_torch.parallel.embedding import sharded_lookup, sharded_scatter_add
from torchrecsys_tpu_torch.parallel.mesh import Mesh, all_gather, make_mesh, psum
from torchrecsys_tpu_torch.parallel.sharding import (
    batch_sharding,
    gather_state,
    shard_state,
    state_shardings,
    table_sharding,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "all_gather",
    "psum",
    "shard_state",
    "gather_state",
    "state_shardings",
    "table_sharding",
    "batch_sharding",
    "init_distributed",
    "make_global_array",
    "process_row_range",
    "put_sharded",
    "sharded_lookup",
    "sharded_scatter_add",
]
