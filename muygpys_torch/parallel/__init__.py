"""Sharding over a ``torch.distributed`` world: the counterpart of
:mod:`muygpys_tpu.parallel`, with its fifteen names."""

from muygpys_torch.parallel.knn import sharded_knn
from muygpys_torch.parallel.mesh import (
    initialize_distributed,
    local_chunk_slice,
    make_hybrid_mesh,
    make_mesh,
)
from muygpys_torch.parallel.sharding import (
    batch_spec,
    even_batch,
    gather_global,
    replicate,
    shard,
    shard_batch,
    shard_batch_global,
    shard_ragged_global,
    shard_global,
    shard_ragged,
)

__all__ = [
    "batch_spec",
    "even_batch",
    "gather_global",
    "initialize_distributed",
    "local_chunk_slice",
    "make_hybrid_mesh",
    "make_mesh",
    "replicate",
    "shard",
    "sharded_knn",
    "shard_batch",
    "shard_batch_global",
    "shard_ragged_global",
    "shard_global",
    "shard_ragged",
]
