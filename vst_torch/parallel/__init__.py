"""vst_torch.parallel — process groups, sharding helpers and the explicit
reductions of data-parallel training (vst's ``vst/parallel``)."""

from vst_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_gradients,
    all_reduce_metrics,
    batch_sharding,
    create_mesh,
    initialize_distributed,
    replicate,
    replicated_sharding,
    shard_batch,
    share_of_global,
)

__all__ = [
    "initialize_distributed",
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "Mesh",
    "share_of_global",
    "all_reduce_gradients",
    "all_reduce_metrics",
    "all_gather_rows",
]
