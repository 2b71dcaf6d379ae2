"""Data parallelism over processes (counterpart of `straps_tpu/parallel/`).

`JAX_COUNTERPARTS` maps each name of `straps_tpu.parallel.__all__` to its
counterparts here, or to why there is none: a rank is a process, and the
collectives that XLA's partitioner inserts over the JAX mesh are the
`DataMesh`'s (`mesh.py`).
"""

from straps_tpu_torch.parallel.mesh import (
    DataMesh, all_reduce_, all_reduce_sum, barrier, batch_rows, gather_batch,
    initialize_distributed, launch, make_mesh, replicate, requested_devices, shard_batch,
)

__all__ = ["DataMesh", "all_reduce_", "all_reduce_sum", "barrier", "batch_rows",
           "gather_batch", "initialize_distributed", "launch", "make_mesh", "replicate",
           "requested_devices", "shard_batch"]

JAX_COUNTERPARTS = {
    "DATA_AXIS": "the name of the JAX mesh's batch axis; a torch process group has no "
                 "named axes",
    "initialize_distributed": ("initialize_distributed", "launch", "requested_devices"),
    "make_mesh": ("make_mesh", "DataMesh", "all_reduce_", "all_reduce_sum", "barrier",
                  "gather_batch"),
    "batch_sharding": "a `NamedSharding` for `jax.device_put`; each rank holds its rows "
                      "itself (`shard_batch`, `batch_rows`)",
    "replicated_sharding": "a `NamedSharding` for `jax.device_put`; `replicate` copies "
                           "rank 0's tensors to every rank",
    "shard_batch": ("shard_batch", "batch_rows"),
    "replicate": ("replicate",),
}
