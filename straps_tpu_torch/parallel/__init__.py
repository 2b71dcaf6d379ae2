"""Data parallelism over processes (counterpart of `straps_tpu/parallel/`)."""

from straps_tpu_torch.parallel.mesh import (
    DataMesh, all_reduce_, all_reduce_sum, barrier, batch_rows, gather_batch,
    initialize_distributed, launch, make_mesh, replicate, requested_devices, shard_batch,
)

__all__ = ["DataMesh", "all_reduce_", "all_reduce_sum", "barrier", "batch_rows",
           "gather_batch", "initialize_distributed", "launch", "make_mesh", "replicate",
           "requested_devices", "shard_batch"]
