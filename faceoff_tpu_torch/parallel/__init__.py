"""Multi-process data parallelism over `torch.distributed`."""

from faceoff_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                    get_rank, get_world_size,
                                                    is_primary, synchronize)
from faceoff_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                             replicated_sharding,
                                             shard_batch, stage_global)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "stage_global",
    "get_world_size",
    "get_rank",
    "is_primary",
    "all_reduce_mean",
    "synchronize",
]
