"""Multi-process data and time parallelism over `torch.distributed`."""

from faceoff_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                    get_rank, get_world_size,
                                                    halo_exchange,
                                                    is_primary, mesh_groups,
                                                    synchronize)
from faceoff_tpu_torch.parallel.mesh import (batch_sharding, frame_block,
                                             make_mesh, replicated_sharding,
                                             shard_batch, stage_global)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "frame_block",
    "replicated_sharding",
    "shard_batch",
    "stage_global",
    "get_world_size",
    "get_rank",
    "is_primary",
    "all_reduce_mean",
    "mesh_groups",
    "halo_exchange",
    "synchronize",
]
