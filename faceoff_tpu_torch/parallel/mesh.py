"""The layout of the processes, counterpart of
`faceoff_tpu/parallel/mesh.py`.

The JAX package builds a ('data', 'time') mesh of every chip under one
process. Here a mesh is a layout of the `torch.distributed` processes,
one a GPU: `data` shards the clips of a batch (data parallelism, the only
strategy any JAX entry point builds), `time` is kept as a layout only.
No JAX entry point builds `time > 1` (every caller takes `make_mesh()`'s
defaults); compute over a clip sharded in time, with the halo exchange
its Conv3D postnets would need, is still to do (ROADMAP.md).

`shard_batch` and `stage_global` take this process's block of a global
batch, the counterpart of `jax.make_array_from_process_local_data`'s
view: process r of a data axis of size n holds clips [r*B/n, (r+1)*B/n).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from faceoff_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` x `time` processes; this process sits at (data_index,
    time_index), rank = data_index * time + time_index."""

    data: int
    time: int
    rank: int

    @property
    def size(self) -> int:
        return self.data * self.time

    @property
    def data_index(self) -> int:
        return self.rank // self.time

    @property
    def time_index(self) -> int:
        return self.rank % self.time


def make_mesh(data: int = -1, time: int = 1, *,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A (data, time) layout of the processes; data=-1 takes every
    process. The JAX function's errors: a world not divisible by `time`,
    a mesh larger than the world."""
    world = collectives.get_world_size() if world_size is None else world_size
    rank = collectives.get_rank() if rank is None else rank
    if data == -1:
        if world % time != 0:
            raise ValueError(f"{world} devices not divisible by time={time}")
        data = world // time
    n = data * time
    if n > world:
        raise ValueError(f"mesh {data}x{time} needs {n} devices, have {world}")
    return Mesh(data=data, time=time, rank=rank)


def batch_sharding(mesh: Mesh, time_axis: Optional[int] = None):
    """The slices of a (B, T, ...) array this process holds: axis 0 over
    `data`, and axis `time_axis` over `time` when given. Returns a
    function of the array."""
    def take(x: torch.Tensor) -> torch.Tensor:
        x = _block(x, 0, mesh.data, mesh.data_index)
        if time_axis is not None:
            x = _block(x, time_axis, mesh.time, mesh.time_index)
        return x

    return take


def replicated_sharding(mesh: Mesh):
    """Every process holds the whole array."""
    return lambda x: x


def _block(x: torch.Tensor, axis: int, parts: int, index: int):
    n = x.shape[axis]
    if n % parts != 0:
        raise ValueError(f"axis {axis} of size {n} does not split over "
                         f"{parts} processes")
    k = n // parts
    return x.narrow(axis, index * k, k)


def stage_global(x, sharding, device=None):
    """This process's block of the global value `x` under `sharding` (a
    function from `batch_sharding`), as a tensor on `device` when given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    t = sharding(t)
    return t.to(device) if device is not None else t


def shard_batch(batch: Dict, mesh: Mesh, device=None) -> Dict:
    """This process's block of every array of a global batch (the leading
    axis over `data`)."""
    sharding = batch_sharding(mesh)
    return {k: stage_global(v, sharding, device) for k, v in batch.items()}
