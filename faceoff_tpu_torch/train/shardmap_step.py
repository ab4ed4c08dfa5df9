"""The data x time parallel train step with its collectives spelled out,
counterpart of `faceoff_tpu/train/shardmap_step.py`
(`make_shardmap_train_step`, under the JAX name so that a reader finds
it) and of the JAX train step jitted over a mesh whose `time` axis shards
the frames (`tests/test_sharding.py`).

The JAX function maps the step over the 'data' axis of a mesh with
explicit `psum`s; here each `torch.distributed` process is one shard of
a `make_mesh(data=d, time=k)` layout, holding a block of clips and, with
k > 1, a block of their frames:

  * the forward and backward run on this process's block; with k > 1 the
    Conv3D postnets exchange a halo frame with their time neighbours
    before each layer (`collectives.halo_exchange`, over the time group
    of `collectives.mesh_groups`), where XLA's SPMD partitioner puts the
    JAX package's halo exchanges;
  * the gradients and the metrics are averaged over every process (one
    all-reduce each, `parallel.collectives`): the blocks are equal, so
    the mean of the blocks' means is the global mean;
  * the VQ statistics are summed inside the quantizers over every process
    (the model is built with, or set to, the same `process_group`: the
    JAX model's `axis_name`), so every process takes the same EMA step;
  * every process takes the same Adam update on the same averaged
    gradients, so the parameters stay identical.

The result is the one-process step on the global batch, up to the order
in which the sums add; with one process it is that step bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from faceoff_tpu_torch.models.vqvae import EmaQuantizer
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.parallel.mesh import Mesh, make_mesh
from faceoff_tpu_torch.train.train_step import make_train_step


def make_shardmap_train_step(
    model: nn.Module,
    mesh: Optional[Mesh] = None,
    *,
    axis: str = "data",
    latent_loss_weight: float = 1.0,
    perceptual_loss_weight: float = 1.0,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    process_group=None,
) -> Callable:
    """`train_step(state, batch, seed=0) -> (state, metrics)` over the
    processes of `mesh` (data parallel over every process by default),
    with `batch` this process's block: its clips, and with `mesh.time` > 1
    its frame block of them (`shard_batch(..., time_axis=1)`), or the raw
    batch a `prepare_fn` prepares its data group's clips from
    (`make_train_step`'s `mesh`). `axis` names the mesh axis over which
    the clips shard, 'data' as in the JAX function. `process_group`
    None is the default (world) group; the model's quantizers are set to
    reduce over it, as the JAX function requires a model built with
    `axis_name=axis`. With `mesh.time` > 1 every process must call this
    together (it builds the mesh's groups) and the model must be a
    `VQVAE`, which is set to that time group."""
    if axis != "data":
        raise ValueError(f"the clips shard over the mesh's 'data' axis, "
                         f"not {axis!r} (frames shard over 'time')")
    mesh = make_mesh() if mesh is None else mesh
    if mesh.size != collectives.get_world_size():
        raise ValueError(f"a {mesh.data}x{mesh.time} mesh over "
                         f"{collectives.get_world_size()} processes")
    if process_group is None:
        process_group = torch.distributed.group.WORLD
    for m in model.modules():
        if isinstance(m, EmaQuantizer):
            m.process_group = process_group
    if mesh.time > 1:
        if not hasattr(model, "set_time_group"):
            raise ValueError(f"{type(model).__name__} cannot shard its "
                             "frames (only the VQVAE's postnets exchange "
                             "halos)")
        time_group, _ = collectives.mesh_groups(mesh)
        model.set_time_group(time_group)
    return make_train_step(
        model, latent_loss_weight=latent_loss_weight,
        perceptual_loss_weight=perceptual_loss_weight, lpips=lpips,
        prepare_fn=prepare_fn, compute_dtype=compute_dtype,
        process_group=process_group, mesh=mesh)
