"""The data-parallel train step with its collectives spelled out,
counterpart of `faceoff_tpu/train/shardmap_step.py`
(`make_shardmap_train_step`, under the JAX name so that a reader finds
it).

The JAX function maps the step over the 'data' axis of a mesh with
explicit `psum`s; here each `torch.distributed` process is one shard:

  * the forward and backward run on this process's clips;
  * the gradients and the metrics are averaged over the group (one
    all-reduce each, `parallel.collectives`);
  * the VQ statistics are summed inside the quantizers (the model is
    built with, or set to, the same `process_group`: the JAX model's
    `axis_name`), so every process takes the same EMA step;
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
    processes of `mesh` (every process by default) with `batch` this
    process's block. `process_group` None is the default (world) group;
    the model's quantizers are set to reduce over it, as the JAX function
    requires a model built with `axis_name=axis`."""
    if axis != "data":
        raise ValueError("only the 'data' axis shards a batch "
                         "(time-sharded compute is not built: ROADMAP.md)")
    mesh = make_mesh() if mesh is None else mesh
    if mesh.time != 1:
        raise ValueError("time-sharded compute is not built (ROADMAP.md)")
    if process_group is None:
        process_group = torch.distributed.group.WORLD
    for m in model.modules():
        if isinstance(m, EmaQuantizer):
            m.process_group = process_group
    return make_train_step(
        model, latent_loss_weight=latent_loss_weight,
        perceptual_loss_weight=perceptual_loss_weight, lpips=lpips,
        prepare_fn=prepare_fn, compute_dtype=compute_dtype,
        process_group=process_group)
