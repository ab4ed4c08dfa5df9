"""Train and eval steps of the perceptual trainer, counterpart of
`faceoff_tpu/train/train_step.py`.

One optimizer step: (optionally) the training input is prepared on the
device from a raw batch, the VQVAE runs forward in training mode (both
EMA codebooks take their step there), the loss is
MSE + latent_loss_weight * latent + perceptual_loss_weight * LPIPS, the
backward runs and Adam updates the parameters with the scheduled lr and
b1.

Batch contract (float32, channels-last, values in [-1, 1]):
  input: (B, T, H, W, 6), source-face composite || target background
  gt:    (B, T, H, W, 3), the frames to reconstruct
or, with a `prepare_fn`, a raw {"frames", "landmarks"} batch.

The step's randomness comes from a generator on the model's device seeded
from the base seed and the step count (`step_seed`), the counterpart of
`jax.random.fold_in(key, state.step)`. On CUDA the forward runs in bf16
under `torch.autocast` unless another `compute_dtype` is named, as the JAX
trainer computes in bf16 on its accelerator; parameters, Adam state, the
VQ statistics and the losses stay float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.losses import mse_loss
from faceoff_tpu_torch.ops import video as video_ops
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.parallel.mesh import Mesh, frame_block, make_mesh
from faceoff_tpu_torch.train.state import TrainState

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed for step `step` of a run seeded `seed` (SplitMix64 of
    the pair), so that neighbouring steps and seeds draw unrelated
    streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rank_seed(seed: int, rank: int) -> int:
    """The seed of stream `rank` (a process's, or a data group's over a
    time-sharded mesh): 0 keeps `seed` (a one-process run's stream),
    r > 0 a stream derived from it, so that processes sampling their own
    clips draw different ones."""
    return seed if rank == 0 else step_seed(seed, (1 << 40) + rank)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return torch.autocast(device.type, dtype=compute_dtype,
                          enabled=compute_dtype != torch.float32)


def make_train_step(
    model: nn.Module,
    *,
    latent_loss_weight: float = 1.0,
    perceptual_loss_weight: float = 1.0,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    process_group=None,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Build `train_step(state, batch, seed=0) -> (state, metrics)`.

    lpips: a frozen `models.lpips.LPIPS`, or None for no perceptual term.
    Its input standardisation and per-tap head run in its own dtype
    whatever the autocast (its convolutions follow the autocast): `init_lpips`
    builds it in bf16 on CUDA and float32 on the CPU, as the JAX trainer
    builds its LPIPS, so it matches the default compute dtype; a float32
    step on CUDA wants `init_lpips(dtype=torch.float32)`.
    prepare_fn: `(generator, frames, landmarks) -> batch` run on the raw
    batch first (`data.resident.make_resident_prepare`,
    `data.device_pipeline.prepare_train_batch`).
    compute_dtype: the autocast dtype; None is bf16 on CUDA and float32
    (no autocast) on the CPU.
    process_group: a torch.distributed group over which the step is one
    data-parallel step (`train.shardmap_step.make_shardmap_train_step`):
    the batch is this process's block, the gradients and the metrics are
    averaged over the group before Adam, and a prepare function draws
    from this process's own stream (`rank_seed`). The
    model's quantizers must reduce over the same group.
    mesh: the group's data x time layout (`make_mesh()`, data parallel
    over every process, by default). With `time` > 1 a prepare function
    draws from its data group's stream (`rank_seed(seed, data_index)`),
    so that the processes of a time group prepare the same clips, and the
    step keeps this process's frame block of them (`frame_block`); a
    batch without a prepare function must already be that block. Equal
    blocks make the averaged MSE, latent and LPIPS terms the global ones.

    metrics hold 0-d float32 tensors: "loss", "mse", "latent" and
    "perceptual" on the model's device, so reading them is the caller's
    sync, and "lr" on the host.
    """
    device = _device_of(model)
    if mesh is None:
        mesh = (make_mesh() if process_group is not None
                else make_mesh(world_size=1, rank=0))
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int = 0) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if prepare_fn is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(step_seed(rank_seed(seed, mesh.data_index),
                                      state.step))
            with torch.no_grad():
                batch = prepare_fn(gen, batch["frames"], batch["landmarks"])
            if mesh.time > 1:
                batch = {k: frame_block(v, mesh) for k, v in batch.items()}
        with _autocast(device, compute_dtype):
            dec, latent = model(batch["input"], train=True)
            out = dec[..., :3]
            gt = batch["gt"]
            recon = mse_loss(out, gt)
            if lpips is not None:
                perceptual = lpips(video_ops.fold_time(gt),
                                   video_ops.fold_time(out)).to(torch.float32)
            else:
                perceptual = torch.zeros((), device=device)
            loss = (recon + latent_loss_weight * latent
                    + perceptual_loss_weight * perceptual)
        state.optimizer.zero_grad()
        loss.backward()
        metrics = {
            "loss": loss.detach(),
            "mse": recon.detach(),
            "latent": latent.detach(),
            "perceptual": perceptual.detach(),
        }
        if process_group is not None:
            collectives.all_reduce_gradients(params, process_group)
            metrics = collectives.all_reduce_metrics(metrics, process_group)
        state.apply_gradients()
        metrics["lr"] = torch.tensor(state.optimizer.lr, dtype=torch.float32)
        return state, metrics

    return train_step


def make_multi_step(
    model: nn.Module,
    steps_per_call: int,
    *,
    latent_loss_weight: float = 1.0,
    perceptual_loss_weight: float = 1.0,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    scan_batches: bool = True,
    process_group=None,
) -> Callable:
    """`multi_step(state, batches, seed=0) -> (state, metrics)`: K =
    steps_per_call optimizer steps in one call, the counterpart of the JAX
    package's `lax.scan` over the step; here a Python loop of
    `make_train_step`'s step, each seeded from (seed, its own step count),
    so K steps in one call are K single calls.

    batches carry a leading K axis of distinct micro-batches; with
    scan_batches=False every step takes the same batch (the resident
    corpus, from which prepare_fn samples fresh clips each step). Returns
    the last step's metrics and "loss_mean" over the K steps.
    """
    step = make_train_step(
        model, latent_loss_weight=latent_loss_weight,
        perceptual_loss_weight=perceptual_loss_weight, lpips=lpips,
        prepare_fn=prepare_fn, compute_dtype=compute_dtype,
        process_group=process_group)

    def multi_step(state: TrainState, batches: Dict[str, torch.Tensor],
                   seed: int = 0) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        losses = []
        for k in range(steps_per_call):
            batch = ({key: v[k] for key, v in batches.items()}
                     if scan_batches else batches)
            state, metrics = step(state, batch, seed)
            losses.append(metrics["loss"])
        metrics = dict(metrics)
        metrics["loss_mean"] = torch.stack(losses).mean()
        return state, metrics

    return multi_step


def make_eval_step(model: nn.Module,
                   compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """`eval_step(state, batch) -> (reconstruction (B,T,H,W,3), metrics)`:
    the forward without touching the codebooks."""
    device = _device_of(model)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with _autocast(device, compute_dtype):
            dec, latent = model(batch["input"], train=False)
            out = dec[..., :3]
            metrics = {"mse": mse_loss(out, batch["gt"]),
                       "latent": latent.detach()}
        return out, metrics

    return eval_step
