"""The GAN stage's VQGAN recipe, counterpart of `faceoff_tpu/train/vqgan.py`:
a PatchGAN (`NLayerDiscriminator`) and the adaptive discriminator weight.

  * generator loss = nll (recon + perceptual_w * LPIPS) + latent_w * latent
    + d_weight * disc_factor * g_adv, where g_adv = mean|D(fake) - 1| and
    d_weight = clip(||d nll / d last|| / (||d g_adv / d last|| + 1e-4),
    0, 1e4) * disc_weight over the parameters (kernel and bias) of the
    decoder's last transposed convolution;
  * disc_factor gates the adversarial terms until the generator has taken
    `disc_start` steps;
  * discriminator: L1 to the 0/1 targets (the default), hinge or vanilla.

The discriminator always runs on its running averages (the JAX step
applies it with train=False), so its BatchNorm keeps its initial
statistics. The JAX step takes the two norms from two more forwards; here
one forward serves all three: the two gradients with respect to the last
layer come from `torch.autograd.grad` on the retained graph, then the
loss's backward; the codebooks take their EMA step once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from faceoff_tpu_torch.losses import hinge_d_loss, mse_loss, vanilla_d_loss
from faceoff_tpu_torch.ops import video as video_ops
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.train.gan import (DISC_TAG, GEN_TAG,
                                         cudnn_deterministic,
                                         make_disc_optimizer, prepare,
                                         reduced_metrics, reduced_update,
                                         step_parameters, tagged_generators)
from faceoff_tpu_torch.train.state import TrainState
from faceoff_tpu_torch.train.train_step import _autocast, _device_of


def find_last_layer_path(model: nn.Module) -> str:
    """The name of the decoder's last transposed convolution, the layer
    that produces the output image (`dec.blocks.N`)."""
    last = None
    for name, m in model.dec.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            last = name
    if last is None:
        raise ValueError("no ConvTranspose2d in the decoder")
    return f"dec.{last}"


def _l1(pred: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))


@dataclasses.dataclass
class VQGANState:
    gen: TrainState
    disc: nn.Module
    disc_opt: torch.optim.Optimizer


def create_vqgan_state(gen_state: TrainState, disc: nn.Module, *,
                       disc_lr: float = 3e-4) -> VQGANState:
    """Adam (b1 0.5, b2 0.9) for the discriminator."""
    return VQGANState(gen=gen_state, disc=disc,
                      disc_opt=make_disc_optimizer(disc, disc_lr, 0.5, 0.9))


def make_vqgan_steps(
    model: nn.Module,
    disc: nn.Module,
    *,
    disc_start: int = 0,
    disc_factor: float = 1.0,
    disc_weight: float = 0.8,
    disc_loss: str = "l1",
    latent_loss_weight: float = 1.0,
    perceptual_loss_weight: float = 1.0,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    process_group=None,
):
    """Build (gen_step, disc_step), each `(state, batch, seed=0) -> (state,
    metrics)`; with a prepare function each step prepares its own batch
    from a generator seeded by (seed, its tag, the generator's step).
    Across processes (`process_group`) every gradient and metric is
    averaged over the group, the adaptive weight's two last-layer
    gradients included (the global batch's, as under the JAX jit), and
    each process prepares its own clips."""
    device = _device_of(model)
    group = process_group
    rank = collectives.get_rank() if group is not None else 0
    gen_params = step_parameters(model)
    last = model.get_submodule(find_last_layer_path(model))
    last_params = [last.weight, last.bias]

    def nll_of(out, gt):
        recon = mse_loss(out, gt)
        if lpips is not None:
            perceptual = lpips(video_ops.fold_time(gt),
                               video_ops.fold_time(out)).to(torch.float32)
        else:
            perceptual = torch.zeros((), device=device)
        return recon, perceptual

    def factor(state) -> float:
        return disc_factor if state.gen.step >= disc_start else 0.0

    @cudnn_deterministic
    def gen_step(state: VQGANState, batch: Dict[str, torch.Tensor],
                 seed: int = 0):
        pipeline, _ = tagged_generators(device, seed, GEN_TAG, state.gen.step,
                                        rank)
        batch = prepare(prepare_fn, pipeline, batch)
        with _autocast(device, compute_dtype):
            dec, latent = model(batch["input"], train=True)
            out = dec[..., :3]
            recon, perceptual = nll_of(out, batch["gt"])
        logits = disc(video_ops.fold_time(out), train=False)
        g_adv = _l1(logits, 1.0)
        nll = recon + perceptual_loss_weight * perceptual
        nll_grads = torch.autograd.grad(nll, last_params, retain_graph=True)
        g_grads = torch.autograd.grad(g_adv, last_params, retain_graph=True)
        if group is not None:
            nll_grads = [collectives.all_reduce_mean(g, group)
                         for g in nll_grads]
            g_grads = [collectives.all_reduce_mean(g, group) for g in g_grads]
        d_weight = torch.clamp(_norm(nll_grads) / (_norm(g_grads) + 1e-4),
                               0.0, 1e4).detach() * disc_weight
        loss = (recon + latent_loss_weight * latent
                + perceptual_loss_weight * perceptual
                + d_weight * factor(state) * g_adv)
        state.gen.optimizer.zero_grad()
        loss.backward(inputs=gen_params)
        if group is not None:
            collectives.all_reduce_gradients(gen_params, group)
        state.gen.apply_gradients()
        metrics = {"g_loss": loss, "mse": recon, "latent": latent,
                   "perceptual": perceptual, "d_weight": d_weight,
                   "g_adv": g_adv}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, reduced_metrics(metrics, group)

    @cudnn_deterministic
    def disc_step(state: VQGANState, batch: Dict[str, torch.Tensor],
                  seed: int = 0):
        pipeline, _ = tagged_generators(device, seed, DISC_TAG,
                                        state.gen.step, rank)
        batch = prepare(prepare_fn, pipeline, batch)
        with torch.no_grad(), _autocast(device, compute_dtype):
            dec, _ = model(batch["input"], train=True,
                           update_codebooks=False)
        fake = video_ops.fold_time(dec[..., :3])
        real = video_ops.fold_time(batch["gt"])
        logits_real = disc(real, train=False)
        logits_fake = disc(fake, train=False)
        if disc_loss == "hinge":
            d = hinge_d_loss(logits_real, logits_fake)
        elif disc_loss == "vanilla":
            d = vanilla_d_loss(logits_real, logits_fake)
        else:  # L1 to the targets
            d = _l1(logits_real, 1.0) + _l1(logits_fake, 0.0)
        loss = factor(state) * d
        state.disc_opt.zero_grad(set_to_none=True)
        loss.backward()
        reduced_update(state.disc_opt, disc.parameters(), group)
        return state, reduced_metrics({"d_loss": loss.detach()}, group)

    return gen_step, disc_step
