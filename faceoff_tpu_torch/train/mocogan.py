"""The GAN stage's MoCoGAN recipe, counterpart of
`faceoff_tpu/train/mocogan.py`: every step updates, in order, the patch
image discriminator, the patch video discriminator and the generator,
all with BCE-with-logits objectives:

  gen loss  = recon + latent + 0.5 BCE(D_img(fake), 1)
              + 0.5 BCE(D_vid(fake), 1) [+ perceptual_w * LPIPS]
  disc loss = BCE(D(real), 1) + BCE(D(fake), 0)

The discriminators' BatchNorm runs in training mode in their own updates
(batch statistics, running averages updated with Flax's rule, real batch
then fake) and on its running averages in the generator's. The
reconstruction the discriminators see is made without a graph and
without the EMA update; the generator's own forward then takes the EMA
step, as the JAX step keeps only the second forward's codebooks.

Input noise (discriminators built with use_noise): one generator for
each of the six discriminator applications, seeded from the step.

Across processes (`process_group`, with the discriminators' BatchNorm
set to the same group: `models.discriminators.set_process_group`) the
step is one step on the global batch: BatchNorm normalises with the
global batch's statistics, every gradient and metric is averaged over
the group, and each process draws its own input and noise streams.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from faceoff_tpu_torch.losses import bce_logits_loss, mse_loss
from faceoff_tpu_torch.models.discriminators import Noise
from faceoff_tpu_torch.ops import video as video_ops
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.train.gan import (cudnn_deterministic,
                                         make_disc_optimizer, prepare,
                                         reduced_metrics, reduced_update,
                                         step_parameters)
from faceoff_tpu_torch.train.state import TrainState
from faceoff_tpu_torch.train.train_step import (_autocast, _device_of,
                                                rank_seed, step_seed)


@dataclasses.dataclass
class MocoganState:
    gen: TrainState
    d_img: nn.Module
    d_img_opt: torch.optim.Optimizer
    d_vid: nn.Module
    d_vid_opt: torch.optim.Optimizer


def create_mocogan_state(gen_state: TrainState, d_img: nn.Module,
                         d_vid: nn.Module, *, disc_lr: float = 3e-4
                         ) -> MocoganState:
    return MocoganState(gen=gen_state, d_img=d_img,
                        d_img_opt=make_disc_optimizer(d_img, disc_lr),
                        d_vid=d_vid, d_vid_opt=make_disc_optimizer(d_vid, disc_lr))


def _bce_pair(real_logits, fake_logits) -> torch.Tensor:
    return bce_logits_loss(real_logits, True) + bce_logits_loss(fake_logits,
                                                                False)


def make_mocogan_step(
    model: nn.Module,
    d_img: nn.Module,
    d_vid: nn.Module,
    *,
    latent_loss_weight: float = 1.0,
    image_disc_weight: float = 0.5,
    video_disc_weight: float = 0.5,
    perceptual_loss_weight: float = 0.0,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    process_group=None,
) -> Callable:
    """`step(state, batch, seed=0) -> (state, metrics)`: both
    discriminator updates, then the generator's. The step's generators
    are seeded from (seed, the generator's step count): one for the input
    pipeline and, with noise layers, one for each of the six
    discriminator applications (image real, image fake, video real,
    video fake, then the generator's image and video)."""
    device = _device_of(model)
    gen_params = step_parameters(model)
    group = process_group
    rank = collectives.get_rank() if group is not None else 0
    use_noise = bool(getattr(d_img, "use_noise", False)
                     or getattr(d_vid, "use_noise", False))

    def noise_sources(s: int) -> Sequence[Noise]:
        if not use_noise:
            return [None] * 6
        return [torch.Generator(device=device).manual_seed(step_seed(s, i))
                for i in range(1, 7)]

    @cudnn_deterministic
    def step(state: MocoganState, batch: Dict[str, torch.Tensor],
             seed: int = 0):
        s = rank_seed(step_seed(seed, state.gen.step), rank)
        batch = prepare(prepare_fn, torch.Generator(device=device)
                        .manual_seed(s), batch)
        nk = noise_sources(s)
        gt = batch["gt"]
        with torch.no_grad(), _autocast(device, compute_dtype):
            dec, _ = model(batch["input"], train=True,
                           update_codebooks=False)
        out_sg = dec[..., :3]
        real_frames = video_ops.fold_time(gt)
        metrics = {}
        for name, disc, opt, real, fake, k in (
                ("d_img_loss", d_img, state.d_img_opt, real_frames,
                 video_ops.fold_time(out_sg), 0),
                ("d_vid_loss", d_vid, state.d_vid_opt, gt, out_sg, 2)):
            loss = _bce_pair(disc(real, train=True, noise=nk[k]),
                             disc(fake, train=True, noise=nk[k + 1]))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            reduced_update(opt, disc.parameters(), group)
            metrics[name] = loss.detach()

        with _autocast(device, compute_dtype):
            dec, latent = model(batch["input"], train=True)
            out = dec[..., :3]
            recon = mse_loss(out, gt)
            fake_frames = video_ops.fold_time(out)
            if lpips is not None and perceptual_loss_weight > 0:
                perceptual = lpips(real_frames, fake_frames).to(torch.float32)
            else:
                perceptual = torch.zeros((), device=device)
        g_img = bce_logits_loss(d_img(fake_frames, train=False, noise=nk[4]),
                                True)
        g_vid = bce_logits_loss(d_vid(out, train=False, noise=nk[5]), True)
        loss = (recon + latent_loss_weight * latent
                + perceptual_loss_weight * perceptual
                + image_disc_weight * g_img + video_disc_weight * g_vid)
        state.gen.optimizer.zero_grad()
        loss.backward(inputs=gen_params)
        if group is not None:
            collectives.all_reduce_gradients(gen_params, group)
        state.gen.apply_gradients()
        metrics.update({"g_loss": loss, "mse": recon, "latent": latent,
                        "g_img": g_img, "g_vid": g_vid,
                        "perceptual": perceptual})
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, reduced_metrics(metrics, group)

    return step
