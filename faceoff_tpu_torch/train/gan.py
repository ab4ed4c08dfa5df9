"""The GAN fine-tuning stage's MoCoGAN-HD recipe, counterpart of
`faceoff_tpu/train/gan.py`: alternating generator and discriminator
steps with explicit parameter partitions.

  * gen_step: loss = recon + latent_w * latent [+ perceptual_w * LPIPS]
    + adv_scale * (0.25 RaLSGAN_2d + 0.25 RaLSGAN_3d); Adam on the
    generator's parameters, the EMA step on its codebooks.
  * disc_step: RaLSGAN for both discriminators on a reconstruction made
    without a graph; Adam (b1 0.5, b2 0.999) on each discriminator.

The 2D content discriminator sees channel-concatenated (frame0 || frame_k)
pairs of a `sample_frames` window of the clip, the 3D motion
discriminator (frame0 || frame_t) stacks over the window, both halves of
a whole-clip horizontal flip.

Randomness: each step seeds two generators from (seed, stream tag, the
generator's step count), tag 0 for the gen step and 1 for the disc step,
as the JAX steps fold (tag, step) into their key: one on the model's
device for the input pipeline, one on the CPU for the window start, the
pair's frame and the flip (`rand_bits`), which a caller may also pass
(`bits=`). Resuming therefore needs no saved generator state.

Across `torch.distributed` processes (`process_group`) each step is one
data-parallel step on the global batch, as the JAX steps under jit over
a sharded batch: the input pipeline draws from each process's own
stream (`train_step.rank_seed`) while the window, pair frame and flip
are shared; the RaLSGAN batch means are the global batch's; both the
generator's and the discriminators' gradients, and the metrics, are
averaged over the group; the model's quantizers sum their statistics
over it.

Every step runs with cuDNN's deterministic algorithms
(`cudnn_deterministic`), so that a run repeats and resumes bit for bit.
The generator's forward computes in bf16 on CUDA (`compute_dtype`, as
`train_step.make_train_step`); the discriminators take its float32
output outside the autocast and compute in float32, as the JAX
discriminators, which have no dtype, do. The disc step's generator
forward runs in training mode without a graph and without the EMA
update (`update_codebooks=False`): the JAX disc step runs the training
forward and drops its codebook update, so the codebooks move only in the
gen step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from faceoff_tpu_torch.losses import mse_loss, relativistic_average_lsgan
from faceoff_tpu_torch.ops import video as video_ops
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.train.state import TrainState
from faceoff_tpu_torch.train.train_step import (_autocast, _device_of,
                                                rank_seed, step_seed)

GEN_TAG, DISC_TAG = 0, 1

Bits = Tuple[int, int, bool]


@dataclasses.dataclass
class GANTrainState:
    """The generator's train state and two discriminators, each with its
    own Adam (b1 0.5, b2 0.999). Modules and optimizers update in
    place."""

    gen: TrainState
    d_img: nn.Module
    d_img_opt: torch.optim.Optimizer
    d_3d: nn.Module
    d_3d_opt: torch.optim.Optimizer


def make_disc_optimizer(disc: nn.Module, lr: float = 3e-4, b1: float = 0.5,
                        b2: float = 0.999) -> torch.optim.Adam:
    """optax.adam(lr, b1, b2) for a discriminator (eps 1e-8 outside the
    square root, as optax)."""
    return torch.optim.Adam(disc.parameters(), lr=lr, betas=(b1, b2),
                            eps=1e-8)


def create_gan_state(gen_state: TrainState, d_img: nn.Module,
                     d_3d: nn.Module, *, disc_lr: float = 3e-4
                     ) -> GANTrainState:
    return GANTrainState(gen=gen_state, d_img=d_img,
                         d_img_opt=make_disc_optimizer(d_img, disc_lr),
                         d_3d=d_3d, d_3d_opt=make_disc_optimizer(d_3d, disc_lr))


def tagged_generators(device: torch.device, seed: int, tag: int, step: int,
                      rank: int = 0
                      ) -> Tuple[torch.Generator, torch.Generator]:
    """(a generator on `device` for the input pipeline, a CPU generator
    for the step's scalar draws) of stream `tag` at generator step
    `step`; process `rank` of several prepares its own clips from its
    own pipeline stream, the scalar draws are every process's."""
    s = step_seed(step_seed(seed, tag), step)
    pipeline = torch.Generator(device=device).manual_seed(
        rank_seed(s, rank))
    scalars = torch.Generator().manual_seed(step_seed(s, 0))
    return pipeline, scalars


def rand_bits(generator: torch.Generator, t: int, sample_frames: int) -> Bits:
    """(window start in [0, t - sample_frames], pair frame in
    [1, sample_frames), flip with probability 1/2)."""
    start = int(torch.randint(0, t - sample_frames + 1, (), generator=generator))
    frame_id = int(torch.randint(1, sample_frames, (), generator=generator))
    flip = bool(torch.rand((), generator=generator) < 0.5)
    return start, frame_id, flip


def _sample_window(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """An n-frame window of (B, T, H, W, C)."""
    return x[:, start:start + n]


def _frame_pair(x: torch.Tensor, frame_id: int) -> torch.Tensor:
    """(frame0 || frame_id) channel concat: (B, H, W, 2C)."""
    return torch.cat([x[:, 0], x[:, frame_id]], dim=-1)


def _pair_stack(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T-1, H, W, 2C): frame0 beside each later
    frame."""
    f0 = x[:, :1].expand(-1, x.shape[1] - 1, -1, -1, -1)
    return torch.cat([f0, x[:, 1:]], dim=-1)


def _maybe_flip(x: torch.Tensor, do_flip: bool) -> torch.Tensor:
    """A whole-clip horizontal flip (width is axis -2)."""
    return torch.flip(x, dims=(-2,)) if do_flip else x


def ralsgan_pair(d_a, d_b, process_group=None) -> torch.Tensor:
    """0.5 (RaLSGAN(a, b, real) + RaLSGAN(b, a, fake)): the generator's
    objective with a = fake, b = real, the discriminator's with a = real,
    b = fake."""
    return 0.5 * (relativistic_average_lsgan(d_a, d_b, True, process_group)
                  + relativistic_average_lsgan(d_b, d_a, False,
                                               process_group))


def reduced_update(optimizer, params, group) -> None:
    """optimizer.step() on the gradients averaged over `group` (None: as
    they are)."""
    if group is not None:
        collectives.all_reduce_gradients(params, group)
    optimizer.step()


def prepare(prepare_fn: Optional[Callable], generator: torch.Generator,
            batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The training input of a raw {"frames", "landmarks"} batch when there
    is a prepare function, else the batch as it is."""
    if prepare_fn is not None and "frames" in batch:
        with torch.no_grad():
            return prepare_fn(generator, batch["frames"], batch["landmarks"])
    return batch


def step_parameters(module: nn.Module):
    return [p for p in module.parameters() if p.requires_grad]


def cudnn_deterministic(fn: Callable) -> Callable:
    """`fn` run with cuDNN's deterministic algorithms. At the GAN stage's
    shapes (batch 1, 3D discriminators) cuDNN's default choices add in an
    order that varies from run to run, so a run would neither repeat nor
    resume bit for bit (ROADMAP.md, Queue 3); the other cuDNN settings stay as
    the caller has them."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = before

    return wrapped


def make_gan_steps(
    model: nn.Module,
    d_img: nn.Module,
    d_3d: nn.Module,
    *,
    sample_frames: int = 16,
    latent_loss_weight: float = 1.0,
    perceptual_loss_weight: float = 0.0,
    g_2d_weight: float = 0.25,
    g_3d_weight: float = 0.25,
    lpips: Optional[nn.Module] = None,
    prepare_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    process_group=None,
):
    """Build (gen_step, disc_step).

    gen_step(state, batch, seed=0, adv_scale=1.0, bits=None) and
    disc_step(state, batch, seed=0, bits=None) -> (state, metrics).
    adv_scale multiplies the adversarial terms (0 during a discriminator
    warm-up, `adv_scale_schedule`). lpips with perceptual_loss_weight > 0
    is the perceptual variant. prepare_fn: as in `make_train_step`; each
    step prepares its own batch. Metrics are 0-d tensors on the device.
    process_group: see the module's docstring (the model and the
    discriminators must be set to the same group).
    """
    device = _device_of(model)
    gen_params = step_parameters(model)
    group = process_group
    rank = collectives.get_rank() if group is not None else 0

    def draws(state, batch, seed, tag, bits):
        pipeline, scalars = tagged_generators(device, seed, tag,
                                              state.gen.step, rank)
        batch = prepare(prepare_fn, pipeline, batch)
        if bits is None:
            bits = rand_bits(scalars, batch["gt"].shape[1], sample_frames)
        return batch, bits

    @cudnn_deterministic
    def gen_step(state: GANTrainState, batch: Dict[str, torch.Tensor],
                 seed: int = 0, adv_scale: float = 1.0,
                 bits: Optional[Bits] = None):
        batch, (start, frame_id, flip) = draws(state, batch, seed, GEN_TAG,
                                               bits)
        gt = batch["gt"]
        with _autocast(device, compute_dtype):
            dec, latent = model(batch["input"], train=True)
            out = dec[..., :3]
            recon = mse_loss(out, gt)
            if lpips is not None and perceptual_loss_weight > 0:
                perceptual = lpips(video_ops.fold_time(gt),
                                   video_ops.fold_time(out)).to(torch.float32)
            else:
                perceptual = torch.zeros((), device=device)
        x_fake = _sample_window(out, start, sample_frames)
        x_real = _sample_window(gt, start, sample_frames)
        g_2d = ralsgan_pair(d_img(_frame_pair(x_fake, frame_id)),
                            d_img(_frame_pair(x_real, frame_id)), group)
        g_3d = ralsgan_pair(d_3d(_maybe_flip(_pair_stack(x_fake), flip)),
                            d_3d(_maybe_flip(_pair_stack(x_real), flip)),
                            group)
        loss = (recon + latent_loss_weight * latent
                + perceptual_loss_weight * perceptual
                + adv_scale * g_2d_weight * g_2d
                + adv_scale * g_3d_weight * g_3d)
        state.gen.optimizer.zero_grad()
        # the generator's gradients only: no weight gradient of either
        # discriminator is computed
        loss.backward(inputs=gen_params)
        if group is not None:
            collectives.all_reduce_gradients(gen_params, group)
        state.gen.apply_gradients()
        metrics = {"g_loss": loss, "mse": recon, "latent": latent,
                   "g_2d": g_2d, "g_3d": g_3d, "perceptual": perceptual}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, reduced_metrics(metrics, group)

    @cudnn_deterministic
    def disc_step(state: GANTrainState, batch: Dict[str, torch.Tensor],
                  seed: int = 0, bits: Optional[Bits] = None):
        batch, (start, frame_id, flip) = draws(state, batch, seed, DISC_TAG,
                                               bits)
        with torch.no_grad(), _autocast(device, compute_dtype):
            dec, _ = model(batch["input"], train=True,
                           update_codebooks=False)
        out = dec[..., :3]
        x_fake = _sample_window(out, start, sample_frames)
        x_real = _sample_window(batch["gt"], start, sample_frames)

        metrics = {}
        for name, disc, opt, inputs in (
                ("d_3d_loss", d_3d, state.d_3d_opt,
                 lambda x: _maybe_flip(_pair_stack(x), flip)),
                ("d_img_loss", d_img, state.d_img_opt,
                 lambda x: _frame_pair(x, frame_id))):
            loss = ralsgan_pair(disc(inputs(x_real)), disc(inputs(x_fake)),
                                group)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            reduced_update(opt, disc.parameters(), group)
            metrics[name] = loss.detach()
        return state, reduced_metrics(metrics, group)

    return gen_step, disc_step


def reduced_metrics(metrics, group):
    return (metrics if group is None
            else collectives.all_reduce_metrics(metrics, group))


def adv_scale_schedule(step: int, start: int = 0, ramp: int = 0) -> float:
    """The adversarial terms' multiplier at absolute run step `step`: 0
    through `start` warm-up steps, then a linear ramp over `ramp` steps
    to 1 (a hard switch when ramp = 0). Absolute, so a resumed run
    continues the warm-up and ramp where they stopped."""
    rel = step - start
    if rel < 0:
        return 0.0
    if ramp <= 0:
        return 1.0
    return min(1.0, (rel + 1) / ramp)


def make_gan_multi_step(
    model: nn.Module,
    d_img: nn.Module,
    d_3d: nn.Module,
    steps_per_call: int,
    **step_kwargs,
) -> Callable:
    """`multi_step(state, batches, seed=0, adv_scale=1.0) -> (state,
    metrics)`: K = steps_per_call alternating gen/disc steps in one call,
    the counterpart of the JAX package's `lax.scan` over (gen, disc)
    pairs; here a loop of `make_gan_steps`'s steps, so K steps in one call
    are K/2 single pairs. K must be even. batches carry a leading K axis
    (micro-batch i feeds step i: even gen, odd disc). metrics are
    {"gen": ..., "disc": ...}, each metric stacked over the K/2 pairs."""
    if steps_per_call % 2 != 0:
        raise ValueError("steps_per_call must be even (gen/disc pairs)")
    gen_step, disc_step = make_gan_steps(model, d_img, d_3d, **step_kwargs)

    def multi_step(state: GANTrainState, batches: Dict[str, torch.Tensor],
                   seed: int = 0, adv_scale: float = 1.0):
        seq = {"gen": [], "disc": []}
        for i in range(steps_per_call):
            batch = {k: v[i] for k, v in batches.items()}
            if i % 2 == 0:
                state, m = gen_step(state, batch, seed, adv_scale)
                seq["gen"].append(m)
            else:
                state, m = disc_step(state, batch, seed)
                seq["disc"].append(m)
        return state, {part: {k: torch.stack([m[k] for m in ms])
                              for k in ms[0]} for part, ms in seq.items()}

    return multi_step
