"""Discriminators of the GAN fine-tuning stage, counterpart of
`faceoff_tpu/models/discriminators.py`.

  * `MultiscaleDiscriminator2D` / `3D`: the MoCoGAN-HD content and motion
    discriminators, num_D pyramid scales of an N-layer k4 conv stack
    (InstanceNorm, LeakyReLU), each returning its intermediate features.
  * `PatchImageDiscriminator`, `PatchVideoDiscriminator`,
    `ImageDiscriminator`, `VideoDiscriminator`: the MoCoGAN BCE variants,
    BatchNorm and optional input noise.
  * `NLayerDiscriminator`: the Pix2Pix PatchGAN with a sigmoid, BatchNorm
    or ActNorm.

The public layouts are the JAX package's: images (N, H, W, C), videos
(N, T, H, W, C), and every returned feature map channels-last. Inside,
the convolutions run NCHW / NCDHW on permuted views of the input, which
are in PyTorch's channels-last memory format, so cuDNN reads them without
a copy. Modules compute in float32; `in_channels` is named at
construction (Flax infers it at init).

Normalisations follow Flax, not torch:
  * `BatchNorm`: Flax's momentum (0.99 keeps 99 % of the running average,
    torch's momentum=0.01), the running variance updated with the biased
    batch variance (torch uses the unbiased one), epsilon 1e-5.
  * `ActNorm`: loc and scale are parameters whose first values come from
    a batch (`init_actnorm_`), the counterpart of Flax's
    `module.init(key, batch)`.
  * `InstanceNorm`: per sample and channel over the spatial axes, no
    affine, epsilon 1e-5.

Across `torch.distributed` processes (`set_process_group`), BatchNorm's
batch statistics and ActNorm's initialising statistics are those of the
global batch, as under the JAX package's jit over the global batch: each
process's mean and mean square are averaged over the group
(differentiably), the variance is their difference, as Flax computes it.

Weights are drawn on the CPU from `generator` (kernels normal(0, 0.02),
biases zero, BatchNorm scale 1 and bias 0), then moved to `device` (CUDA
unless named). `io.convert.discriminator_from_jax_variables` carries a
Flax discriminator's variables across.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.parallel import collectives

# noise for the GaussianNoise layers: none, drawn from a generator, or the
# standard-normal draws themselves, one tensor a layer in order
Noise = Union[None, torch.Generator, Sequence[torch.Tensor]]


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, ..., C) -> (N, C, ...) as a view."""
    return x.movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> (N, ..., C) as a view."""
    return x.movedim(1, -1)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(ndim: int, cin: int, cout: int, kernel, stride, padding,
          bias: bool = True) -> nn.Module:
    cls = nn.Conv2d if ndim == 2 else nn.Conv3d
    return cls(cin, cout, kernel, stride=stride, padding=padding, bias=bias)


def _broadcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over (N, C, ...)."""
    return v.view((1, -1) + (1,) * (x.dim() - 2))


class ActNorm(nn.Module):
    """scale * (x + loc) per channel. loc and scale train like any
    parameter; `init_actnorm_` sets them from a batch first: loc = -mean,
    scale = 1 / (std + 1e-6) over every axis but the channel's."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(num_features))
        self.scale = nn.Parameter(torch.ones(num_features))
        self.init_pending = False
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.init_pending:
            with torch.no_grad():
                dims = [d for d in range(x.dim()) if d != 1]
                if self.process_group is None:
                    std, mean = torch.std_mean(x, dim=dims, unbiased=False)
                else:
                    mean, var = _global_moments(x, dims, self.process_group)
                    std = torch.sqrt(var)
                self.loc.copy_(-mean)
                self.scale.copy_(1.0 / (std + 1e-6))
            self.init_pending = False
        return _broadcast(self.scale, x) * (x + _broadcast(self.loc, x))


class InstanceNorm(nn.Module):
    """Per sample and channel over the spatial axes, no affine."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=self.epsilon)


def _global_moments(x: torch.Tensor, dims, group):
    """(mean, biased variance) per channel of the global batch whose
    block this process holds (equal blocks), differentiable: the mean and
    mean square averaged over the group, var = E[x^2] - E[x]^2 clamped
    at 0, as Flax computes it."""
    c = x.shape[1]
    both = torch.cat([torch.mean(x, dim=dims), torch.mean(x * x, dim=dims)])
    both = collectives.all_reduce_mean(both, group)
    mean, mean2 = both[:c], both[c:]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class BatchNorm(nn.Module):
    """Flax's `nn.BatchNorm`: in training the batch statistics normalise
    and the running averages take momentum * average + (1 - momentum) *
    batch statistic, the variance biased; otherwise the running averages
    normalise. With a `process_group` the batch statistics are the
    global batch's (`_global_moments`)."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.process_group = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        if self.process_group is not None:
            dims = [d for d in range(x.dim()) if d != 1]
            mean, var = _global_moments(x, dims, self.process_group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            inv = torch.rsqrt(var + self.epsilon) * self.weight
            return ((x - mean.view(shape)) * inv.view(shape)
                    + self.bias.view(shape))
        with torch.no_grad():
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.epsilon)


class GaussianNoise(nn.Module):
    """x + sigma * noise, where noise is drawn from a generator or given;
    without either the layer passes x through (the JAX layer is active
    only when its caller provides a 'noise' random stream)."""

    def __init__(self, sigma: float = 0.2):
        super().__init__()
        self.sigma = sigma

    def forward(self, x: torch.Tensor,
                noise: Union[None, torch.Generator, torch.Tensor] = None
                ) -> torch.Tensor:
        if noise is None:
            return x
        if isinstance(noise, torch.Generator):
            noise = torch.randn(x.shape, generator=noise,
                                device=noise.device).to(x.device)
        return x + self.sigma * noise.to(x.dtype)


def _noise_source(noise: Noise, n_layers: int):
    """One noise argument a GaussianNoise layer: None, the generator, or
    the given tensors in order."""
    if noise is None or isinstance(noise, torch.Generator):
        return [noise] * n_layers
    noise = list(noise)
    if len(noise) != n_layers:
        raise ValueError(f"{len(noise)} noise tensors for {n_layers} "
                         f"noise layers")
    return noise


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """Kernels normal(0, 0.02) in module order, biases zero; norms keep
    their constructors' values."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


class _Discriminator(nn.Module):
    """Weights drawn on the CPU from `generator`, then moved to the
    device."""

    def _finish(self, device: DeviceLike,
                generator: Optional[torch.Generator]) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            _init_(self, generator)
        self.to(resolve_device(device))


class _NLayerStack(nn.Module):
    """The N-layer k4 trunk, 2D or 3D: a stride-2 conv, n_layers - 1
    stride-2 conv+norm stages (widths doubling to 512 at most), a stride-1
    conv+norm and the stride-1 logit conv, each 'padding 2'. Returns every
    activation, channels-first; the last is the logit map."""

    def __init__(self, in_channels: int, ndf: int, n_layers: int, ndim: int,
                 norm: str = "instance"):
        super().__init__()
        widths = [ndf]
        for _ in range(1, n_layers):
            widths.append(min(widths[-1] * 2, 512))
        widths.append(min(widths[-1] * 2, 512))
        strides = [2] * n_layers + [1]
        convs, cin = [], in_channels
        for w, s in zip(widths, strides):
            convs.append(_conv(ndim, cin, w, 4, s, 2))
            cin = w
        convs.append(_conv(ndim, cin, 1, 4, 1, 2))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(_norm(norm, w) for w in widths[1:])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        x = _leaky(self.convs[0](x))
        feats.append(x)
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = _leaky(norm(conv(x)))
            feats.append(x)
        feats.append(self.convs[-1](x))
        return feats


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return BatchNorm(features)  # always its running averages here
    if kind == "actnorm":
        return ActNorm(features)
    raise ValueError(f"unknown norm '{kind}'")


def avg_pool3(x: torch.Tensor, stride) -> torch.Tensor:
    """Average pooling of (N, C, ...) over windows 3 wide on every spatial
    axis, padding 1, padded cells not counted (`count_include_pad=False`):
    the sum of the 3^d strided slices of the padded input over their count.
    Used in place of `F.avg_pool2d`/`avg_pool3d`, whose CUDA backwards
    (PyTorch 2.11) add with atomics in 3D, so a run does not repeat bit for
    bit, and in 2D return wrong gradients for a channels-last input
    (ROADMAP.md, Queue 3); the slices' gradients add in a fixed order."""
    nd = x.dim() - 2
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    sizes = [(n - 1) // s + 1 for n, s in zip(x.shape[2:], stride)]
    padded = F.pad(x, (1, 1) * nd)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), (1, 1) * nd)
    total = count = None
    for offsets in itertools.product(range(3), repeat=nd):
        window = (slice(None), slice(None)) + tuple(
            slice(o, o + s * (m - 1) + 1, s)
            for o, s, m in zip(offsets, stride, sizes))
        total = padded[window] if total is None else total + padded[window]
        count = ones[window] if count is None else count + ones[window]
    return total / count


class _Multiscale(_Discriminator):
    ndim = 2

    def __init__(self, in_channels: int, ndf: int, n_layers: int, num_D: int,
                 norm: str, pool_stride, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.num_D = num_D
        self.pool_stride = pool_stride
        # scale i of the loop is the JAX package's scale{num_D - 1 - i};
        # the most downsampled scale gets the larger width
        self.scales = nn.ModuleList(
            _NLayerStack(in_channels, min(64, ndf * 2 ** (num_D - 1 - i)),
                         n_layers, self.ndim, norm)
            for i in range(num_D))
        self._finish(device, generator)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        x = _channels_first(x.to(torch.float32))
        results = []
        for i, stack in enumerate(self.scales):
            results.append([_channels_last(f) for f in stack(x)])
            if i != self.num_D - 1:
                x = avg_pool3(x, self.pool_stride)
        return results


class MultiscaleDiscriminator2D(_Multiscale):
    """MoCoGAN-HD content discriminator over channel-concatenated frame
    pairs: forward(x (N, H, W, C)) -> a list over num_D scales of feature
    lists, channels-last."""

    ndim = 2

    def __init__(self, in_channels: int = 6, ndf: int = 64, n_layers: int = 3,
                 num_D: int = 2, norm: str = "instance", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, ndf, n_layers, num_D, norm, 2, device,
                         generator)


class MultiscaleDiscriminator3D(_Multiscale):
    """MoCoGAN-HD motion discriminator over (frame0 || frame_t) stacks:
    forward(x (N, T, H, W, C)) -> a list over num_D scales of feature
    lists. Between scales the pyramid pools time too when n_frames > 16."""

    ndim = 3

    def __init__(self, in_channels: int = 6, ndf: int = 64, n_layers: int = 3,
                 num_D: int = 2, n_frames: int = 16, norm: str = "instance", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        stride = (2, 2, 2) if n_frames > 16 else (1, 2, 2)
        super().__init__(in_channels, ndf, n_layers, num_D, norm, stride,
                         device, generator)


class _MocoganDiscriminator(_Discriminator):
    """Stages of [noise] > conv (no bias) > [BatchNorm after the first] >
    LeakyReLU, then a logit conv; `plan` is [(width, kernel)], `stride`
    and `padding` every stage's, `head` the logit conv's (kernel, stride,
    padding)."""

    ndim = 2

    def __init__(self, in_channels, plan, stride, padding, head,
                 use_noise, noise_sigma, device, generator):
        super().__init__()
        self.use_noise = use_noise
        self.noise = nn.ModuleList(
            GaussianNoise(noise_sigma) for _ in plan) if use_noise else None
        convs, cin = [], in_channels
        for w, k in plan:
            convs.append(_conv(self.ndim, cin, w, k, stride, padding,
                               bias=False))
            cin = w
        convs.append(_conv(self.ndim, cin, 1, *head, bias=False))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(w) for w, _ in plan[1:])
        self._finish(device, generator)

    def _trunk(self, x: torch.Tensor, train: bool, noise: Noise):
        x = _channels_first(x.to(torch.float32))
        draws = _noise_source(noise, len(self.convs) - 1)
        for i, conv in enumerate(self.convs[:-1]):
            if self.use_noise:
                x = self.noise[i](x, _channels_first(draws[i])
                                  if torch.is_tensor(draws[i]) else draws[i])
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x, train)
            x = _leaky(x)
        return self.convs[-1](x)


class PatchImageDiscriminator(_MocoganDiscriminator):
    """MoCoGAN patch image discriminator: five k4s2 stages, then a k4s2
    logit conv; forward(x (N, H, W, C)) -> (N, h, w) logits."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float = 0.2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        plan = [(ndf * m, 4) for m in (1, 2, 4, 8, 16)]
        super().__init__(in_channels, plan, 2, 1, (4, 2, 1), use_noise,
                         noise_sigma, device, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Noise = None) -> torch.Tensor:
        return self._trunk(x, train, noise)[:, 0]


class ImageDiscriminator(_MocoganDiscriminator):
    """Non-patch MoCoGAN image discriminator: six k4s2 stages and a k4
    'valid' logit conv, averaged: forward(x (N, H, W, C)) -> (N,)."""

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float = 0.2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        plan = [(ndf * m, 4) for m in (1, 2, 4, 8, 16, 32)]
        super().__init__(in_channels, plan, 2, 1, (4, 1, 0), use_noise,
                         noise_sigma, device, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Noise = None) -> torch.Tensor:
        out = self._trunk(x, train, noise)
        return out.reshape(out.shape[0], -1).mean(dim=-1)


class PatchVideoDiscriminator(_MocoganDiscriminator):
    """MoCoGAN patch video discriminator: 3D stages of stride (1, 2, 2)
    and padding (0, 1, 1), time kept to the logit map; forward(x (N, T,
    H, W, C)) -> (N, t, h, w) logits."""

    ndim = 3

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float = 0.2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        plan = [(ndf, (4, 4, 4)), (ndf * 2, (4, 4, 4)), (ndf * 4, (4, 4, 4)),
                (ndf * 8, (1, 4, 4)), (ndf * 16, (1, 4, 4))]
        super().__init__(in_channels, plan, (1, 2, 2), (0, 1, 1),
                         ((4, 4, 4), (1, 2, 2), (0, 1, 1)), use_noise,
                         noise_sigma, device, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Noise = None) -> torch.Tensor:
        return self._trunk(x, train, noise)[:, 0]


class VideoDiscriminator(_MocoganDiscriminator):
    """Non-patch MoCoGAN video discriminator: six 3D stages and a (1, 4,
    4) 'valid' logit conv, averaged: forward(x (N, T, H, W, C)) -> (N,)."""

    ndim = 3

    def __init__(self, in_channels: int = 3, ndf: int = 64,
                 use_noise: bool = False, noise_sigma: float = 0.2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        plan = [(ndf * m, (4, 4, 4)) for m in (1, 2, 4, 8, 16)]
        plan.append((ndf * 32, (1, 4, 4)))
        super().__init__(in_channels, plan, (1, 2, 2), (0, 1, 1),
                         ((1, 4, 4), 1, 0), use_noise, noise_sigma, device,
                         generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                noise: Noise = None) -> torch.Tensor:
        out = self._trunk(x, train, noise)
        return out.reshape(out.shape[0], -1).mean(dim=-1)


class NLayerDiscriminator(_Discriminator):
    """Pix2Pix PatchGAN with a sigmoid: forward(x (N, H, W, C)) -> (N, h,
    w, 1) in (0, 1). BatchNorm, or ActNorm with `use_actnorm` (then the
    convs before it carry a bias)."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [ndf * min(2 ** n, 8) for n in range(1, n_layers)]
        widths.append(ndf * min(2 ** n_layers, 8))
        strides = [2] * (n_layers - 1) + [1]
        convs = [nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)]
        cin = ndf
        for w, s in zip(widths, strides):
            convs.append(nn.Conv2d(cin, w, 4, stride=s, padding=1,
                                   bias=use_actnorm))
            cin = w
        convs.append(nn.Conv2d(cin, 1, 4, stride=1, padding=1))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            ActNorm(w) if use_actnorm else BatchNorm(w) for w in widths)
        self._finish(device, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _leaky(self.convs[0](_channels_first(x.to(torch.float32))))
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = conv(x)
            x = norm(x, train) if isinstance(norm, BatchNorm) else norm(x)
            x = _leaky(x)
        return _channels_last(torch.sigmoid(self.convs[-1](x)))


@torch.no_grad()
def set_process_group(disc: nn.Module, group) -> None:
    """Compute `disc`'s BatchNorm batch statistics and ActNorm init over
    the global batch of `group`'s processes (None: this process's)."""
    for m in disc.modules():
        if isinstance(m, (BatchNorm, ActNorm)):
            m.process_group = group


def init_actnorm_(disc: nn.Module, x: torch.Tensor, **kwargs) -> None:
    """Set every ActNorm of `disc` from the batch x, as Flax's init with
    that batch does: each layer's loc and scale normalise the activations
    that reach it in one forward, the layers before it already set."""
    for m in disc.modules():
        if isinstance(m, ActNorm):
            m.init_pending = True
    disc(x, **kwargs)
