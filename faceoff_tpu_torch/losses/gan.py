"""GAN losses, counterpart of `faceoff_tpu/losses/gan.py`: hinge and
vanilla discriminator losses, the hinge generator loss, LSGAN and
BCE-with-logits objectives, the relativistic average LSGAN over
multiscale outputs, the gradient penalty and the dispatch by name.

A discriminator's output is one logit tensor, or the multiscale nested
list (one list of feature maps a scale, the last of each the logit map);
only the logits enter a loss. Every loss is a 0-d float32 tensor.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

Logits = Union[torch.Tensor, Sequence[Sequence[torch.Tensor]]]


def _final_logits(d_out: Logits) -> List[torch.Tensor]:
    """A discriminator's output as a flat list of per-scale logits."""
    if isinstance(d_out, (list, tuple)):
        return [s[-1] if isinstance(s, (list, tuple)) else s for s in d_out]
    return [d_out]


def _sum(terms) -> torch.Tensor:
    total = None
    for t in terms:
        total = t if total is None else total + t
    return total.to(torch.float32)


def hinge_d_loss(logits_real: Logits, logits_fake: Logits) -> torch.Tensor:
    return _sum(0.5 * (torch.mean(F.relu(1.0 - r)) + torch.mean(F.relu(1.0 + f)))
                for r, f in zip(_final_logits(logits_real),
                                _final_logits(logits_fake)))


def vanilla_d_loss(logits_real: Logits, logits_fake: Logits) -> torch.Tensor:
    return _sum(0.5 * (torch.mean(F.softplus(-r)) + torch.mean(F.softplus(f)))
                for r, f in zip(_final_logits(logits_real),
                                _final_logits(logits_fake)))


def hinge_g_loss(logits_fake: Logits) -> torch.Tensor:
    return _sum(-torch.mean(f) for f in _final_logits(logits_fake))


def lsgan_loss(logits: Logits, target_is_real: bool) -> torch.Tensor:
    """Least squares against a 0/1 target, summed over scales."""
    target = 1.0 if target_is_real else 0.0
    return _sum(torch.mean((l - target) ** 2) for l in _final_logits(logits))


def bce_logits_loss(logits: Logits, target_is_real: bool) -> torch.Tensor:
    """Binary cross-entropy with logits against a constant target, in the
    log-sigmoid form softplus(l) - target * l."""
    target = 1.0 if target_is_real else 0.0
    return _sum(torch.mean(F.softplus(l) - target * l)
                for l in _final_logits(logits))


def relativistic_average_lsgan(logits_1: Logits, logits_2: Logits,
                               target_is_real: bool,
                               process_group=None) -> torch.Tensor:
    """RaLSGAN: mean((D(x1) - mean D(x2) - target)^2), summed over
    scales. With a torch.distributed `process_group` the inputs are this
    process's block of the global batch and `mean D(x2)` is the global
    batch's (averaged over the group, differentiably); the outer mean
    stays this process's, for the caller to average."""
    target = 1.0 if target_is_real else 0.0

    def batch_mean(b):
        m = torch.mean(b)
        if process_group is None:
            return m
        from faceoff_tpu_torch.parallel import collectives

        return collectives.all_reduce_mean(m, process_group)

    return _sum(torch.mean((a - batch_mean(b) - target) ** 2)
                for a, b in zip(_final_logits(logits_1),
                                _final_logits(logits_2)))


def gradient_penalty(
    disc_apply: Callable[[torch.Tensor], Logits],
    real: torch.Tensor,
    fake: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_D: int = 2,
    *,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """WGAN-GP penalty on interpolates of real and fake batches for a
    multiscale discriminator: sum over scales of mean((||dD/dx|| - 1)^2),
    the norm over the channel (last) axis at each position, times
    10 / num_D. The interpolation weights `alpha` (one a sample, uniform
    in [0, 1)) are drawn from `generator` unless given. The penalty keeps
    its graph (create_graph), so it can be minimised."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],), generator=generator,
                           device=generator.device)
    alpha = alpha.to(real.device, real.dtype).reshape(
        (real.shape[0],) + (1,) * (real.dim() - 1))
    interp = (alpha * real + (1 - alpha) * fake).detach().requires_grad_(True)
    outs = _final_logits(disc_apply(interp))
    total = None
    for o in outs:
        (g,) = torch.autograd.grad(torch.sum(o), interp, create_graph=True)
        gn = torch.sqrt(torch.sum(g ** 2, dim=-1) + 1e-12)
        term = torch.mean((gn - 1.0) ** 2)
        total = term if total is None else total + term
    return total / num_D * 10.0


def multiscale_gan_loss(loss_kind: str, logits_real: Logits,
                        logits_fake: Logits) -> torch.Tensor:
    """The discriminator objective by name: hinge, vanilla, lsgan, bce or
    ralsgan."""
    if loss_kind == "hinge":
        return hinge_d_loss(logits_real, logits_fake)
    if loss_kind == "vanilla":
        return vanilla_d_loss(logits_real, logits_fake)
    if loss_kind == "lsgan":
        return 0.5 * (lsgan_loss(logits_real, True)
                      + lsgan_loss(logits_fake, False))
    if loss_kind == "bce":
        return (bce_logits_loss(logits_real, True)
                + bce_logits_loss(logits_fake, False))
    if loss_kind == "ralsgan":
        return 0.5 * (relativistic_average_lsgan(logits_real, logits_fake, True)
                      + relativistic_average_lsgan(logits_fake, logits_real,
                                                   False))
    raise ValueError(f"unknown GAN loss '{loss_kind}'")
