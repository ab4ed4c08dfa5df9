"""The port's GAN losses against the JAX package's, float32 on the CPU:
every loss of `losses/gan.py` on one logit array and on the multiscale
nested lists, the dispatch by name, and the gradient penalty of a
multiscale discriminator (weights carried across by the bridge) with the
interpolation weights drawn by JAX and injected. Inputs are made with
numpy from a seed.

Tolerance: 1e-5 relative (float32 means of a few thousand terms in
another order; the penalty's gradients go through the discriminator's
float32 convolutions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu import losses as jl
from faceoff_tpu.losses.gan import gradient_penalty as j_gradient_penalty
from faceoff_tpu.models import discriminators as JD
from faceoff_tpu_torch import losses as tl
from faceoff_tpu_torch.io.convert import discriminator_from_jax_variables
from faceoff_tpu_torch.models import discriminators as TD


def _logits(seed):
    """A single logit map and a two-scale nested output of feature lists
    (only each scale's last entry is a logit map)."""
    rng = np.random.default_rng(seed)
    single = rng.normal(size=(2, 5, 5, 1)).astype(np.float32) * 2
    nested = [[rng.normal(size=(2, 9, 9, 4)).astype(np.float32),
               rng.normal(size=(2, 9, 9, 1)).astype(np.float32) * 1.5],
              [rng.normal(size=(2, 5, 5, 4)).astype(np.float32),
               rng.normal(size=(2, 5, 5, 1)).astype(np.float32) + 0.5]]
    return single, nested


def _as(tree, fn):
    if isinstance(tree, list):
        return [_as(t, fn) for t in tree]
    return fn(tree)


def _pair(kind):
    a1, a2 = _logits(1)
    b1, b2 = _logits(2)
    a, b = (a1, b1) if kind == "single" else (a2, b2)
    return ((_as(a, jnp.asarray), _as(b, jnp.asarray)),
            (_as(a, torch.from_numpy), _as(b, torch.from_numpy)))


LOSSES = {
    "hinge_d": (lambda m, a, b: m.hinge_d_loss(a, b)),
    "vanilla_d": (lambda m, a, b: m.vanilla_d_loss(a, b)),
    "hinge_g": (lambda m, a, b: m.hinge_g_loss(a)),
    "lsgan_real": (lambda m, a, b: m.lsgan_loss(a, True)),
    "lsgan_fake": (lambda m, a, b: m.lsgan_loss(b, False)),
    "bce_real": (lambda m, a, b: m.bce_logits_loss(a, True)),
    "bce_fake": (lambda m, a, b: m.bce_logits_loss(b, False)),
    "ralsgan_real": (lambda m, a, b: m.relativistic_average_lsgan(a, b, True)),
    "ralsgan_fake": (lambda m, a, b: m.relativistic_average_lsgan(a, b,
                                                                  False)),
}
for _kind in ("hinge", "vanilla", "lsgan", "bce", "ralsgan"):
    LOSSES[f"multiscale_{_kind}"] = (
        lambda m, a, b, k=_kind: m.multiscale_gan_loss(k, a, b))


@pytest.mark.parametrize("kind", ["single", "nested"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, kind):
    (ja, jb), (ta, tb) = _pair(kind)
    want = float(LOSSES[name](jl, ja, jb))
    got = LOSSES[name](tl, ta, tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-7)


def test_unknown_loss_is_refused():
    (_, _), (ta, tb) = _pair("single")
    with pytest.raises(ValueError, match="unknown GAN loss"):
        tl.multiscale_gan_loss("wgan", ta, tb)


def test_gradient_penalty_matches_jax():
    """The penalty of a two-scale 3D discriminator on real and fake clip
    stacks, alpha from the same JAX draw; and with alpha drawn from a
    generator, a finite value whose gradient reaches the
    discriminator's weights."""
    rng = np.random.default_rng(3)
    real = rng.normal(size=(2, 3, 16, 16, 6)).astype(np.float32)
    fake = rng.normal(size=(2, 3, 16, 16, 6)).astype(np.float32)
    jm = JD.MultiscaleDiscriminator3D(ndf=4, n_layers=2)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(real))
    key = jax.random.key(4)
    want = float(jax.jit(lambda v, r, f: j_gradient_penalty(
        lambda x: jm.apply(v, x), r, f, key))(variables, jnp.asarray(real),
                                               jnp.asarray(fake)))
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1, 1)))
    tm = TD.MultiscaleDiscriminator3D(6, ndf=4, n_layers=2, device="cpu")
    tm.load_state_dict(discriminator_from_jax_variables(variables, tm))
    got = tl.gradient_penalty(tm, torch.from_numpy(real),
                              torch.from_numpy(fake),
                              alpha=torch.from_numpy(alpha.ravel()))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)

    drawn = tl.gradient_penalty(tm, torch.from_numpy(real),
                                torch.from_numpy(fake),
                                torch.Generator().manual_seed(0))
    drawn.backward()
    assert np.isfinite(drawn.item())
    assert tm.scales[0].convs[0].weight.grad.abs().sum() > 0
