"""The port's discriminators against the JAX package's, float32 on the
CPU: every class from the same weights (carried across by the bridge,
which must also carry them back unchanged), in evaluation and, where
there is BatchNorm, training mode with the running averages after the
call against Flax's `batch_stats`; ActNorm's data-dependent init from a
batch; and the input-noise layers with the JAX draws injected. Inputs
are made with numpy from a seed.

Tolerance: every output and feature map within 1e-5 of its largest
magnitude (float32 convolutions of up to 4096 terms summed in another
order; the normalisations divide by statistics of those sums); running
averages rtol 1e-5 atol 1e-6."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models import discriminators as JD
from faceoff_tpu_torch.io.convert import (discriminator_from_jax_variables,
                                          discriminator_to_jax_variables)
from faceoff_tpu_torch.models import discriminators as TD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaves(out):
    if torch.is_tensor(out):
        return [out.detach().numpy()]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _leaves(o)]
    return [np.asarray(out)]


def _assert_outputs_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


def _init(jm, x, **kw):
    return jax.jit(lambda k, x: jm.init(k, x, **kw))(jax.random.key(0),
                                                     jnp.asarray(x))


def _ported(tm, variables):
    sd = discriminator_from_jax_variables(variables, tm)
    tm.load_state_dict(sd, strict=True)
    back = discriminator_to_jax_variables(tm.state_dict(), tm)
    want = jax.tree_util.tree_map(np.asarray, dict(variables))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    return tm


CASES = {
    "multiscale2d": (lambda: JD.MultiscaleDiscriminator2D(ndf=8, n_layers=2),
                     lambda: TD.MultiscaleDiscriminator2D(6, ndf=8, n_layers=2,
                                                          device="cpu"),
                     (2, 32, 32, 6), False),
    "multiscale2d_3scales": (
        lambda: JD.MultiscaleDiscriminator2D(ndf=4, n_layers=3, num_D=3),
        lambda: TD.MultiscaleDiscriminator2D(6, ndf=4, n_layers=3, num_D=3,
                                             device="cpu"),
        (1, 48, 40, 6), False),
    "multiscale3d": (lambda: JD.MultiscaleDiscriminator3D(ndf=8, n_layers=2),
                     lambda: TD.MultiscaleDiscriminator3D(6, ndf=8, n_layers=2,
                                                          device="cpu"),
                     (2, 5, 32, 32, 6), False),
    # more than 16 frames: the pyramid pools time too; BatchNorm norms
    "multiscale3d_batch_n20": (
        lambda: JD.MultiscaleDiscriminator3D(ndf=8, n_layers=2, n_frames=20,
                                             norm="batch"),
        lambda: TD.MultiscaleDiscriminator3D(6, ndf=8, n_layers=2,
                                             n_frames=20, norm="batch",
                                             device="cpu"),
        (1, 7, 32, 32, 6), False),
    "patch_image": (lambda: JD.PatchImageDiscriminator(ndf=8),
                    lambda: TD.PatchImageDiscriminator(3, ndf=8, device="cpu"),
                    (2, 64, 64, 3), True),
    "patch_video": (lambda: JD.PatchVideoDiscriminator(ndf=4),
                    lambda: TD.PatchVideoDiscriminator(3, ndf=4, device="cpu"),
                    (2, 16, 64, 64, 3), True),
    "image": (lambda: JD.ImageDiscriminator(ndf=2),
              lambda: TD.ImageDiscriminator(3, ndf=2, device="cpu"),
              (2, 256, 256, 3), True),
    "video": (lambda: JD.VideoDiscriminator(ndf=2),
              lambda: TD.VideoDiscriminator(3, ndf=2, device="cpu"),
              (1, 16, 256, 256, 3), True),
    "nlayer": (lambda: JD.NLayerDiscriminator(ndf=8, n_layers=2),
               lambda: TD.NLayerDiscriminator(3, ndf=8, n_layers=2,
                                              device="cpu"),
               (2, 32, 32, 3), True),
    "nlayer_3layers": (lambda: JD.NLayerDiscriminator(ndf=4, n_layers=3),
                       lambda: TD.NLayerDiscriminator(3, ndf=4, n_layers=3,
                                                      device="cpu"),
                       (1, 64, 64, 3), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_discriminator_matches_jax(name):
    """Evaluation mode; then, for the BatchNorm classes, one training-mode
    call: its output (batch statistics) and the running averages after
    it (Flax's momentum 0.99 and biased variance)."""
    make_j, make_t, shape, has_train = CASES[name]
    jm, x = make_j(), _x(shape)
    kw = {"train": False} if has_train else {}
    variables = _init(jm, x, **kw)
    tm = _ported(make_t(), variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, **kw))(variables,
                                                      jnp.asarray(x))
    with torch.no_grad():
        _assert_outputs_close(tm(torch.from_numpy(x)), want)
    if not has_train:
        return
    x2 = _x(shape, seed=1) * 1.5 + 0.3
    want, updates = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x2))
    with torch.no_grad():
        _assert_outputs_close(tm(torch.from_numpy(x2), train=True), want)
    got = discriminator_to_jax_variables(tm.state_dict(), tm)["batch_stats"]
    for (path, w), g in zip(
            jax.tree_util.tree_leaves_with_path(updates["batch_stats"]),
            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["nlayer", "multiscale2d"])
def test_actnorm_init_from_batch_matches_flax(kind):
    """ActNorm's loc and scale from a batch: Flax initialises them inside
    `init(key, batch)`; the port loads the convolutions, resets every
    ActNorm and runs `init_actnorm_` on the same batch. Each layer's
    statistics see the layers before it already initialised. Then the
    forward on another batch."""
    x = _x((2, 32, 32, 3 if kind == "nlayer" else 6), seed=2) * 2 + 0.5
    if kind == "nlayer":
        jm = JD.NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True)
        tm = TD.NLayerDiscriminator(3, ndf=8, n_layers=2, use_actnorm=True,
                                    device="cpu")
    else:
        jm = JD.MultiscaleDiscriminator2D(ndf=8, n_layers=2, norm="actnorm")
        tm = TD.MultiscaleDiscriminator2D(6, ndf=8, n_layers=2,
                                          norm="actnorm", device="cpu")
    variables = _init(jm, x)
    tm.load_state_dict(discriminator_from_jax_variables(variables, tm))
    actnorms = [m for m in tm.modules() if isinstance(m, TD.ActNorm)]
    assert actnorms
    with torch.no_grad():
        for m in actnorms:
            m.loc.zero_()
            m.scale.fill_(1.0)
    TD.init_actnorm_(tm, torch.from_numpy(x))
    assert not any(m.init_pending for m in actnorms)
    got = discriminator_to_jax_variables(tm.state_dict(), tm)["params"]
    for (path, w), g in zip(
            jax.tree_util.tree_leaves_with_path(variables["params"]),
            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    x2 = _x(x.shape, seed=3)
    with torch.no_grad():
        _assert_outputs_close(tm(torch.from_numpy(x2)),
                              jm.apply(variables, jnp.asarray(x2)))


class _Layer(nn.Module):
    sigma: float

    @nn.compact
    def __call__(self, x):
        return JD.GaussianNoise(self.sigma)(x, train=True)


def _noise_draws(jm, variables, x, **kw):
    """The standard-normal draw of each GaussianNoise layer of a JAX
    module in one apply, in call order, through a method interceptor."""
    def run(variables, x):
        draws = []

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if (isinstance(context.module, JD.GaussianNoise)
                    and context.method_name == "__call__"):
                draws.append((out - args[0]) / context.module.sigma)
            return out

        with nn.intercept_methods(intercept):
            out = jm.apply(variables, x, rngs={"noise": jax.random.key(9)},
                           **kw)
        return out, draws

    out, draws = jax.jit(run)(variables, jnp.asarray(x))
    return out, [np.array(d) for d in draws]


def test_gaussian_noise_with_injected_draws():
    """The layer alone: x + sigma * noise with the JAX layer's draw; no
    noise passes x through (the JAX layer without a 'noise' stream); a
    generator draws noise of x's shape."""
    x = _x((2, 8, 8, 3))
    jm = _Layer(0.3)
    out, (draw,) = _noise_draws(jm, {}, x)
    got = TD.GaussianNoise(0.3)(torch.from_numpy(x), torch.from_numpy(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-6,
                               atol=1e-6)
    layer = TD.GaussianNoise(0.3)
    assert torch.equal(layer(torch.from_numpy(x)), torch.from_numpy(x))
    drawn = layer(torch.zeros(2, 8, 8, 3), torch.Generator().manual_seed(0))
    assert 0.2 < float(drawn.std()) < 0.4


@pytest.mark.parametrize("kind", ["patch_image", "patch_video"])
def test_noisy_discriminator_with_injected_draws(kind):
    """A use_noise discriminator in training mode with each noise layer's
    JAX draw injected, in order."""
    if kind == "patch_image":
        jm = JD.PatchImageDiscriminator(ndf=4, use_noise=True,
                                        noise_sigma=0.1)
        tm = TD.PatchImageDiscriminator(3, ndf=4, use_noise=True,
                                        noise_sigma=0.1, device="cpu")
        x = _x((2, 64, 64, 3), seed=4)
    else:
        jm = JD.PatchVideoDiscriminator(ndf=2, use_noise=True,
                                        noise_sigma=0.1)
        tm = TD.PatchVideoDiscriminator(3, ndf=2, use_noise=True,
                                        noise_sigma=0.1, device="cpu")
        x = _x((1, 16, 64, 64, 3), seed=4)
    variables = _init(jm, x, train=False)
    tm = _ported(tm, variables)
    (want, _), draws = _noise_draws(
        jm, variables, x, train=True, mutable=["batch_stats"])
    assert len(draws) == 5
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True,
                 noise=[torch.from_numpy(d) for d in draws])
    _assert_outputs_close(got, want)
    with pytest.raises(ValueError, match="noise tensors"):
        tm(torch.from_numpy(x), noise=[torch.from_numpy(draws[0])])
