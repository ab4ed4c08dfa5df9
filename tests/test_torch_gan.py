"""The port's GAN stage against the JAX package, float32 on the CPU: one
gen step and one disc step of mocoganhd, one mocogan step (BatchNorm in
training mode) and one vqgan gen/disc pair with its adaptive weight, from
the same weights (carried across by the bridge), batch and random bits;
the codebooks untouched by every discriminator half; the adversarial
schedule; and K steps in one call against K single steps. Inputs are
made with numpy from a seed.

Tolerances, derived as in tests/test_torch_train.py: losses 1e-4
relative (float32 convolutions summed in another order through the VQVAE
and the discriminators); codebooks after an EMA step rtol 1e-4 atol 1e-5
(the same assignments, sums in another order); parameters after one Adam
step: Adam's first update is lr * g / |g| per entry, +-lr wherever the
gradient is well above its rounding noise, but where a gradient is itself
at rounding level its sign may differ between the two packages, so an
entry may differ by up to 2 lr; that bound must hold everywhere and
agreement to 1e-6 on 99 % of the entries. BatchNorm running averages
rtol 1e-5 atol 1e-6 (float32 means and variances of the same
activations)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.models import discriminators as JD
from faceoff_tpu.train import state as jstate
from faceoff_tpu.train.gan import GANTrainState as JGANState
from faceoff_tpu.train.gan import adv_scale_schedule as j_adv_scale
from faceoff_tpu.train.gan import make_gan_steps as j_gan_steps
from faceoff_tpu.train.mocogan import MocoganState as JMocoganState
from faceoff_tpu.train.mocogan import make_mocogan_step as j_mocogan_step
from faceoff_tpu.train.vqgan import VQGANState as JVQGANState
from faceoff_tpu.train.vqgan import make_vqgan_steps as j_vqgan_steps
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import synthetic_corpus
from faceoff_tpu_torch.io.convert import (discriminator_from_jax_variables,
                                          discriminator_to_jax_variables,
                                          from_jax_variables,
                                          to_jax_variables)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models import discriminators as TD
from faceoff_tpu_torch.train import gan as tgan
from faceoff_tpu_torch.train import mocogan as tmocogan
from faceoff_tpu_torch.train import state as tstate
from faceoff_tpu_torch.train import vqgan as tvqgan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(in_channels=6, channel=16, n_res_block=1, n_res_channel=8,
            embed_dim=8, n_embed=16)
LR, DISC_LR = 1e-3, 2e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed, b, t, hw):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (b, t, hw, hw, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (b, t, hw, hw, 3)).astype(np.float32)
    return {"input": np.concatenate([gt, bg], -1), "gt": gt}


def _jax_gen_state(batch, key):
    model = JaxVQVAE(**TINY, dtype=jnp.float32, use_pallas=False)
    tx = jstate.make_optimizer(LR)
    variables = jax.jit(lambda k: model.init(
        k, jnp.asarray(batch["input"]), train=False))(jax.random.key(key))
    return model, jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        vq=variables["vq"], opt_state=tx.init(variables["params"]), tx=tx)


def _jax_disc(disc, x, key, **kw):
    return jax.jit(lambda k, x: disc.init(k, x, **kw))(jax.random.key(key),
                                                       jnp.asarray(x))


def _port_gen(jstate_):
    model = VQVAE(ModelConfig(**TINY), dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(jstate_.params, jstate_.vq),
                          strict=True)
    return tstate.create_train_state(
        model, tstate.make_optimizer(model.parameters(), LR))


def _port_disc(module, variables):
    module.load_state_dict(discriminator_from_jax_variables(variables, module),
                           strict=True)
    return module


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_adam_close(got, want, lr, what):
    """The one-Adam-step rule of the module docstring, over two trees of
    the same structure."""
    diffs = []
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        d = np.abs(np.asarray(g) - np.asarray(w)).ravel()
        assert d.max() <= 2 * lr * (1 + 1e-3) + 1e-6, (
            what, jax.tree_util.keystr(path), d.max())
        diffs.append(d)
    assert np.mean(np.concatenate(diffs) <= 1e-6) >= 0.99, what


def _assert_codebooks_close(model, jvq, what):
    _, vq = to_jax_variables(model.state_dict())
    for level in ("quantize_t", "quantize_b"):
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                vq[level]["codebook"][name],
                np.asarray(getattr(jvq[level]["codebook"], name)),
                rtol=1e-4, atol=1e-5, err_msg=f"{what} {level}.{name}")


def _assert_tree_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _codebooks(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("quantize_")}


def _watch_codebooks(model, seen):
    """A forward hook that records, for each forward of `model` with
    update_codebooks=False, whether the codebook buffers came out bitwise
    as they went in."""
    before = {}

    def pre(module, args, kwargs):
        before["cb"] = _codebooks(module)

    def post(module, args, kwargs, out):
        if kwargs.get("update_codebooks", True) is False:
            now = _codebooks(module)
            seen.append(all(torch.equal(now[k], before["cb"][k])
                            for k in now))

    return (model.register_forward_pre_hook(pre, with_kwargs=True),
            model.register_forward_hook(post, with_kwargs=True))


# -- mocoganhd ------------------------------------------------------------

SF = 4  # the discriminators' window


@pytest.fixture(scope="module")
def mocoganhd():
    """JAX: one gen step and, from the same start, one disc step, at b1,
    T6, 32 px, ndf 8, n_layers 2, two scales."""
    batch = _batch(1, 1, 6, 32)
    jmodel, gen = _jax_gen_state(batch, 2)
    d_img = JD.MultiscaleDiscriminator2D(ndf=8, n_layers=2, num_D=2)
    d_3d = JD.MultiscaleDiscriminator3D(ndf=8, n_layers=2, num_D=2,
                                        n_frames=SF)
    img_vars = _jax_disc(d_img, np.zeros((1, 32, 32, 6), np.float32), 3)
    vid_vars = _jax_disc(d_3d, np.zeros((1, SF - 1, 32, 32, 6), np.float32), 4)
    tx_d = optax.adam(DISC_LR, b1=0.5, b2=0.999)
    state = JGANState(gen=gen, d_img_params=img_vars["params"],
                      d_img_opt=tx_d.init(img_vars["params"]),
                      d_3d_params=vid_vars["params"],
                      d_3d_opt=tx_d.init(vid_vars["params"]),
                      tx_d_img=tx_d, tx_d_3d=tx_d)
    gen_step, disc_step = j_gan_steps(jmodel, d_img, d_3d, sample_frames=SF,
                                      donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(5)

    def bits(tag):
        k = jax.random.fold_in(jax.random.fold_in(key, tag), gen.step)
        k1, k2, k3 = jax.random.split(k, 3)
        t = batch["gt"].shape[1]
        return (int(jax.random.randint(k1, (), 0, t - SF + 1)),
                int(jax.random.randint(k2, (), 1, SF)),
                bool(jax.random.bernoulli(k3)))

    after_gen, gm = gen_step(state, jbatch, key, None, 0.7)
    after_disc, dm = disc_step(state, jbatch, key)
    return dict(batch=batch, state=state, after_gen=after_gen,
                after_disc=after_disc, bits=(bits(0), bits(1)),
                gm={k: float(v) for k, v in gm.items()},
                dm={k: float(v) for k, v in dm.items()},
                d_img=img_vars, d_3d=vid_vars)


def _port_gan(ref):
    gen = _port_gen(ref["state"].gen)
    d_img = _port_disc(TD.MultiscaleDiscriminator2D(6, ndf=8, n_layers=2,
                                                    device="cpu"), ref["d_img"])
    d_3d = _port_disc(TD.MultiscaleDiscriminator3D(6, ndf=8, n_layers=2,
                                                   n_frames=SF, device="cpu"),
                      ref["d_3d"])
    state = tgan.create_gan_state(gen, d_img, d_3d, disc_lr=DISC_LR)
    steps = tgan.make_gan_steps(gen.model, d_img, d_3d, sample_frames=SF)
    return state, steps


def test_mocoganhd_gen_step_matches_jax(mocoganhd):
    ref = mocoganhd
    state, (gen_step, _) = _port_gan(ref)
    d_before = {k: v.clone() for k, v in state.d_3d.state_dict().items()}
    state, m = gen_step(state, {k: _t(v) for k, v in ref["batch"].items()},
                        adv_scale=0.7, bits=ref["bits"][0])
    for name in ("g_loss", "mse", "latent", "g_2d", "g_3d", "perceptual"):
        np.testing.assert_allclose(m[name].item(), ref["gm"][name],
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    params, _ = to_jax_variables(state.gen.model.state_dict())
    _assert_adam_close(params, _np_tree(ref["after_gen"].gen.params), LR,
                       "generator")
    _assert_codebooks_close(state.gen.model, ref["after_gen"].gen.vq, "gen")
    assert state.gen.step == 1
    for k, v in state.d_3d.state_dict().items():
        assert torch.equal(v, d_before[k]), k


def test_mocoganhd_disc_step_matches_jax(mocoganhd):
    ref = mocoganhd
    state, (_, disc_step) = _port_gan(ref)
    seen = []
    hooks = _watch_codebooks(state.gen.model, seen)
    gen_before = {k: v.clone() for k, v in
                  state.gen.model.state_dict().items()}
    state, m = disc_step(state, {k: _t(v) for k, v in ref["batch"].items()},
                         bits=ref["bits"][1])
    for h in hooks:
        h.remove()
    assert seen == [True]  # one forward, codebooks bitwise unchanged
    for k, v in state.gen.model.state_dict().items():
        assert torch.equal(v, gen_before[k]), k
    assert state.gen.step == 0
    for name in ("d_3d_loss", "d_img_loss"):
        np.testing.assert_allclose(m[name].item(), ref["dm"][name],
                                   rtol=1e-4, err_msg=name)
    after = ref["after_disc"]
    for disc, want in ((state.d_img, after.d_img_params),
                       (state.d_3d, after.d_3d_params)):
        got = discriminator_to_jax_variables(disc.state_dict(), disc)
        _assert_adam_close(got["params"], _np_tree(want), DISC_LR,
                           type(disc).__name__)


def test_gan_multi_step_equals_single_pairs():
    """Two pairs in one call on a resident corpus (each step samples and
    prepares its own clips, seeded by its tag and the generator's step)
    equal two gen/disc pairs called one by one, bitwise, and two runs of
    the same calls are equal."""
    frames, lms, n = synthetic_corpus(2, 8, 32, seed=3)
    corpus = corpus_from_arrays(frames, lms, n, device="cpu")
    prep = make_resident_prepare(corpus, 1, 6)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    def fresh():
        model = VQVAE(ModelConfig(**TINY), dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(4))
        gen = tstate.create_train_state(model, lr=LR)
        g = torch.Generator().manual_seed(5)
        d_img = TD.MultiscaleDiscriminator2D(6, ndf=8, n_layers=2,
                                             device="cpu", generator=g)
        d_3d = TD.MultiscaleDiscriminator3D(6, ndf=8, n_layers=2, n_frames=SF,
                                            device="cpu", generator=g)
        return (tgan.create_gan_state(gen, d_img, d_3d),
                dict(sample_frames=SF, prepare_fn=prep))

    state_a, kw = fresh()
    multi = tgan.make_gan_multi_step(state_a.gen.model, state_a.d_img,
                                     state_a.d_3d, 4, **kw)
    stacked = {k: torch.stack([v] * 4) for k, v in raw.items()}
    state_a, seq = multi(state_a, stacked, seed=7, adv_scale=0.5)
    assert seq["gen"]["g_loss"].shape == (2,)
    assert seq["disc"]["d_3d_loss"].shape == (2,)

    def singles():
        state, kw = fresh()
        gen_step, disc_step = tgan.make_gan_steps(
            state.gen.model, state.d_img, state.d_3d, **kw)
        losses = []
        for _ in range(2):
            state, m = gen_step(state, raw, 7, 0.5)
            losses.append(m["g_loss"])
            state, _ = disc_step(state, raw, 7)
        return state, losses

    state_b, losses = singles()
    state_c, _ = singles()
    assert torch.equal(torch.stack(losses), seq["gen"]["g_loss"])
    for a, b, c in ((state_a.gen.model, state_b.gen.model, state_c.gen.model),
                    (state_a.d_3d, state_b.d_3d, state_c.d_3d)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
            assert torch.equal(v, c.state_dict()[k]), k
    with pytest.raises(ValueError, match="even"):
        tgan.make_gan_multi_step(state_a.gen.model, state_a.d_img,
                                 state_a.d_3d, 3)


@pytest.mark.parametrize("start,ramp", [(0, 0), (3, 0), (2, 4), (0, 1)])
def test_adv_scale_schedule_matches_jax(start, ramp):
    for step in range(10):
        assert tgan.adv_scale_schedule(step, start, ramp) == j_adv_scale(
            step, start, ramp)


def test_rand_bits_and_helpers():
    """The window, the pair and the flip keep their ranges; the pair and
    stack helpers build what the JAX helpers build."""
    from faceoff_tpu.train import gan as jgan

    g = torch.Generator().manual_seed(0)
    draws = [tgan.rand_bits(g, 7, 4) for _ in range(200)]
    assert {d[0] for d in draws} == set(range(4))
    assert {d[1] for d in draws} == {1, 2, 3}
    assert {d[2] for d in draws} == {False, True}
    x = np.random.default_rng(0).normal(size=(2, 5, 4, 6, 3)).astype(
        np.float32)
    for got, want in (
            (tgan._pair_stack(_t(x)), jgan._pair_stack(jnp.asarray(x))),
            (tgan._frame_pair(_t(x), 3), jgan._frame_pair(jnp.asarray(x), 3)),
            (tgan._maybe_flip(_t(x), True),
             jgan._maybe_flip(jnp.asarray(x), jnp.asarray(True))),
            (tgan._sample_window(_t(x), 1, 3),
             jgan._sample_window(jnp.asarray(x), 1, 3))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- mocogan --------------------------------------------------------------


def test_mocogan_step_matches_jax():
    """One step at b1, T16, 64 px (the patch discriminators' least size),
    ndf 4: losses, the generator after Adam and its EMA step, both
    discriminators after Adam, their BatchNorm running averages after two
    training-mode calls each (Flax's momentum and biased variance), and
    the codebooks bitwise unchanged by the discriminators' forward."""
    batch = _batch(6, 1, 16, 64)
    jmodel, gen = _jax_gen_state(batch, 7)
    d_img = JD.PatchImageDiscriminator(ndf=4)
    d_vid = JD.PatchVideoDiscriminator(ndf=4)
    img_vars = _jax_disc(d_img, np.zeros((1, 64, 64, 3), np.float32), 8,
                         train=False)
    vid_vars = _jax_disc(d_vid, np.zeros((1, 16, 64, 64, 3), np.float32), 9,
                         train=False)
    tx_d = optax.adam(DISC_LR, b1=0.5, b2=0.999)
    jstate_ = JMocoganState(gen=gen, d_img_vars=img_vars,
                            d_img_opt=tx_d.init(img_vars["params"]),
                            d_vid_vars=vid_vars,
                            d_vid_opt=tx_d.init(vid_vars["params"]), tx_d=tx_d)
    jstep = j_mocogan_step(jmodel, d_img, d_vid, donate=False)
    after, jm = jstep(jstate_, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(10))

    pgen = _port_gen(gen)
    timg = _port_disc(TD.PatchImageDiscriminator(3, ndf=4, device="cpu"),
                      img_vars)
    tvid = _port_disc(TD.PatchVideoDiscriminator(3, ndf=4, device="cpu"),
                      vid_vars)
    state = tmocogan.create_mocogan_state(pgen, timg, tvid, disc_lr=DISC_LR)
    step = tmocogan.make_mocogan_step(pgen.model, timg, tvid)
    seen = []
    hooks = _watch_codebooks(pgen.model, seen)
    state, m = step(state, {k: _t(v) for k, v in batch.items()})
    for h in hooks:
        h.remove()
    assert seen == [True]
    for name in ("g_loss", "mse", "latent", "g_img", "g_vid", "d_img_loss",
                 "d_vid_loss"):
        np.testing.assert_allclose(m[name].item(), float(jm[name]), rtol=1e-4,
                                   err_msg=name)
    params, _ = to_jax_variables(state.gen.model.state_dict())
    _assert_adam_close(params, _np_tree(after.gen.params), LR, "generator")
    _assert_codebooks_close(state.gen.model, after.gen.vq, "mocogan")
    for disc, want in ((timg, after.d_img_vars), (tvid, after.d_vid_vars)):
        got = discriminator_to_jax_variables(disc.state_dict(), disc)
        _assert_adam_close(got["params"], _np_tree(want["params"]), DISC_LR,
                           type(disc).__name__)
        for (path, w), g in zip(
                jax.tree_util.tree_leaves_with_path(want["batch_stats"]),
                jax.tree_util.tree_leaves(got["batch_stats"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


# -- vqgan ----------------------------------------------------------------


def test_vqgan_pair_matches_jax():
    """One gen step (the adaptive weight from one forward and two
    gradients on the retained graph against the JAX step's three
    forwards) and one disc step from the same start, at b1, T2, 32 px,
    NLayerDiscriminator ndf 8, n_layers 2, no LPIPS; the gen step at
    step 0 with disc_start 0 (the adversarial term on), the disc step
    once with the gate open and once closed (disc_start 1: the
    discriminator's loss and update are 0)."""
    batch = _batch(11, 1, 2, 32)
    jmodel, gen = _jax_gen_state(batch, 12)
    disc = JD.NLayerDiscriminator(ndf=8, n_layers=2)
    dvars = _jax_disc(disc, np.zeros((1, 32, 32, 3), np.float32), 13,
                      train=False)
    tx_d = optax.adam(DISC_LR, b1=0.5, b2=0.9)
    jstate_ = JVQGANState(gen=gen, disc_vars=dvars,
                          disc_opt=tx_d.init(dvars["params"]), tx_d=tx_d)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    jgen, jdisc = j_vqgan_steps(jmodel, disc, donate=False)
    after_gen, gm = jgen(jstate_, jbatch)
    assert np.asarray(gm["d_weight"]) > 0

    for disc_start in (0, 1):
        _, jdisc_gated = j_vqgan_steps(jmodel, disc, donate=False,
                                       disc_start=disc_start)
        after_disc, dm = jdisc_gated(jstate_, jbatch)
        pgen = _port_gen(gen)
        tdisc = _port_disc(TD.NLayerDiscriminator(3, ndf=8, n_layers=2,
                                                  device="cpu"), dvars)
        state = tvqgan.create_vqgan_state(pgen, tdisc, disc_lr=DISC_LR)
        gen_step, disc_step = tvqgan.make_vqgan_steps(
            pgen.model, tdisc, disc_start=disc_start)
        if disc_start == 0:
            assert tvqgan.find_last_layer_path(pgen.model) == "dec.blocks.5"
            _, m = gen_step(state, tbatch)
            for name in ("g_loss", "mse", "latent", "d_weight", "g_adv"):
                np.testing.assert_allclose(m[name].item(), float(gm[name]),
                                           rtol=1e-4, err_msg=name)
            params, _ = to_jax_variables(pgen.model.state_dict())
            _assert_adam_close(params, _np_tree(after_gen.gen.params), LR,
                               "generator")
            _assert_codebooks_close(pgen.model, after_gen.gen.vq, "vqgan")
            state = tvqgan.create_vqgan_state(_port_gen(gen), tdisc,
                                              disc_lr=DISC_LR)
            gen_step, disc_step = tvqgan.make_vqgan_steps(
                state.gen.model, tdisc, disc_start=disc_start)
        seen = []
        hooks = _watch_codebooks(state.gen.model, seen)
        _, m = disc_step(state, tbatch)
        for h in hooks:
            h.remove()
        assert seen == [True]
        np.testing.assert_allclose(m["d_loss"].item(), float(dm["d_loss"]),
                                   rtol=1e-4, atol=1e-7)
        got = discriminator_to_jax_variables(tdisc.state_dict(), tdisc)
        _assert_adam_close(got["params"], _np_tree(after_disc.disc_vars[
            "params"]), DISC_LR, f"disc, disc_start {disc_start}")
        if disc_start == 1:
            _assert_tree_equal(got["params"], dvars["params"])
        # the discriminator runs on its initial running averages for ever
        _assert_tree_equal(got["batch_stats"], dvars["batch_stats"])
