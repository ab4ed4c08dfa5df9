"""The port's training step against the JAX package, float32 on the CPU:
every schedule over n_iter steps, Adam with a cycled b1 against optax,
and two whole train steps of a tiny VQVAE with LPIPS from the same
weights and batch. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.models import lpips as jlpips
from faceoff_tpu.train import schedule as jsched
from faceoff_tpu.train import state as jstate
from faceoff_tpu.train.train_step import make_train_step as jax_train_step
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import synthetic_corpus
from faceoff_tpu_torch.io.convert import (from_jax_variables,
                                          lpips_from_jax_variables,
                                          to_jax_variables)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models import lpips as tlpips
from faceoff_tpu_torch.train import schedule as tsched
from faceoff_tpu_torch.train import state as tstate
from faceoff_tpu_torch.train.train_step import (make_eval_step,
                                                make_train_step, step_seed)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


SCHEDULES = ["cycle", "cosine", "power", "sine", "linear", "clr",
             "cycle_anneal", "lr_finder"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_jax(name):
    """Every step of two cycles of n_iter = 37 (odd, so no phase boundary
    falls on a round step): 1e-5 relative, the float32 rounding of the
    JAX schedules (lr_finder compounds it over the exponent: 2e-5)."""
    n_iter, lr = 37, 3e-4
    ref = jsched.make_schedule(name, lr, n_iter)
    got = tsched.make_schedule(name, lr, n_iter)
    steps = np.arange(2 * n_iter)
    want = np.array([float(ref(jnp.int32(s))) for s in steps])
    have = np.array([got(int(s)) for s in steps])
    np.testing.assert_allclose(have, want,
                               rtol=2e-5 if name == "lr_finder" else 1e-5)
    assert tsched.make_schedule("", lr, n_iter) is None
    with pytest.raises(ValueError):
        tsched.make_schedule("nope", lr, n_iter)


def test_other_schedules_match_jax():
    """The factories make_schedule does not reach."""
    pairs = [
        (jsched.transformer_warmup(64, 2.0, 10),
         tsched.transformer_warmup(64, 2.0, 10)),
        (jsched.cycle_momentum_schedule(37, (0.95, 0.85), 0.05),
         tsched.cycle_momentum_schedule(37, (0.95, 0.85), 0.05)),
        (jsched.lr_finder(1e-6, 1e-3, 37, linear=True),
         tsched.lr_finder(1e-6, 1e-3, 37, linear=True)),
    ]
    for ref, got in pairs:
        for s in range(40):
            np.testing.assert_allclose(got(s), float(ref(jnp.int32(s))),
                                       rtol=1e-5)


def test_adam_with_cycled_b1_matches_optax():
    """Three updates of the one-cycle Adam (lr and b1 scheduled, warmup of
    2 of 10 steps, so b1 changes every step) on the same gradients:
    parameters to 1e-6 relative, the lr read back as optax's."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    tx = jstate.make_optimizer(1e-2, "cycle", n_iter=10,
                               warmup_proportion=0.2)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    w = torch.nn.Parameter(_t(w0))
    opt = tstate.make_optimizer([w], 1e-2, "cycle", n_iter=10,
                                warmup_proportion=0.2)
    for k, g in enumerate(grads):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, upd)
        w.grad = _t(g)
        opt.step(k)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            opt.lr, float(opt_state.hyperparams["learning_rate"]), rtol=1e-6)
        assert opt.optimizer.param_groups[0]["betas"][0] == pytest.approx(
            float(opt_state.hyperparams["b1"]), rel=1e-6)


def test_step_seed():
    seeds = {step_seed(s, k) for s in range(4) for k in range(50)}
    assert len(seeds) == 200 and all(0 <= x < 2**63 for x in seeds)


TINY = dict(in_channels=6, channel=16, n_res_block=1, n_res_channel=8,
            embed_dim=8, n_embed=16)
LR = 1e-3


@pytest.fixture(scope="module")
def two_jax_steps():
    """Two JAX train steps (one-cycle Adam, LPIPS at 32 px) on one batch
    of b1, T2, 32 px, from variables the port loads through the bridge."""
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    batch = {"input": np.concatenate([gt, bg], -1), "gt": gt}
    jmodel = JaxVQVAE(**TINY, dtype=jnp.float32, use_pallas=False)
    tx = jstate.make_optimizer(LR, "cycle", n_iter=10)
    # create_train_state and init_lpips, with their inits jitted (one
    # compile instead of one per operation)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(batch["input"]), train=False))(jax.random.key(2))
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        vq=variables["vq"], opt_state=tx.init(variables["params"]), tx=tx)
    lp_model = jlpips.LPIPS()
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    lp_vars = jax.jit(lp_model.init)(jax.random.key(3), dummy, dummy)
    step = jax_train_step(
        jmodel, lpips_apply=lambda v, a, b: lp_model.apply(v, a, b),
        donate=False)
    states, metrics = [state], []
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        state, m = step(state, jbatch, lp_vars)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return batch, states, metrics, lp_vars


def _port_from(state, lp_vars):
    model = VQVAE(ModelConfig(**TINY), dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(state.params, state.vq),
                          strict=True)
    lp = tlpips.init_lpips(device="cpu")
    lp.load_state_dict(lpips_from_jax_variables(lp_vars["params"]),
                       strict=False)
    opt = tstate.make_optimizer(model.parameters(), LR, "cycle", n_iter=10)
    return tstate.create_train_state(model, opt), lp


def test_train_steps_match_jax(two_jax_steps):
    """Two steps from the same weights and batch.

    Losses: 1e-4 relative (float32 convolutions summed in another order
    through the VQVAE and 13 VGG layers). Codebooks after each step: the
    EMA statistics of the same assignments, rtol 1e-4 atol 1e-5.
    Parameters after the first step: Adam's first update is lr * g/|g|
    per entry, +-lr wherever the gradient is far above its rounding
    noise, but where a gradient is itself at rounding level its sign may
    differ between the two, so an entry may differ by up to 2 lr; we
    require that bound everywhere and agreement to 1e-6 on 99% of the
    entries."""
    batch, states, metrics, lp_vars = two_jax_steps
    state, lp = _port_from(states[0], lp_vars)
    step = make_train_step(state.model, lpips=lp)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for k in range(2):
        state, m = step(state, tbatch)
        for name in ("loss", "mse", "latent", "perceptual", "lr"):
            np.testing.assert_allclose(m[name].item(), metrics[k][name],
                                       rtol=1e-4, err_msg=f"{name} {k}")
        params, vq = to_jax_variables(state.model.state_dict())
        ref = states[k + 1]
        for level in ("quantize_t", "quantize_b"):
            for name in ("embed", "cluster_size", "embed_avg"):
                np.testing.assert_allclose(
                    vq[level]["codebook"][name],
                    np.asarray(getattr(ref.vq[level]["codebook"], name)),
                    rtol=1e-4, atol=1e-5, err_msg=f"{level}.{name} {k}")
        if k == 0:
            lr0 = metrics[0]["lr"]
            diffs = []
            for path, r in jax.tree_util.tree_leaves_with_path(ref.params):
                node = params
                for p in path:
                    node = node[p.key]
                d = np.abs(node - np.asarray(r)).ravel()
                assert d.max() <= 2 * lr0 * (1 + 1e-3) + 1e-6, (
                    jax.tree_util.keystr(path), d.max())
                diffs.append(d)
            assert np.mean(np.concatenate(diffs) <= 1e-6) >= 0.99
    assert state.step == 2


def test_resident_train_steps_and_eval():
    """The step with a resident prepare function: finite losses, a fresh
    batch every step (the generator is seeded from the step count), a
    rerun from the same weights and seed repeats the losses exactly, and
    eval leaves the codebooks alone."""
    frames, lms, n = synthetic_corpus(2, 6, 32, seed=2)
    corpus = corpus_from_arrays(frames, lms, n, device="cpu")
    prep = make_resident_prepare(corpus, 1, 2)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    def run(n_steps):
        model = VQVAE(ModelConfig(**TINY), dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(4))
        opt = tstate.make_optimizer(model.parameters(), 3e-3)
        state = tstate.create_train_state(model, opt)
        step = make_train_step(model, prepare_fn=prep)
        losses = []
        for _ in range(n_steps):
            state, m = step(state, raw, seed=5)
            losses.append(m["mse"].item())
        return state, losses

    state, losses = run(4)
    assert np.all(np.isfinite(losses)) and len(set(losses)) == 4
    assert tstate.current_lr(state) == 3e-3
    _, again = run(2)
    assert again == losses[:2]
    batch = prep(torch.Generator().manual_seed(0), corpus.frames,
                 corpus.landmarks)
    before = state.model.quantize_b.embed.clone()
    out, m = make_eval_step(state.model)(state, batch)
    assert out.shape == (1, 2, 32, 32, 3) and np.isfinite(m["mse"].item())
    assert torch.equal(before, state.model.quantize_b.embed)
