"""The perceptual step with the CLIs' --remat --remat_lpips at 64 px, the
port's against the JAX package's, float32 on the CPU: the VQVAE with
remat over the full scope and LPIPS recomputed in the backward
(`models.lpips.RematLPIPS`; `jax.checkpoint` of the LPIPS apply in the
JAX CLI), one step of a tiny VQVAE from the same weights and batch.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.models import lpips as jlpips
from faceoff_tpu.train import state as jstate
from faceoff_tpu.train.train_step import make_train_step as jax_train_step
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.io.convert import (from_jax_variables,
                                          lpips_from_jax_variables,
                                          to_jax_variables)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models import lpips as tlpips
from faceoff_tpu_torch.train import state as tstate
from faceoff_tpu_torch.train.train_step import make_train_step

TINY = dict(in_channels=6, channel=16, n_res_block=1, n_res_channel=8,
            embed_dim=8, n_embed=16)
LR, SIZE = 1e-3, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_remat_step_matches_jax():
    """One step at b1, T2, 64 px. Losses 1e-4 relative and codebooks
    rtol 1e-4 atol 1e-5, as tests/test_torch_train.py holds the step
    without remat (remat recomputes the same float32 operations, so it
    adds no tolerance); parameters within 2 lr everywhere (Adam's first
    update is lr g/|g| an entry, and a gradient at rounding level may
    take the other sign) and within 1e-6 on 99 % of the entries."""
    rng = np.random.default_rng(21)
    gt = rng.uniform(-1, 1, (1, 2, SIZE, SIZE, 3)).astype(np.float32)
    bg = rng.uniform(-1, 1, (1, 2, SIZE, SIZE, 3)).astype(np.float32)
    batch = {"input": np.concatenate([gt, bg], -1), "gt": gt}

    jmodel = JaxVQVAE(**TINY, dtype=jnp.float32, use_pallas=False,
                      remat=True, remat_scope="all")
    tx = jstate.make_optimizer(LR, "cycle", n_iter=10)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(batch["input"]), train=False))(jax.random.key(22))
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        vq=variables["vq"], opt_state=tx.init(variables["params"]), tx=tx)
    lp_model = jlpips.LPIPS()
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    lp_vars = jax.jit(lp_model.init)(jax.random.key(23), dummy, dummy)
    # the JAX CLI's --remat_lpips
    step = jax_train_step(
        jmodel, lpips_apply=jax.checkpoint(
            lambda v, a, b: lp_model.apply(v, a, b)), donate=False)
    ref, ref_m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      lp_vars)

    model = VQVAE(ModelConfig(**TINY, remat=True, remat_scope="all"),
                  dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(state.params, state.vq),
                          strict=True)
    lp = tlpips.init_lpips(device="cpu")
    lp.load_state_dict(lpips_from_jax_variables(lp_vars["params"]),
                       strict=False)
    opt = tstate.make_optimizer(model.parameters(), LR, "cycle", n_iter=10)
    got, m = make_train_step(model, lpips=tlpips.RematLPIPS(lp))(
        tstate.create_train_state(model, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()})

    for name in ("loss", "mse", "latent", "perceptual", "lr"):
        np.testing.assert_allclose(m[name].item(), float(ref_m[name]),
                                   rtol=1e-4, err_msg=name)
    params, vq = to_jax_variables(got.model.state_dict())
    for level in ("quantize_t", "quantize_b"):
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                vq[level]["codebook"][name],
                np.asarray(getattr(ref.vq[level]["codebook"], name)),
                rtol=1e-4, atol=1e-5, err_msg=f"{level}.{name}")
    lr0 = float(ref_m["lr"])
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
