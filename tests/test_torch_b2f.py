"""The port's VQVAE_B2F against the JAX package's, float32 on the CPU,
from the same weights carried by `io.convert.b2f_from_jax_variables`
(which `b2f_to_jax_variables` must carry back unchanged): the evaluation
forward, the training forward and its six EMA codebooks after one step
against JAX's `vq` collection, and the kernels' counterpart on the CPU
(`vq_assign_plain`) at every quantizer call. Narrow widths (channel 16,
one res block, embed 8, 32 codes), 32 px, inputs made with numpy from a
seed.

Tolerance: reconstruction and latent loss within 1e-5 of their largest
magnitude (float32 convolutions summed in another order); the codes
assigned are equal (the inputs are far from ties at this seed, checked
by the equal indices of both packages); the EMA codebooks rtol 1e-5
atol 1e-6 (a mean of the same rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models.vqvae_b2f import VQVAE_B2F as JB2F
from faceoff_tpu_torch.io.convert import (b2f_from_jax_variables,
                                          b2f_to_jax_variables)
from faceoff_tpu_torch.models.vqvae_b2f import STREAMS, VQVAE_B2F
from faceoff_tpu_torch.ops import vq as V

WIDTHS = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8,
              n_embed=32)


def _inputs(n=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
                 for _ in STREAMS)


@pytest.fixture(scope="module")
def pair():
    x = _inputs()
    jm = JB2F(in_channels=3, dtype=jnp.float32, **WIDTHS)
    variables = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(3), tuple(map(jnp.asarray, x)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = VQVAE_B2F(in_channels=3, dtype=torch.float32, device="cpu", **WIDTHS)
    tm.load_state_dict(b2f_from_jax_variables(variables["params"],
                                              variables["vq"]), strict=True)
    return jm, variables, tm, x


def _close(got, want, rel=1e-5):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _codebook_trees_close(got, want, **kw):
    for tower in want:
        for level in want[tower]:
            cb = want[tower][level]["codebook"]
            for name in ("embed", "cluster_size", "embed_avg"):
                np.testing.assert_allclose(
                    got[tower][level]["codebook"][name],
                    np.asarray(getattr(cb, name)), **kw)


def test_bridge_round_trip(pair):
    _, variables, tm, _ = pair
    params, vq = b2f_to_jax_variables(tm.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    want = dict(jax.tree_util.tree_leaves_with_path(
        dict(variables["params"])))
    assert flat.keys() == want.keys()
    for k in want:
        assert np.array_equal(flat[k], want[k]), k
    _codebook_trees_close(vq, variables["vq"], rtol=0, atol=0)
    assert sum(isinstance(m, torch.nn.Module) and hasattr(m, "embed_avg")
               for m in tm.modules()) == 6


def test_eval_forward_matches_jax(pair):
    jm, variables, tm, x = pair
    with torch.no_grad():
        dec, diff = tm(tuple(map(torch.from_numpy, x)))
    jdec, jdiff = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, tuple(map(jnp.asarray, x)))
    assert dec.dtype == torch.float32 and dec.shape == (2, 32, 32, 3)
    _close(dec, jdec)
    _close(diff, jdiff)


def test_train_forward_and_ema_codebooks_match_jax(pair, monkeypatch):
    """One training forward: the six quantizers assign through
    `vq_assign` (the plain version on the CPU) and take the EMA step."""
    jm, variables, tm, x = pair
    calls = []
    plain = V.vq_assign

    def counting(flat, embed):
        calls.append(tuple(flat.shape))
        return plain(flat, embed)

    monkeypatch.setattr(V, "vq_assign", counting)
    model = VQVAE_B2F(in_channels=3, dtype=torch.float32, device="cpu",
                      **WIDTHS)
    model.load_state_dict(tm.state_dict())
    dec, diff = model(tuple(map(torch.from_numpy, x)), train=True)
    assert calls == [(2 * 4 * 4, 8), (2 * 8 * 8, 8)] * 3
    (jdec, jdiff), upd = jax.jit(
        lambda v, x: jm.apply(v, x, train=True, mutable=["vq"]))(
            variables, tuple(map(jnp.asarray, x)))
    _close(dec, jdec)
    _close(diff, jdiff)
    _, vq = b2f_to_jax_variables(model.state_dict())
    _codebook_trees_close(vq, upd["vq"], rtol=1e-5, atol=1e-6)
    # the gradient reaches every tower's encoder
    (dec.square().mean() + diff).backward()
    for tower in model.towers():
        assert tower.enc_b.blocks[0].weight.grad.abs().sum() > 0
