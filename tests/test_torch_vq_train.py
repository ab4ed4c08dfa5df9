"""The port's VQ training half against the JAX package, float32 on the CPU:
the plain version of the VQ kernels against the Pallas kernels in
interpret mode (both the single-pass route, K <= 2048, and the K-tiled
route), the statistics, the EMA update, dead-code revival with the same
replacement rows, training-mode quantization, and the model's training
forward on bridged weights. Inputs are made with numpy from a seed and
fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.ops import vq as jvq
from faceoff_tpu.ops import vq_pallas
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.io.convert import from_jax_variables, to_jax_variables
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.ops import vq as tvq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _codebook(rng, d, k):
    embed = rng.normal(size=(d, k)).astype(np.float32)
    size = rng.uniform(0, 3, k).astype(np.float32)
    size[::5] = 0.0  # some dead codes
    avg = (embed * rng.uniform(0.5, 2, k)).astype(np.float32)
    return (jvq.VQCodebook(jnp.asarray(embed), jnp.asarray(size),
                           jnp.asarray(avg)),
            tvq.VQCodebook(_t(embed), _t(size), _t(avg)))


def _assert_same_codebook(got, ref, **tol):
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)


def _assert_same_assignment(idx, ref_idx, flat, embed, margin=1e-5):
    """Indices equal, except on rows whose two best scores lie within
    `margin` (float32 products summed in another order may break such a
    near-tie the other way); there the pick must score within `margin`
    of the best."""
    scores = flat.astype(np.float64) @ embed - 0.5 * (embed.astype(
        np.float64) ** 2).sum(0)
    top2 = np.sort(scores, axis=1)[:, -2:]
    differ = idx != ref_idx
    near = (top2[:, 1] - top2[:, 0]) <= margin
    assert np.all(near[differ]), np.flatnonzero(differ & ~near)[:10]
    picked = scores[np.arange(len(idx)), idx]
    assert np.all(top2[:, 1] - picked <= margin)


@pytest.mark.parametrize("n,d,k", [
    (700, 8, 16),    # the single-pass kernel; N not a multiple of its tile
    (1100, 8, 2100),  # K > 2048: the K-tiled kernels, ragged N and K
])
def test_vq_assign_plain_matches_pallas(n, d, k):
    """Tolerances of tests/test_vq_pallas.py: quant and counts 1e-6
    relative (copies and integers), sums rtol 1e-4 atol 1e-3 (sums of up
    to ~N/K rows taken in another order)."""
    rng = np.random.default_rng(n + k)
    flat = rng.normal(size=(n, d)).astype(np.float32)
    embed = rng.normal(size=(d, k)).astype(np.float32)
    ref = [np.asarray(a) for a in vq_pallas.vq_assign(
        jnp.asarray(flat), jnp.asarray(embed), interpret=True)]
    got = [a.numpy() for a in tvq.vq_assign_plain(_t(flat), _t(embed))]
    assert got[0].dtype == np.int32 and got[0].shape == (n,)
    assert [g.dtype for g in got[1:]] == [np.float32] * 3
    _assert_same_assignment(got[0], ref[0], flat, embed)
    np.testing.assert_allclose(got[1], embed.T[got[0]], rtol=0)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-4, atol=1e-3)
    assert got[2].sum() == n


def test_vq_assign_routes_cpu_to_plain():
    rng = np.random.default_rng(1)
    flat = _t(rng.normal(size=(50, 4)).astype(np.float32))
    embed = _t(rng.normal(size=(4, 9)).astype(np.float32))
    for a, b in zip(tvq.vq_assign(flat, embed),
                    tvq.vq_assign_plain(flat, embed)):
        assert torch.equal(a, b)


def test_vq_stats_matches_jax():
    """Counts exact; sums 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(2)
    flat = rng.normal(size=(300, 8)).astype(np.float32)
    idx = rng.integers(0, 20, 300).astype(np.int32)
    c_ref, s_ref = jvq.vq_stats(jnp.asarray(flat), jnp.asarray(idx), 20)
    c, s = tvq.vq_stats(_t(flat), _t(idx), 20)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5)


def test_vq_ema_update_matches_jax():
    """Elementwise float32 arithmetic in the same order: 1e-6 relative."""
    rng = np.random.default_rng(3)
    jcb, tcb = _codebook(rng, 8, 20)
    counts = rng.integers(0, 9, 20).astype(np.float32)
    sums = rng.normal(size=(8, 20)).astype(np.float32)
    ref = jvq.vq_ema_update(jcb, jnp.asarray(counts), jnp.asarray(sums),
                            decay=0.9, eps=1e-5)
    got = tvq.vq_ema_update(tcb, _t(counts), _t(sums), decay=0.9, eps=1e-5)
    _assert_same_codebook(got, ref, rtol=1e-6, atol=1e-7)


def test_revive_dead_codes_matches_jax():
    """Given the replacement rows JAX draws from its key, the same codes
    are re-seeded with the same rows: exact."""
    rng = np.random.default_rng(4)
    jcb, tcb = _codebook(rng, 8, 20)
    flat = rng.normal(size=(64, 8)).astype(np.float32)
    key = jax.random.key(7)
    ref = jvq.revive_dead_codes(jcb, jnp.asarray(flat), key,
                                usage_threshold=0.5)
    rows = np.asarray(jax.random.randint(key, (20,), 0, 64))
    got = tvq.revive_dead_codes(tcb, _t(flat), usage_threshold=0.5,
                                rows=_t(rows))
    _assert_same_codebook(got, ref, rtol=0)
    dead = np.asarray(jcb.cluster_size) < 0.5
    assert dead.any() and (got.cluster_size.numpy()[dead] == 1).all()


def test_revive_draws_rows_from_generator():
    rng = np.random.default_rng(5)
    _, tcb = _codebook(rng, 4, 10)
    flat = _t(rng.normal(size=(30, 4)).astype(np.float32))
    a = tvq.revive_dead_codes(tcb, flat, torch.Generator().manual_seed(0))
    b = tvq.revive_dead_codes(tcb, flat, torch.Generator().manual_seed(0))
    assert torch.equal(a.embed, b.embed)
    dead = tcb.cluster_size < 1e-3
    rows = flat.t()[:, None, :]  # every revived code is some row of flat
    assert torch.isclose(a.embed[:, dead, None], rows).all(0).any(-1).all()


def test_vq_quantize_train_matches_jax():
    """Quantized values, indices, commitment diff and the EMA step of the
    pure JAX path; codebooks rtol 1e-5 atol 1e-6 (the statistics are
    float32 sums in another order)."""
    rng = np.random.default_rng(6)
    jcb, tcb = _codebook(rng, 8, 16)
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    q_ref, i_ref, d_ref, cb_ref = jvq.vq_quantize_train(
        jcb, jnp.asarray(x), decay=0.99, eps=1e-5)
    xt = _t(x).requires_grad_(True)
    q, i, d, cb = tvq.vq_quantize_train(tcb, xt, decay=0.99, eps=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.item(), float(d_ref), rtol=1e-6)
    _assert_same_codebook(cb, cb_ref, rtol=1e-5, atol=1e-6)
    # straight-through: the quantized output's gradient is the identity
    (q.sum() + d).backward()
    grad_ref = jax.grad(lambda v: jnp.sum(jvq.vq_quantize_train(
        jcb, v)[0]) + jvq.vq_quantize_train(jcb, v)[2])(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_ref),
                               rtol=1e-5, atol=1e-7)


def test_codebook_perplexity_matches_jax():
    idx = np.random.default_rng(7).integers(0, 12, (4, 9)).astype(np.int32)
    np.testing.assert_allclose(
        tvq.codebook_perplexity(_t(idx), 12).item(),
        float(jvq.codebook_perplexity(jnp.asarray(idx), 12)), rtol=1e-6)


def test_init_codebook():
    cb = tvq.init_codebook(torch.Generator().manual_seed(0), 8, 32)
    assert cb.embed.shape == (8, 32) and cb.cluster_size.abs().sum() == 0
    assert torch.equal(cb.embed, cb.embed_avg)
    assert cb.embed.data_ptr() != cb.embed_avg.data_ptr()


TINY = dict(in_channels=6, channel=16, n_res_block=1, n_res_channel=8,
            embed_dim=8, n_embed=16)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxVQVAE(**TINY, dtype=jnp.float32, use_pallas=False)
    rng = np.random.default_rng(8)
    video = rng.uniform(-1, 1, (1, 3, 32, 32, 6)).astype(np.float32)
    variables = jax.jit(lambda key: jmodel.init(
        key, jnp.asarray(video), train=False))(jax.random.key(1))
    return jmodel, variables, video


@pytest.fixture(scope="module")
def jax_training_forward(pair):
    """The JAX model's training forward on `pair`: reconstruction, latent
    loss, the mutated 'vq' collection and the gradient of
    mean(dec^2) + latent with respect to the parameters."""
    jmodel, variables, video = pair

    def jloss(params):
        (dec, lat), upd = jmodel.apply({"params": params,
                                        "vq": variables["vq"]},
                                       jnp.asarray(video), train=True,
                                       mutable=["vq"])
        return jnp.mean(dec ** 2) + lat, (dec, lat, upd["vq"])

    (_, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    return aux, grads


@pytest.mark.parametrize("remat_scope", [None, "all", "encoder", "decoder"])
def test_training_forward_matches_jax(pair, jax_training_forward,
                                      remat_scope):
    """forward(train=True): reconstruction 1e-4 and latent loss 1e-5
    relative (as tests/test_torch_model.py); the EMA state the JAX model
    returns in its mutated 'vq' collection is what the port's buffers
    hold afterwards (rtol 1e-5, atol 1e-6); the gradients of the loss
    agree (atol 1e-5), without remat and with each remat scope."""
    _, variables, video = pair
    model = VQVAE(ModelConfig(**TINY, remat=remat_scope is not None,
                              remat_scope=remat_scope or "all"),
                  dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["vq"]), strict=True)
    (dec_ref, lat_ref, vq_ref), g_ref = jax_training_forward
    dec, lat = model(_t(video), train=True)
    (torch.mean(dec ** 2) + lat).backward()
    np.testing.assert_allclose(dec.detach().numpy(), np.asarray(dec_ref),
                               atol=1e-4)
    np.testing.assert_allclose(lat.item(), float(lat_ref), rtol=1e-5)
    _, vq_got = to_jax_variables(model.state_dict())
    for level in ("quantize_t", "quantize_b"):
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(
                vq_got[level]["codebook"][name],
                np.asarray(getattr(vq_ref[level]["codebook"], name)),
                rtol=1e-5, atol=1e-6, err_msg=f"{level}.{name}")
    sd = model.state_dict()
    sd.update({n: p.grad for n, p in model.named_parameters()})
    grads, _ = to_jax_variables(sd)
    for path, ref in jax.tree_util.tree_leaves_with_path(g_ref):
        node = grads
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(ref), atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_bridge_round_trip(pair):
    """to_jax_variables inverts from_jax_variables exactly, EMA state
    included."""
    _, variables, _ = pair
    sd = from_jax_variables(variables["params"], variables["vq"])
    params, vq = to_jax_variables(sd)
    for path, ref in jax.tree_util.tree_leaves_with_path(variables["params"]):
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(ref))
    for level in ("quantize_t", "quantize_b"):
        cb = variables["vq"][level]["codebook"]
        for name in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_array_equal(vq[level]["codebook"][name],
                                          np.asarray(getattr(cb, name)))


def test_encode_codes_and_revive_match_jax(pair):
    """encode_codes gives the JAX code maps; revive_codes re-seeds dead
    codes of both levels (a fresh codebook's counts are all zero, so all
    of them are dead) with rows of that level's pre-quantization
    latents."""
    jmodel, variables, video = pair
    model = VQVAE(ModelConfig(**TINY), dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["vq"]), strict=True)
    jt, jb = jmodel.apply(variables, jnp.asarray(video),
                          method=JaxVQVAE.encode_codes)
    with torch.no_grad():
        t, b = model.encode_codes(_t(video))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    model.revive_codes(_t(video), torch.Generator().manual_seed(0))
    for q in (model.quantize_t, model.quantize_b):
        assert torch.equal(q.cluster_size, torch.ones_like(q.cluster_size))
        assert torch.equal(q.embed, q.embed_avg)
