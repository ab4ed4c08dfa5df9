"""The port's LPIPS against the JAX package on the same weights, float32
on the CPU at 32 px, and its weight loading from the `.npz` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models import lpips as jlpips
from faceoff_tpu_torch.io.convert import lpips_from_jax_variables
from faceoff_tpu_torch.models import lpips as tlpips


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_lpips():
    """`init_lpips(key, image_size=32)` without weights, with the init
    jitted (one compile instead of one per operation)."""
    model = jlpips.LPIPS()
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return model, jax.jit(model.init)(jax.random.key(3), dummy, dummy)


def _bridged(variables):
    model = tlpips.init_lpips(device="cpu")
    missing, unexpected = model.load_state_dict(
        lpips_from_jax_variables(variables["params"]), strict=False)
    assert sorted(missing) == ["scale", "shift"] and not unexpected
    return model


def test_lpips_matches_jax(jax_lpips):
    """Random images at 32 px through 13 convolutions and 5 normalised
    taps: 1e-5 relative on the distance, and the gradient with respect to
    the prediction to atol 1e-6 (float32 sums in another order)."""
    jmodel, variables = jax_lpips
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(variables, jnp.asarray(a), p)))(jnp.asarray(b))
    model = _bridged(variables)
    pred = torch.from_numpy(b).requires_grad_(True)
    got = model(torch.from_numpy(a), pred)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(g_ref),
                               atol=1e-6)
    assert all(not p.requires_grad for p in model.parameters())


def test_lpips_of_identical_images_is_zero(jax_lpips):
    model = _bridged(jax_lpips[1])
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    assert model(x, x).item() == 0.0


def test_load_lpips_weights_from_npz(tmp_path, jax_lpips):
    """The `.npz` layout of tools/convert_lpips.py loads to the same
    weights as the bridge; a wrong shape raises."""
    _, variables = jax_lpips
    params = variables["params"]
    arrays = {f"vgg/{n}/{leaf}": np.asarray(node[leaf])
              for n, node in params["vgg"].items() for leaf in node}
    arrays.update({f"{n}/kernel": np.asarray(params[n]["kernel"])
                   for n in params if n.startswith("lin")})
    path = tmp_path / "lpips.npz"
    np.savez(path, **arrays)
    model = tlpips.init_lpips(device="cpu", weights_npz=str(path))
    ref = _bridged(variables).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    arrays["lin0/kernel"] = arrays["lin0/kernel"][..., :1, :]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="lins.0.weight"):
        tlpips.init_lpips(device="cpu", weights_npz=str(path))


def test_target_tower_carries_no_graph(jax_lpips):
    """Two towers: every VGG convolution sees the N target images without
    a graph and the N predictions with one, never a 2N stack; the
    gradient reaches the prediction only."""
    model = _bridged(jax_lpips[1])
    seen = []
    for conv in model.vgg.convs.values():
        conv.register_forward_hook(
            lambda m, i, o: seen.append((o.shape[0], o.requires_grad)))
    target = (torch.rand(3, 32, 32, 3) * 2 - 1).requires_grad_(True)
    pred = (torch.rand(3, 32, 32, 3) * 2 - 1).requires_grad_(True)
    model(target, pred).backward()
    n_convs = len(model.vgg.convs)
    assert seen == [(3, False)] * n_convs + [(3, True)] * n_convs
    assert target.grad is None and pred.grad is not None


def test_lpips_bf16_matches_jax_bf16(jax_lpips):
    """`LPIPS(dtype=bfloat16)` against the JAX `LPIPS(dtype=bfloat16)` on
    the same bridged weights and inputs, on the CPU: 5e-3 relative. Both
    round the input standardisation, all 13 convolutions and the
    normalisation to bf16 (unit roundoff 2^-9 = 2.0e-3), but each library
    accumulates inside a convolution or a sum its own way, so a rounding
    may fall on either side; the distance averages many such terms and
    stayed within 2.7e-3 over eight seeded draws. The same inputs through
    the JAX float32 module differ by about 1.5e-2, so the bound also
    tells a bf16 computation from a float32 one."""
    jmodel32, variables = jax_lpips
    jmodel = jlpips.LPIPS(dtype=jnp.bfloat16)
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    model = _bridged(variables).to(torch.bfloat16)
    assert model.dtype == torch.bfloat16
    for sigma in (0.3, 0.6):
        b = np.clip(a + rng.normal(0, sigma, a.shape), -1, 1
                    ).astype(np.float32)
        ref = float(jax.jit(lambda x, y: jmodel.apply(variables, x, y))(
            jnp.asarray(a), jnp.asarray(b)))
        ref32 = float(jax.jit(lambda x, y: jmodel32.apply(variables, x, y))(
            jnp.asarray(a), jnp.asarray(b)))
        got = model(torch.from_numpy(a), torch.from_numpy(b)).item()
        np.testing.assert_allclose(got, ref, rtol=5e-3)
        assert abs(got - ref32) > 5e-3 * abs(ref32)
    assert tlpips.init_lpips(device="cpu").dtype == torch.float32
    assert tlpips.init_lpips(device="cpu",
                             dtype=torch.bfloat16).dtype == torch.bfloat16
