"""Parity of the port's streaming serving path with the JAX package.

The same tiny models and frames as tests/test_streaming.py, float32 on
the CPU, the JAX weights carried over by `io.convert.from_jax_variables`,
and the same tolerance (atol 2e-4, rtol 1e-3). Also: entry points refuse
to run on the CPU unless asked, and the port imports nothing of JAX.
"""

import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.data import synthetic as jsynthetic
from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.serve import SwapSession as JaxSwapSession
from faceoff_tpu.serve import make_stream_steps as jax_make_stream_steps
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.io.convert import from_jax_variables
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.serve import (StreamingSwapper, SwapSession,
                                     make_stream_steps, stream_video)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(in_channels=6, channel=16, n_res_block=1, n_res_channel=8,
            embed_dim=8, n_embed=32)
TOL = dict(atol=2e-4, rtol=1e-3)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny; one intra-op thread per test worker keeps
    the parallel test run from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_model(cfg_items):
    """A JAX model and its variables (seed 0), once per configuration; the
    parameters do not depend on the clip's length or batch."""
    jmodel = JaxVQVAE(**dict(cfg_items), dtype=jnp.float32, use_pallas=False)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 2, 32, 32, 6)),
                            train=False)
    return jmodel, variables


def _port(cfg, variables):
    tmodel = VQVAE(ModelConfig(**cfg), dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(
        from_jax_variables(variables["params"], variables["vq"]), strict=True
    )
    return tmodel


def _pair(b, t, hw, seed=0, **kw):
    """(jax model, variables, port model with the same weights, video)."""
    cfg = dict(TINY, **kw)
    jmodel, variables = _jax_model(tuple(sorted(cfg.items())))
    video = np.random.default_rng(seed).uniform(
        -1, 1, (b, t, hw, hw, 6)).astype(np.float32)
    return jmodel, variables, _port(cfg, variables), video


@pytest.mark.parametrize(
    "t,b,layers,kernel,delay",
    [(7, 1, 3, 3, 3), (2, 1, 3, 3, 3), (5, 2, 3, 3, 3), (6, 1, 2, 3, 2),
     (6, 1, 1, 3, 1), (6, 1, 2, 5, 4)],
)
def test_stream_matches_jax_offline(t, b, layers, kernel, delay):
    """Streamed == the JAX offline clip forward, incl. a clip shorter than
    the delay (t=2), two concurrent streams and other postnet shapes."""
    jmodel, variables, tmodel, video = _pair(
        b, t, 32, seed=t + layers + kernel,
        temporal_postnet_layers=layers, temporal_kernel=kernel,
    )
    ref, _ = jmodel.apply(variables, jnp.asarray(video), train=False)
    sw = StreamingSwapper(tmodel, height=32, width=32, batch=b, device="cpu")
    assert sw.delay == delay
    got = stream_video(tmodel, torch.from_numpy(video), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_push_flush_bookkeeping():
    _, _, model, video = _pair(1, 6, 32, seed=3)
    v = torch.from_numpy(video)
    sw = StreamingSwapper(model, height=32, width=32, device="cpu")
    outs = []
    for i in range(6):
        out = sw.push(v[:, i])
        if i < sw.delay:
            assert out is None
        else:
            outs.append(out)
    tail = sw.flush()
    assert len(tail) == sw.delay and len(outs) + len(tail) == 6
    first = torch.stack(outs + tail, dim=1)
    sw.reset()
    outs2 = [o for o in (sw.push(v[:, i]) for i in range(6)) if o is not None]
    assert torch.equal(first, torch.stack(outs2 + sw.flush(), dim=1))


def test_stream_rejects_even_kernel():
    model = VQVAE(ModelConfig(**TINY, temporal_kernel=2), device="cpu",
                  dtype=torch.float32)
    with pytest.raises(ValueError, match="odd temporal kernel"):
        StreamingSwapper(model, height=32, width=32, device="cpu")


def test_push_after_flush_raises():
    _, _, model, video = _pair(1, 4, 32, seed=8)
    v = torch.from_numpy(video)
    sw = StreamingSwapper(model, height=32, width=32, device="cpu")
    for i in range(4):
        sw.push(v[:, i])
    sw.flush()
    with pytest.raises(RuntimeError, match="reset"):
        sw.push(v[:, 0])
    with pytest.raises(RuntimeError, match="already flushed"):
        sw.push_many(v.transpose(0, 1))
    with pytest.raises(RuntimeError, match="reset"):
        sw.flush()
    sw.reset()
    assert sw.push(v[:, 0]) is None


def test_push_many_matches_push():
    """Uneven groups (4 + 5 frames), then the warm-up accounting of a
    fresh stream's first push_many."""
    _, _, model, video = _pair(1, 9, 32, seed=11)
    v = torch.from_numpy(video)
    sw1 = StreamingSwapper(model, height=32, width=32, device="cpu")
    ref = [o for o in (sw1.push(v[:, i]) for i in range(9)) if o is not None]
    ref += sw1.flush()
    sw2 = StreamingSwapper(model, height=32, width=32, device="cpu")
    frames = v.transpose(0, 1)  # (T, B, H, W, C)
    got = sw2.push_many(frames[:4])
    assert len(got) == 4 - sw2.delay
    got += sw2.push_many(frames[4:]) + sw2.flush()
    assert len(got) == len(ref) == 9
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _jax_layout(state):
    """The port's state as numpy in the JAX package's layout: ring buffers
    (B, C, k-1, H, W) -> (B, k-1, H, W, C)."""
    return {"bufs_b": [b.permute(0, 2, 3, 4, 1).numpy()
                       for b in state["bufs_b"]],
            "bufs_t": [b.permute(0, 2, 3, 4, 1).numpy()
                       for b in state["bufs_t"]],
            "s": int(state["s"])}


@pytest.mark.parametrize("b", [1, 2])
def test_stream_steps_match_jax(b):
    """Every push and flush of the functional steps, valid or warm-up
    output, and the state after it, against JAX's make_stream_steps on
    the same weights."""
    jmodel, variables, tmodel, video = _pair(b, 5, 32, seed=20 + b)
    j_init, j_push, j_flush, j_delay, _ = jax_make_stream_steps(
        jmodel, variables)
    t_init, t_push, t_flush, t_delay, _ = make_stream_steps(
        tmodel, device="cpu")
    assert t_delay == j_delay == 3
    jstate, tstate = j_init(b, 32, 32), t_init(b, 32, 32)
    assert tstate["s"].dtype == torch.int32 and tstate["s"].shape == ()
    assert all(t.dtype == torch.float32 for t in tstate["bufs_b"])
    calls = [("push", i) for i in range(5)] + [("flush", 5)] * j_delay
    for kind, i in calls:
        if kind == "push":
            jstate, jout = j_push(jstate, jnp.asarray(video[:, i]))
            tstate, tout = t_push(tstate, torch.from_numpy(video[:, i]))
        else:
            jstate, jout = j_flush(jstate, jnp.int32(i))
            tstate, tout = t_flush(tstate, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        got = _jax_layout(tstate)
        assert got["s"] == int(jstate["s"])
        for key in ("bufs_b", "bufs_t"):
            assert len(got[key]) == len(jstate[key])
            for g, w in zip(got[key], jstate[key]):
                np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_push_step_leaves_its_state_unchanged():
    """push_step and flush_step are pure: the state passed in stays
    bitwise as it was, so a caller may keep it and push again."""
    _, _, model, video = _pair(1, 4, 32, seed=30)
    init, push, flush, _, _ = make_stream_steps(model, device="cpu")
    state = init(1, 32, 32)
    for i in range(3):
        state, _ = push(state, torch.from_numpy(video[:, i]))
    kept = {k: ([t.clone() for t in v] if isinstance(v, tuple) else v.clone())
            for k, v in state.items()}
    new, out = push(state, torch.from_numpy(video[:, 3]))
    again, out2 = push(state, torch.from_numpy(video[:, 3]))
    flush(state, torch.tensor(4, dtype=torch.int32))
    for key in ("bufs_b", "bufs_t"):
        for t, k in zip(state[key], kept[key]):
            assert torch.equal(t, k)
        for t, k in zip(new[key], again[key]):
            assert torch.equal(t, k)
    assert torch.equal(state["s"], kept["s"]) and int(new["s"]) == 4
    assert torch.equal(out, out2)


def test_push_many_step_equals_push_steps():
    _, _, model, video = _pair(2, 5, 32, seed=31)
    init, push, _, _, push_many = make_stream_steps(model, device="cpu")
    v = torch.from_numpy(video)
    s1 = init(2, 32, 32)
    outs = []
    for i in range(5):
        s1, out = push(s1, v[:, i])
        outs.append(out)
    s2, many = push_many(init(2, 32, 32), v.transpose(0, 1))
    assert many.shape == (5, 2, 32, 32, 6)
    assert torch.equal(many, torch.stack(outs))
    for key in ("bufs_b", "bufs_t"):
        for a, b in zip(s1[key], s2[key]):
            assert torch.equal(a, b)
    assert int(s1["s"]) == int(s2["s"]) == 5


def _swap_frames(hw=32, t=5):
    """The frames of tests/test_streaming.py:109-160."""
    src_f, src_l, tgt_f, tgt_l = [], [], [], []
    for i in range(t):
        for frames, lms_list, color in (
            (src_f, src_l, (205, 165, 135)),
            (tgt_f, tgt_l, (150, 120, 200)),
        ):
            img = np.full((hw, hw, 3), 30, np.uint8)
            lms = jsynthetic.face_landmarks(
                (hw // 2 + (i % 3) - 1, hw // 2), hw // 4
            )
            jsynthetic.draw_face(img, lms, color)
            frames.append(img)
            lms_list.append(lms.astype(np.float32))
    return src_f, src_l, tgt_f, tgt_l


@pytest.fixture(scope="module")
def swap_pair():
    jmodel, variables = _jax_model(tuple(sorted(TINY.items())))
    return jmodel, variables, _port(TINY, variables)


def test_swap_session_matches_jax(swap_pair):
    jmodel, variables, tmodel = swap_pair
    src_f, src_l, tgt_f, tgt_l = _swap_frames()
    jsess = JaxSwapSession(jmodel, variables, height=32, width=32)
    tsess = SwapSession(tmodel, height=32, width=32, device="cpu")
    ref, got = [], []
    for i in range(5):
        r = jsess.push(src_f[i], src_l[i], tgt_f[i], tgt_l[i])
        g = tsess.push(src_f[i], src_l[i], tgt_f[i], tgt_l[i])
        assert (r is None) == (g is None)
        if r is not None:
            ref.append(np.asarray(r))
            got.append(g.numpy())
    ref += [np.asarray(o) for o in jsess.flush()]
    got += [o.numpy() for o in tsess.flush()]
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.shape == (32, 32, 3)
        np.testing.assert_allclose(a, b, **TOL)


def test_swap_session_push_many_matches_push(swap_pair):
    _, _, tmodel = swap_pair
    src_f, src_l, tgt_f, tgt_l = _swap_frames()
    s1 = SwapSession(tmodel, height=32, width=32, device="cpu")
    ref = [o for o in (s1.push(src_f[i], src_l[i], tgt_f[i], tgt_l[i])
                       for i in range(5)) if o is not None] + s1.flush()
    s2 = SwapSession(tmodel, height=32, width=32, device="cpu")
    got = s2.push_many(src_f[:3], src_l[:3], tgt_f[:3], tgt_l[:3])
    got += s2.push_many(src_f[3:], src_l[3:], tgt_f[3:], tgt_l[3:])
    got += s2.flush()
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_entry_points_refuse_cpu_unless_asked(monkeypatch, swap_pair):
    _, _, tmodel = swap_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSwapper(tmodel, height=32, width=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwapSession(tmodel, height=32, width=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_video(tmodel, torch.zeros((1, 2, 32, 32, 6)))


def test_session_refuses_model_on_another_device(swap_pair):
    _, _, tmodel = swap_pair
    with pytest.raises(ValueError, match="lives on cpu"):
        SwapSession(tmodel, height=32, width=32, device="meta")


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "scipy",
            "faceoff_tpu", "PIL", "torchvision", "imageio")


def test_port_imports_no_jax_no_cv2_no_reference_package():
    """In a fresh interpreter where importing JAX, flax, optax, orbax,
    cv2, scipy, PIL, torchvision, imageio or the faceoff_tpu package
    raises, every module of the port, chip_smoke, bench_torch and
    tools/asp_check_torch.py (without running them) still import."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "faceoff_tpu_torch").rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        blocked = {_BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in blocked:
                    raise ImportError("blocked: " + name)
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in blocked:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        for m in {modules!r} + ["chip_smoke", "bench_torch",
                                "tools.asp_check_torch"]:
            importlib.import_module(m)
        loaded = sorted(n for n in sys.modules if n.split(".")[0] in blocked)
        assert not loaded, loaded
        print("ok", len({modules!r}) + 3)
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == f"ok {len(modules) + 3}"
    assert "faceoff_tpu_torch.ops.warp_cuda" in modules
    assert {"faceoff_tpu_torch.cli.swap", "faceoff_tpu_torch.cli.evaluate",
            "faceoff_tpu_torch.evaluation.frechet"} <= set(modules)
    assert {"faceoff_tpu_torch.models.discriminators",
            "faceoff_tpu_torch.losses.gan", "faceoff_tpu_torch.train.gan",
            "faceoff_tpu_torch.train.mocogan", "faceoff_tpu_torch.train.vqgan",
            "faceoff_tpu_torch.cli.train_faceoff_gan"} <= set(modules)
    assert {"faceoff_tpu_torch.serve.export",
            "faceoff_tpu_torch.cli.export"} <= set(modules)
    assert {"faceoff_tpu_torch.cli.encode",
            "faceoff_tpu_torch.cli.train_alignment",
            "faceoff_tpu_torch.cli.train_faceoff",
            "faceoff_tpu_torch.models.vqvae_b2f",
            "faceoff_tpu_torch.models.alignment",
            "faceoff_tpu_torch.train.alignment",
            "faceoff_tpu_torch.losses.contrastive",
            "faceoff_tpu_torch.parallel",
            "faceoff_tpu_torch.parallel.collectives",
            "faceoff_tpu_torch.parallel.mesh",
            "faceoff_tpu_torch.train.shardmap_step"} <= set(modules)
    # compute over a clip sharded in time
    assert {"faceoff_tpu_torch.models.vqvae", "faceoff_tpu_torch.ops.vq",
            "faceoff_tpu_torch.train.train_step"} <= set(modules)
    # mp4 in and out
    assert {"faceoff_tpu_torch.io.mp4", "faceoff_tpu_torch.io.mpeg4",
            "faceoff_tpu_torch.ops.mpeg4_cuda"} <= set(modules)
