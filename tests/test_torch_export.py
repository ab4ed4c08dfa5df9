"""The port's serving bundle (`serve/export.py`, `cli/export.py`) against
the live model and the JAX package's export, at the sizes of
tests/test_export.py (channel 16, 32 px, 4 frames), float32 on the CPU.

The exported programs must reproduce the live model (1e-5) and the JAX
package's exported forward on the same weights (atol 2e-4, rtol 1e-3,
tests/test_streaming.py's tolerance); the bundle must run from its files
in an interpreter that cannot import the port or JAX; the loader refuses
a JAX bundle; the command line restores a checkpoint, exports it and
refuses what a torch program cannot be.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.cli import export as jcli
from faceoff_tpu.models import VQVAE as JaxVQVAE
from faceoff_tpu.serve import export as jexport
from faceoff_tpu_torch.cli import export as tcli
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.convert import from_jax_variables
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.serve import export as texport
from faceoff_tpu_torch.serve.streaming import make_stream_steps
from faceoff_tpu_torch.train.state import create_train_state

SIZE, FRAMES = 32, 4
WIDTHS = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8,
              n_embed=32)
NARROW = ["--channel", "16", "--n_res_block", "1", "--n_res_channel", "8",
          "--embed_dim", "8", "--n_embed", "32"]
TOL = dict(atol=2e-4, rtol=1e-3)
EXACT = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model and variables (seed 0), the port's model on the same
    weights, and a clip in [-1, 1] as numpy."""
    jmodel = JaxVQVAE(in_channels=6, **WIDTHS, dtype=jnp.float32,
                      use_pallas=False)
    variables = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, FRAMES, SIZE, SIZE, 6)), train=False))(
            jax.random.key(0))
    model = VQVAE(ModelConfig(**WIDTHS), dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["vq"]), strict=True)
    video = np.random.default_rng(1).uniform(
        -1, 1, (1, FRAMES, SIZE, SIZE, 6)).astype(np.float32)
    return jmodel, variables, model, video


@pytest.fixture(scope="module")
def bundles(tiny, tmp_path_factory):
    """The port's bundle and the JAX package's, each exported once."""
    jmodel, variables, model, _ = tiny
    root = tmp_path_factory.mktemp("bundles")
    meta = texport.save_bundle(str(root / "torch"), model, frames=FRAMES,
                               size=SIZE)
    jmeta = jexport.save_bundle(str(root / "jax"), jmodel, variables,
                                frames=FRAMES, size=SIZE)
    return root, meta, jmeta


def _live(model, video):
    with torch.no_grad():
        return model(torch.from_numpy(video))[0][..., :3].numpy()


def _stream(push, flush, state, video, total):
    """Push every frame of the clip, then flush `delay` times; every
    output, valid or not, as numpy."""
    outs = []
    for t in range(video.shape[1]):
        state, out = push(state, torch.from_numpy(video[:, t]))
        outs.append(out.numpy())
    for _ in range(3):
        state, out = flush(state, total)
        outs.append(out.numpy())
    return outs


def test_offline_export_matches_live_and_jax(tiny):
    jmodel, variables, model, video = tiny
    program = texport.export_offline(model, frames=FRAMES, size=SIZE)
    with torch.no_grad():
        got = program.module()(torch.from_numpy(video)).numpy()
    assert got.shape == (1, FRAMES, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, _live(model, video), **EXACT)
    want = jexport.export_offline(jmodel, variables, frames=FRAMES,
                                  size=SIZE).call(jnp.asarray(video))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bundle_roundtrip_offline_and_streaming(tiny, bundles):
    _, _, model, video = tiny
    root, meta, _ = bundles
    assert meta["format"] == "faceoff_tpu_torch.serving_bundle.v1"
    assert meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__
    bundle = texport.load_bundle(str(root / "torch"))
    np.testing.assert_allclose(
        bundle.offline(torch.from_numpy(video)).numpy(), _live(model, video),
        **EXACT)

    init_state, push_step, flush_step, delay, _ = make_stream_steps(
        model, device="cpu")
    assert bundle.delay == delay == 3
    want = _stream(push_step, flush_step, init_state(1, SIZE, SIZE), video,
                   torch.tensor(FRAMES, dtype=torch.int32))
    got = _stream(bundle.push, bundle.flush, bundle.init_state(), video,
                  FRAMES)
    assert len(got) == len(want) == FRAMES + delay
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **EXACT)


def _keys(tree):
    """The nested key paths of a dict."""
    if not isinstance(tree, dict):
        return set()
    return {(k,) + sub for k, v in tree.items()
            for sub in ({()} | _keys(v))}


def test_meta_matches_jax(bundles):
    """The keys of JAX's meta.json, apart from the format, the platforms
    and the torch version, and the same shapes and delay."""
    _, meta, jmeta = bundles
    own = {("format",), ("platforms",), ("torch_version",)}
    assert _keys(meta) - own == _keys(jmeta) - own
    for key in ("in_channels",):
        assert meta[key] == jmeta[key]
    for key in ("input_shape", "output_shape"):
        assert meta["offline"][key] == jmeta["offline"][key]
    for key in ("frame_shape", "delay"):
        assert meta["streaming"][key] == jmeta["streaming"][key]


def test_loader_refuses_jax_bundle_and_non_bundle(bundles, tmp_path):
    root, _, _ = bundles
    with pytest.raises(ValueError, match="faceoff_tpu.serving_bundle.v1"):
        texport.load_bundle(str(root / "jax"))
    (tmp_path / "meta.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="not a"):
        texport.load_bundle(str(tmp_path))


def test_bundle_runs_without_the_port(tiny, bundles, tmp_path):
    """A fresh interpreter in which importing the port, the JAX package
    or JAX raises runs the bundle from meta.json and the .pt2 files."""
    _, _, model, video = tiny
    root, _, _ = bundles
    np.save(tmp_path / "video.npy", video)
    script = textwrap.dedent(f"""
        import importlib.abc, json, os, sys
        blocked = ("faceoff_tpu_torch", "faceoff_tpu", "jax", "jaxlib")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in blocked:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch

        bundle, work = {str(root / "torch")!r}, {str(tmp_path)!r}
        meta = json.load(open(os.path.join(bundle, "meta.json")))
        load = lambda f: torch.export.load(os.path.join(bundle, f)).module()
        video = torch.from_numpy(np.load(os.path.join(work, "video.npy")))
        sm = meta["streaming"]
        with torch.no_grad():
            np.save(os.path.join(work, "offline.npy"),
                    load(meta["offline"]["file"])(video).numpy())
            push, flush = load(sm["push_file"]), load(sm["flush_file"])
            state = load(sm["init_file"])()
            outs = []
            for t in range(video.shape[1]):
                state, out = push(state, video[:, t])
                outs.append(out)
            total = torch.tensor(video.shape[1], dtype=torch.int32)
            for _ in range(sm["delay"]):
                state, out = flush(state, total)
                outs.append(out)
        np.save(os.path.join(work, "stream.npy"), torch.stack(outs).numpy())
        loaded = sorted(n for n in sys.modules if n.split(".")[0] in blocked)
        assert not loaded, loaded
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    np.testing.assert_allclose(np.load(tmp_path / "offline.npy"),
                               _live(model, video), **EXACT)
    init_state, push_step, flush_step, _, _ = make_stream_steps(
        model, device="cpu")
    want = _stream(push_step, flush_step, init_state(1, SIZE, SIZE), video,
                   torch.tensor(FRAMES, dtype=torch.int32))
    np.testing.assert_allclose(np.load(tmp_path / "stream.npy"),
                               np.stack(want), **EXACT)


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory):
    """The port's model saved as a checkpoint at step 3."""
    _, _, model, _ = tiny
    ckpt = tmp_path_factory.mktemp("ckpt")
    state = create_train_state(model)
    state.step = 3
    CheckpointManager(str(ckpt)).save(3, state)
    return ckpt


def _cli(ckpt, out, *extra):
    return tcli.main(["--checkpoint_dir", str(ckpt), "--out", str(out),
                      "--size", str(SIZE), "--frames", str(FRAMES), *NARROW,
                      *extra], device="cpu")


def test_cli_export_matches_restored_model(tiny, checkpoint, tmp_path):
    _, _, model, video = tiny
    res = _cli(checkpoint, tmp_path / "b", "--no_pallas")
    assert res["step"] == 3 and res["meta"]["platforms"] == ["cpu"]
    assert set(res["seconds"]) == {"offline.pt2", "streaming_push.pt2",
                                   "streaming_flush.pt2",
                                   "streaming_init.pt2"}
    assert res["bytes"] == sum(p.stat().st_size
                               for p in (tmp_path / "b").iterdir())
    bundle = texport.load_bundle(str(tmp_path / "b"))
    np.testing.assert_allclose(
        bundle.offline(torch.from_numpy(video)).numpy(), _live(model, video),
        **EXACT)
    state, out = bundle.push(bundle.init_state(), torch.from_numpy(
        video[:, 0]))
    assert out.shape == (1, SIZE, SIZE, 6) and int(state["s"]) == 1


def test_cli_no_streaming_writes_no_streaming_files(checkpoint, tmp_path):
    res = _cli(checkpoint, tmp_path / "b", "--no_streaming", "--platforms",
               "cpu")
    assert "streaming" not in res["meta"]
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "meta.json", "offline.pt2"]
    bundle = texport.load_bundle(str(tmp_path / "b"))
    assert not hasattr(bundle, "push")


@pytest.mark.parametrize("platforms,message", [
    (["tpu"], "cuda (gpu) or cpu only"),
    (["cpu", "cuda"], "one device"),
    (["cuda"], "does not match")])
def test_cli_refuses_platforms(checkpoint, tmp_path, capsys, platforms,
                               message):
    with pytest.raises(SystemExit) as exc:
        _cli(checkpoint, tmp_path / "b", "--platforms", *platforms)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "b").exists()


def test_export_functions_refuse_platforms(tiny):
    _, _, model, _ = tiny
    for platforms in (["tpu"], ["tpu", "cpu"], ["gpu"]):
        with pytest.raises(ValueError):
            texport.export_offline(model, frames=FRAMES, size=SIZE,
                                   platforms=platforms)
        with pytest.raises(ValueError):
            texport.export_streaming(model, height=SIZE, width=SIZE,
                                     platforms=platforms)


def test_parser_matches_jax():
    """The same option strings, and the same default for every one."""
    def options(parser):
        return {s: a.default for a in parser._actions for s in
                a.option_strings if s not in ("-h", "--help")}

    assert options(tcli.build_parser()) == options(jcli.build_parser())
