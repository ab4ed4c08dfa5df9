"""The port's tokenizer and vanilla-trainer command lines on the CPU at
narrow widths (channel 16, 32 px), and the fault of the JAX vanilla
trainer that the port reproduces:

  * cli/encode's code maps against the JAX model's `encode_codes` on the
    same weights (carried by `io.convert.to_jax_variables`) and the same
    composite; its --decode AVI read back equal to the decoded frames;
    the .mp4 refusal.
  * cli/train_faceoff for one epoch with no LPIPS built and a perceptual
    term of 0; its refusals of --resident_data, --device_pipeline,
    --steps_per_call > 1 and --multihost, naming ROADMAP.md Queue 3.
  * the JAX cli/train_faceoff under --resident_data dies with KeyError
    'input' (it drops the prepare function), recorded as
    test_poisson_blend_diverges_in_both_packages records the Poisson
    fault.

Tolerance: the codes equal (at this seed no score is within float32
rounding of a tie: the two packages' indices agree everywhere); the AVI
round trip exact (uint8 frames)."""

import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceoff_tpu.models import VQVAE as JVQVAE
from faceoff_tpu_torch.cli import encode as encode_cli
from faceoff_tpu_torch.cli import train_faceoff as vanilla_cli
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.dataset import denormalize
from faceoff_tpu_torch.data.synthetic import generate_dataset
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.io.convert import to_jax_variables
from faceoff_tpu_torch.io.video import read_video_frames
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.train.state import create_train_state

CFG = ModelConfig(channel=16, n_res_channel=8, embed_dim=8, n_embed=16)
NARROW = ["--channel", "16", "--n_res_channel", "8", "--embed_dim", "8",
          "--n_embed", "16"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("aux_cli")
    generate_dataset(str(root / "ds"), n_videos=2, n_frames=6, size=32)
    return root


@pytest.fixture(scope="module")
def checkpoint(data):
    """A narrow model saved at step 3 (random weights from a seed, the
    EMA state moved off its init so the codebooks are not the init's)."""
    model = VQVAE(CFG, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.quantize_b.cluster_size.fill_(0.5)
    state = create_train_state(model)
    state.step = 3
    CheckpointManager(str(data / "ckpt")).save(3, state)
    return data / "ckpt", model


def test_encode_codes_match_jax(data, checkpoint, tmp_path):
    ckpt, model = checkpoint
    out = tmp_path / "codes.npz"
    res = encode_cli.main(["--video_dir", str(data / "ds" / "video_001"),
                           "--checkpoint_dir", str(ckpt), "--out", str(out),
                           "--size", "32", "--max_frames", "5", *NARROW],
                          device="cpu")
    saved = np.load(out)
    assert sorted(saved.files) == ["codes_bottom", "codes_top"]
    assert saved["codes_top"].shape == (5, 4, 4)
    assert saved["codes_bottom"].shape == (5, 8, 8)
    video6 = res["video6"].numpy()
    assert video6.shape == (1, 5, 32, 32, 6)
    assert np.array_equal(video6[..., :3], video6[..., 3:])

    params, vq = to_jax_variables(model.state_dict())
    jm = JVQVAE(in_channels=6, channel=16, n_res_block=2, n_res_channel=8,
                embed_dim=8, n_embed=16, dtype=jnp.float32)
    jt, jb = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_codes))(
        {"params": params, "vq": _codebooks(vq)}, jnp.asarray(video6))
    assert np.array_equal(saved["codes_top"], np.asarray(jt))
    assert np.array_equal(saved["codes_bottom"], np.asarray(jb))


def _codebooks(vq):
    from faceoff_tpu.ops.vq import VQCodebook

    return {lvl: {"codebook": VQCodebook(**{k: jnp.asarray(v) for k, v in
                                            d["codebook"].items()})}
            for lvl, d in vq.items()}


def test_encode_decode_writes_avi_and_refuses_mp4(data, checkpoint, tmp_path,
                                                  capsys):
    ckpt, _ = checkpoint
    base = ["--video_dir", str(data / "ds" / "video_000"),
            "--checkpoint_dir", str(ckpt), "--out", str(tmp_path / "c.npz"),
            "--size", "32", "--max_frames", "4", *NARROW]
    res = encode_cli.main(base + ["--decode", str(tmp_path / "r.avi")],
                          device="cpu")
    frames = read_video_frames(str(tmp_path / "r.avi"))
    assert len(frames) == 4
    for got, recon in zip(frames, res["recon"]):
        assert np.array_equal(got, denormalize(recon))
    with pytest.raises(SystemExit) as exc:
        encode_cli.main(base + ["--decode", str(tmp_path / "r.mp4")],
                        device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and "Queue 1 item 7b" in err
    assert not os.path.exists(tmp_path / "r.mp4")


def test_train_faceoff_one_epoch_without_lpips(data, tmp_path, monkeypatch):
    from faceoff_tpu_torch.cli import train_faceoff_perceptual as base

    def no_lpips(*a, **k):
        raise AssertionError("the vanilla trainer built an LPIPS")

    monkeypatch.setattr(base, "init_lpips", no_lpips)
    metrics = tmp_path / "m.jsonl"
    trainer = vanilla_cli.main(
        ["--data_root", str(data / "ds"), "--size", "32", "--batch_size", "1",
         "--train_frames", "2", "--val_frames", "2", "--epoch", "1",
         "--validate_at", "1000", "--num_workers", "1", "--metrics_path",
         str(metrics), "--checkpoint_dir", str(tmp_path / "ck"),
         "--sample_folder", str(tmp_path / "sm"), *NARROW], device="cpu")
    records = [__import__("json").loads(l) for l in
               metrics.read_text().splitlines()]
    assert len(records) == trainer.global_step == len(trainer.train_loader)
    assert all(r["perceptual"] == 0.0 and np.isfinite(r["loss"])
               for r in records)
    assert all(abs(r["loss"] - r["mse"] - r["latent"]) <= 1e-6 * r["loss"]
               for r in records)
    ckpts = glob.glob(str(tmp_path / "ck_*" / "ckpt_*.pt"))
    assert len(ckpts) == 1


@pytest.mark.parametrize("flags", [["--resident_data"], ["--device_pipeline"],
                                   ["--steps_per_call", "2"], ["--multihost"]])
def test_train_faceoff_refuses_the_paths_the_jax_cli_breaks(capsys, flags):
    with pytest.raises(SystemExit) as exc:
        vanilla_cli.main(["--data_root", "unused", *flags], device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md, Queue 3" in err and flags[0] in err


def test_train_faceoff_ckpt_latest_without_checkpoint(data, tmp_path, capsys):
    vanilla_cli.main(
        ["--data_root", str(data / "ds"), "--size", "32", "--train_frames",
         "2", "--val_frames", "2", "--num_workers", "1", "--ckpt", "latest",
         "--test", "--checkpoint_dir", str(tmp_path / "ck"),
         "--sample_folder", str(tmp_path / "sm"), *NARROW], device="cpu")
    assert "no checkpoint yet" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "sm_*" / "1_0_0_prediction.avi"))


def test_jax_train_faceoff_resident_data_fault(tmp_path, monkeypatch):
    """The reference's own fault (ROADMAP.md Queue 3): its vanilla CLI
    rebuilds the step without the prepare function, so a resident batch
    of raw frames reaches the model and the step dies on batch['input'].
    Flax's init is jitted here to save its op-by-op compiles; the values
    are the same."""
    from faceoff_tpu.cli import train_faceoff as jcli
    from faceoff_tpu.data import synthetic as jsyn

    orig = fnn.Module.init

    def jitted_init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: orig(self, r, *a, **kwargs))(rngs, *args)

    monkeypatch.setattr(fnn.Module, "init", jitted_init)
    monkeypatch.chdir(tmp_path)
    jsyn.generate_dataset("ds", n_videos=2, n_frames=6, size=32)
    with pytest.raises(KeyError, match="input"):
        jcli.main(["--data_root", "ds", "--resident_data", "--size", "32",
                   "--train_frames", "2", "--val_frames", "2", "--epoch", "1",
                   "--num_workers", "1", "--checkpoint_dir", "ck",
                   "--sample_folder", "sm", "--channel", "8",
                   "--n_res_block", "1", "--n_res_channel", "4",
                   "--embed_dim", "4", "--n_embed", "8"])
