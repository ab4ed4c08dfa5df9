"""The port's configuration dataclasses (`faceoff_tpu_torch/config.py`)
against the JAX package's (`faceoff_tpu/config.py`): the same classes,
fields and defaults, and the perceptual CLI filling `Config.data` from
its flags as the JAX CLI does."""

from __future__ import annotations

import dataclasses

import pytest

from faceoff_tpu import config as jconfig
from faceoff_tpu.cli import train_faceoff_perceptual as jcli
from faceoff_tpu_torch import config as tconfig
from faceoff_tpu_torch.cli import train_faceoff_perceptual as tcli
from faceoff_tpu_torch.data.synthetic import generate_dataset


def _fields(cls):
    """(name, default) of each field; a nested dataclass as a dict."""
    out = []
    for f in dataclasses.fields(cls):
        v = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
        out.append((f.name, dataclasses.asdict(v)
                    if dataclasses.is_dataclass(v) else v))
    return out


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig",
                                  "MeshConfig", "Config"])
def test_dataclasses_match_jax(name):
    assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


def test_default_config_matches_jax():
    got = dataclasses.asdict(tconfig.default_config())
    want = dataclasses.asdict(jconfig.default_config())
    assert got == want


def test_perceptual_cli_fills_data_as_jax(tmp_path):
    """The same flags through both CLIs' builders: equal DataConfigs."""
    root = tmp_path / "ds"
    generate_dataset(str(root), n_videos=4, n_frames=4, size=32, seed=1)
    argv = ["--data_root", str(root), "--size", "32", "--batch_size", "2",
            "--train_frames", "3", "--val_frames", "3", "--num_workers", "2",
            "--colorjit", "const", "--gray", "--channel", "16",
            "--n_res_channel", "8", "--embed_dim", "8", "--n_embed", "16",
            "--checkpoint_dir", str(tmp_path / "ck"), "--sample_folder",
            str(tmp_path / "sm")]
    args = tcli.build_parser().parse_args(argv)
    _, cfg = tcli.build_everything(args, device="cpu")
    want = jcli.build_parser().parse_args(argv)
    assert dataclasses.asdict(cfg.data) == dataclasses.asdict(
        jconfig.DataConfig(
            data_root=want.data_root, resolution=want.size,
            train_frames=want.train_frames, val_frames=want.val_frames,
            batch_clips=want.batch_size, color_jitter=want.colorjit,
            grayscale=want.gray, num_workers=want.num_workers))
