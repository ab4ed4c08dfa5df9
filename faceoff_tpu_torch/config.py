"""Configuration: copies of `faceoff_tpu.config`'s dataclasses
(ModelConfig, DataConfig, TrainConfig, MeshConfig, the Config that holds
them and `default_config()`), with the same fields and defaults.

The port keeps its own copy so that it never imports the JAX package.
The defaults are the flagship operating point. The perceptual CLI builds
a Config from its flags and reads `model` (the VQVAE, `use_pallas_vq`
included) and `data.train_frames`/`data.val_frames` from it where the
JAX CLI does. The fields that nothing in the JAX package reads
(`MeshConfig`, `default_config()`, the GAN weights on `TrainConfig`)
are kept as parity fields, so that the two packages' configurations stay
field for field the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VQVAE-2 generator hyperparameters.

    6-channel input (source face || background), channel 128, two res
    blocks of width 32, two 512-code x 64-dim EMA codebooks with decay
    0.99, two 3-layer k3 Conv3D temporal postnets.
    """

    in_channels: int = 6
    out_channels: int = 6
    channel: int = 128
    n_res_block: int = 2
    n_res_channel: int = 32
    embed_dim: int = 64
    n_embed: int = 512
    vq_decay: float = 0.99
    vq_eps: float = 1e-5
    commitment_beta: float = 1.0  # scales the commitment (latent) term
    # recompute encoder/postnet/decoder activations in the backward
    # (torch.utils.checkpoint); remat_scope: "all", "encoder" or "decoder"
    remat: bool = False
    remat_scope: str = "all"
    temporal_postnet_layers: int = 3  # Conv3D stack depth per level
    temporal_kernel: int = 3
    # the training quantizer's route: the VQ kernels on CUDA (at every
    # codebook size), or, False (--no_pallas), their plain version on
    # every device; the warp and evaluation are not affected
    use_pallas_vq: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data pipeline configuration: the clips' size and frame counts, the
    perturbation magnitudes (+/-3 px translation, +/-3 deg rotation about
    the eye centre, 90-110 % scale, arc/barrel radial distortion), colour
    jitter, loader workers and the 68-point landmark layout (the jaw left
    out of hull masks)."""

    data_root: str = ""
    resolution: int = 256
    train_frames: int = 30
    val_frames: int = 50
    batch_clips: int = 1  # clips per device per step
    translation_range: int = 3
    rotation_range: float = 3.0
    scale_range: Tuple[int, int] = (90, 110)
    arc_max_deg: float = 30.0
    mask_enlargement: int = 10
    color_jitter: str = ""  # '', 'const' or 'random'
    grayscale: bool = False
    num_workers: int = 8
    prefetch: int = 2
    hull_start: int = 17
    hull_end: int = 67
    stable_points: Tuple[int, ...] = (33, 36, 39, 42, 45)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization configuration. The GAN stage's weights
    (g_loss_*_weight, *_disc_weight, d_loss_weight, disc_lr,
    disc_frames) are parity fields: neither package's GAN CLI reads them
    from here; it takes its own flags."""

    lr: float = 3e-4
    epochs: int = 560
    validate_at: int = 1024
    sched: str = ""  # '' or 'cycle'
    latent_loss_weight: float = 1.0
    perceptual_loss_weight: float = 1.0
    g_loss_2d_weight: float = 0.25
    g_loss_3d_weight: float = 0.25
    image_disc_weight: float = 0.5
    video_disc_weight: float = 0.5
    d_loss_weight: float = 0.1
    disc_lr: float = 3e-4
    disc_frames: int = 16  # discriminator clip window
    seed: int = 0
    revive_codes_every: int = 0  # 0 = off; else re-seed dead VQ codes
    checkpoint_dir: str = "checkpoints"
    sample_folder: str = "samples"
    keep_checkpoints: int = 5


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: `data` shards clips, `time` the frames of each
    clip. A parity field: the CLIs call `parallel.mesh.make_mesh` with
    their own arguments, in both packages."""

    data: int = -1  # -1: all devices
    time: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def default_config() -> Config:
    """The flagship Config; a parity function that no CLI calls, in
    either package."""
    return Config()
