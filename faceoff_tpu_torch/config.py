"""Configuration: copies of `faceoff_tpu.config`'s ModelConfig and of the
part of its TrainConfig that the perceptual trainer uses, and a Config
holding the two (the data settings stay on the command line's `args`;
the mesh configuration waits for the multi-device port).

The port keeps its own copy so that it never imports the JAX package.
The defaults are the flagship operating point; the GAN stage's weights
wait for that stage's port.
"""

from __future__ import annotations

import dataclasses


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
    # kept so that the config is the JAX package's: the port sends every
    # codebook size on CUDA to its VQ kernels and reads no flag
    use_pallas_vq: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization configuration of the perceptual trainer."""

    lr: float = 3e-4
    epochs: int = 560
    validate_at: int = 1024
    sched: str = ""  # '' or 'cycle'
    latent_loss_weight: float = 1.0
    perceptual_loss_weight: float = 1.0
    seed: int = 0
    revive_codes_every: int = 0  # 0 = off; else re-seed dead VQ codes
    checkpoint_dir: str = "checkpoints"
    sample_folder: str = "samples"
    keep_checkpoints: int = 5


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
