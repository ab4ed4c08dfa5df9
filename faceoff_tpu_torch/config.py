"""Model configuration: a copy of `faceoff_tpu.config.ModelConfig`.

The port keeps its own copy so that it never imports the JAX package.
The defaults are the flagship operating point.
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
