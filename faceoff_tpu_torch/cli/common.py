"""Shared CLI plumbing, counterpart of `faceoff_tpu/cli/common.py`: the
model-size, curation and multi-host flags, the VQVAE built from them, and
the model of an inference CLI restored from a checkpoint."""

from __future__ import annotations

from typing import Optional

import torch

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.checkpoint import CheckpointManager
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.train.state import TrainState, create_train_state


def add_model_flags(p) -> None:
    g = p.add_argument_group(
        "model size (must match the trained checkpoint)")
    g.add_argument("--channel", type=int, default=128)
    g.add_argument("--n_res_block", type=int, default=2)
    g.add_argument("--n_res_channel", type=int, default=32)
    g.add_argument("--embed_dim", type=int, default=64)
    g.add_argument("--n_embed", type=int, default=512)
    g.add_argument("--no_pallas", action="store_true",
                   help="refused: the port always runs its CUDA kernels on "
                        "the card")
    g.add_argument("--remat", action="store_true",
                   help="recompute encoder/decoder activations in the "
                        "backward (less memory, more compute); checkpoints "
                        "are interchangeable with remat off")
    g.add_argument("--remat_scope", choices=["all", "decoder", "encoder"],
                   default="all",
                   help="with --remat: which submodules recompute")
    g.add_argument("--remat_lpips", action="store_true",
                   help="recompute the LPIPS VGG towers in the backward")


def add_curation_flags(p) -> None:
    """Dataset curation: a JSON list of video directories to skip."""
    p.add_argument(
        "--exclude_list", default=None,
        help="JSON file of video directory names/paths to skip")


def add_multihost_flags(p) -> None:
    """The JAX package's process-coordination flags; the port refuses them
    until its multi-device slice (ROADMAP.md, Queue 1 item 6)."""
    g = p.add_argument_group("multi-host coordination (with --multihost)")
    g.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total process count")
    g.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")


def model_config(args, in_channels: int = 6) -> ModelConfig:
    return ModelConfig(
        in_channels=in_channels,
        channel=args.channel,
        n_res_block=args.n_res_block,
        n_res_channel=args.n_res_channel,
        embed_dim=args.embed_dim,
        n_embed=args.n_embed,
        commitment_beta=getattr(args, "commitment_beta", 1.0),
        remat=getattr(args, "remat", False),
        remat_scope=getattr(args, "remat_scope", "all"),
    )


def refuse_no_pallas(parser, args) -> None:
    """Exit with an error for --no_pallas: the port has no path around
    its CUDA kernels on the card."""
    if args.no_pallas:
        parser.error("--no_pallas: the port has no path around its CUDA "
                     "kernels on the card (ROADMAP.md, North star)")


def build_vqvae(args, in_channels: int = 6, *, device: DeviceLike = None,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> VQVAE:
    """The VQVAE of the flags on `device` (CUDA unless named), parameters
    in `dtype` (float32 for training, whose step computes in bf16 on
    CUDA), random weights from `seed` (args.seed by default)."""
    seed = getattr(args, "seed", 0) if seed is None else seed
    return VQVAE(model_config(args, in_channels), dtype=dtype,
                 device=device,
                 generator=torch.Generator().manual_seed(seed))


def restore_for_inference(args, device: DeviceLike = None) -> TrainState:
    """The VQVAE of the flags on `device`, in bf16 on CUDA and float32 on
    the CPU (as the JAX CLIs build it in bf16 on their accelerator), with
    the weights and EMA codebooks of checkpoint --ckpt (the latest when
    None or 'latest') from --checkpoint_dir."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    state = create_train_state(build_vqvae(args, device=dev, dtype=dtype))
    step = None if args.ckpt in (None, "latest") else int(args.ckpt)
    CheckpointManager(args.checkpoint_dir).restore_weights(state, step)
    print(f"restored checkpoint step {state.step}", flush=True)
    return state
