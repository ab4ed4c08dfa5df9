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
                   help="train the VQ codebooks through the plain PyTorch "
                        "path instead of the CUDA kernels, on any device "
                        "(the warp keeps its kernel); the inference CLIs "
                        "accept it, as the JAX CLIs do, and evaluate as "
                        "without it")
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
    """Explicit process-coordination flags for --multihost, the JAX
    package's: without them the torchrun environment is read
    (`parallel.collectives.initialize_distributed`)."""
    g = p.add_argument_group("multi-host coordination (with --multihost)")
    g.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total process count")
    g.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")


def multihost_kwargs(args) -> dict:
    """The coordination flags given, for
    `collectives.initialize_distributed`; a partial set exits."""
    flags = {k: getattr(args, k, None) for k in
             ("coordinator_address", "num_processes", "process_id")}
    given = {k: v for k, v in flags.items() if v is not None}
    if given and len(given) != len(flags):
        missing = sorted(set(flags) - set(given))
        raise SystemExit("explicit multi-host coordination needs all three "
                         "flags; missing: "
                         + ", ".join("--" + m for m in missing))
    return given


def init_multihost(args, device: DeviceLike = None) -> None:
    """With --multihost, join the process group before anything else
    touches the device (flags, else the torchrun environment, else one
    process)."""
    if not getattr(args, "multihost", False):
        return
    from faceoff_tpu_torch.parallel import collectives

    collectives.initialize_distributed(**multihost_kwargs(args),
                                       device=device)
    print(f"multihost: process {collectives.get_rank()} of "
          f"{collectives.get_world_size()}", flush=True)


def shared_run_name() -> str:
    """A run directory suffix that every process shares: process 0's
    random nonce, broadcast (a seed-derived one would make reruns of a
    seed collide)."""
    import os

    from faceoff_tpu_torch.parallel import collectives

    return "mh" + collectives.broadcast_object(os.urandom(4).hex())[:5]


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
        use_pallas_vq=not getattr(args, "no_pallas", False),
    )


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
