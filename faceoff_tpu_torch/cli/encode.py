"""The tokenizer's command line, twin of `faceoff_tpu/cli/encode.py`:
encode a video to its discrete VQ codes, and optionally decode them back.

    python -m faceoff_tpu_torch.cli.encode --video_dir DIR \
        --checkpoint_dir CKPT --out codes.npz [--decode recon.mp4]

It writes the (T, h, w) top and bottom code maps (`codes_top`,
`codes_bottom`) of the model's `encode_codes` for downstream latent
modelling; --decode writes `decode_code`'s reconstruction as an
`mp4v` MP4 as the JAX CLI writes it (an .avi name: uncompressed AVI;
another suffix is refused). The tokenizer takes 6-channel (face ||
background) composites: a plain video's frame goes into both halves. The
same flags and defaults as the JAX CLI; the model is built as
`cli.common.restore_for_inference` builds it (bf16 on CUDA, float32 on
the CPU) with the weights and codebooks of --ckpt (the latest by
default). Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Any, Dict

import numpy as np
import torch

from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.data.dataset import (_landmark_paths, denormalize,
                                            load_window_frames)
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.video import save_frames_as_video


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", required=True,
                   help="preprocessed video dir (frames + landmarks)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default="codes.npz")
    p.add_argument("--decode", default=None,
                   help="also decode the codes back to an .mp4 video")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--max_frames", type=int, default=32)
    p.add_argument("--fps", type=int, default=25)
    common.add_model_flags(p)
    return p


@torch.no_grad()
def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Encode (and decode) on `device` (CUDA unless named). Returns
    {"codes_top", "codes_bottom"} as written, the model ("model"), the
    composite it encoded ("video6", (1, T, H, W, 6) float32 on the
    device) and, with --decode, the reconstruction ("recon", (T, H, W,
    3) float32 on the host)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.decode and osp.splitext(args.decode)[1].lower() not in (
            ".mp4", ".avi"):
        parser.error(f"--decode {args.decode}: the port writes .mp4 (mp4v) "
                     "or .avi (uncompressed); name such a file")
    dev = resolve_device(device)
    paths = _landmark_paths(args.video_dir)[: args.max_frames]
    if not paths:
        raise SystemExit(f"no frames with landmarks under {args.video_dir}")
    frames, _ = load_window_frames(paths, args.size, dev)
    video = torch.from_numpy(frames).to(dev, torch.float32)[None] / 127.5 - 1.0
    # the frame into both halves of the (face || background) composite
    video6 = torch.cat([video, video], dim=-1)

    model = common.restore_for_inference(args, dev).model
    id_t, id_b = model.encode_codes(video6)
    out = {"codes_top": id_t.cpu().numpy(), "codes_bottom": id_b.cpu().numpy()}
    np.savez(args.out, **out)
    print(f"wrote {args.out}: top {tuple(id_t.shape)} bottom "
          f"{tuple(id_b.shape)} ({model.quantize_t.embed.shape[1]}-way "
          f"codes)", flush=True)
    out.update(model=model, video6=video6)
    if args.decode:
        dec = model.decode_code(id_t, id_b)
        recon = dec[..., :3].to(torch.float32).cpu().numpy()
        save_frames_as_video([denormalize(f) for f in recon], args.decode,
                             fps=args.fps, device=dev)
        print(f"wrote {args.decode} ({recon.shape[0]} frames)", flush=True)
        out["recon"] = recon
    return out


if __name__ == "__main__":
    main()
