"""Export a trained checkpoint as a self-contained serving bundle
(`torch.export` programs), twin of `faceoff_tpu/cli/export.py`:

    python -m faceoff_tpu_torch.cli.export \
        --checkpoint_dir runs/ckpt --out bundle/ --size 256 --frames 8 \
        [--platforms cuda] [--no_streaming]

The bundle holds the offline (chunked) swap forward and the streaming
per-frame primitives with the trained weights held in the programs
(`serve/export.py`). Load it with
`faceoff_tpu_torch.serve.export.load_bundle(dir)`, or with
`torch.export.load(path).module()` and `meta.json` alone, without the
model class. Runs on CUDA, the model in bf16; `main(argv,
device="cpu")` exports for the CPU in float32 (the tests). A program
runs on the device it was exported for, with the torch version that
wrote it.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict

from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.serve.export import check_platforms, save_bundle


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--ckpt", default=None, help="step (default latest)")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=8,
                   help="offline chunk length (frames per call)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--platforms", nargs="+", default=None,
                   help="the one device to export for: cuda (or gpu) or "
                        "cpu, which must be the device the CLI runs on "
                        "(default: that device)")
    p.add_argument("--no_streaming", action="store_true",
                   help="skip the streaming push/flush exports")
    common.add_model_flags(p)
    for action in p._actions:
        if action.dest == "no_pallas":
            action.help = ("accepted, no effect: the exported programs "
                           "take the plain path whatever the flag, as the "
                           "JAX CLI's do")
    return p


def main(argv=None, device: DeviceLike = None) -> Dict:
    """Restore the checkpoint, write the bundle, and return "meta" (the
    bundle's meta.json), "seconds" (each program's export and save, by
    file name), "bytes" (the bundle's files) and "step"."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    try:
        check_platforms(args.platforms, dev)
    except ValueError as e:
        parser.error(f"--platforms: {e}")

    state = common.restore_for_inference(args, dev)
    seconds: Dict[str, float] = {}
    meta = save_bundle(
        args.out, state.model, frames=args.frames, size=args.size,
        batch=args.batch, streaming=not args.no_streaming,
        platforms=args.platforms, seconds=seconds)
    size = sum(osp.getsize(osp.join(args.out, f))
               for f in [*seconds, "meta.json"])
    print(f"bundle -> {args.out} (platforms: {meta['platforms']}, "
          f"{size} bytes; export s {seconds})", flush=True)
    return {"meta": meta, "seconds": seconds, "bytes": size,
            "step": state.step}


if __name__ == "__main__":
    main()
