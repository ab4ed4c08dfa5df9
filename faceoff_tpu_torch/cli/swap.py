"""Swap a source actor's face onto a target video, twin of
`faceoff_tpu/cli/swap.py`:

    python -m faceoff_tpu_torch.cli.swap --source SRC_DIR --target TGT_DIR \
        --checkpoint_dir CKPT [--ckpt STEP] --out swapped.mp4

Given two video directories of the dataset contract (frames and landmark
files) and a checkpoint of the port's trainer, writes the swapped video
and, with --save_streams, the composite, background and naive-blend
streams beside it (`{stem}_composite.mp4`, `{stem}_background.mp4`,
`{stem}_naive_{blend}.mp4`, with the suffix of --out).

The same options and defaults as the JAX CLI. Videos are `mp4v` MP4 as
the JAX CLI writes them through cv2 (`io/video.py`, encoded on the
device); an .avi --out writes uncompressed AVI and another suffix is
refused. The swap geometry runs per frame pair on the host
(`data/geometry.generate_warped_image`) or, with --device_pipeline, on
the device in chunks of --chunk frames (`ops/swap.prepare_swap_batch`,
one launch of the warp kernel a chunk on the card). The model runs in
chunks through `make_eval_step`, or with --streaming frame by frame
through `StreamingSwapper`. Runs on CUDA, the model in bf16;
`main(argv, device="cpu")` runs on the CPU in float32 (the tests).
"""

from __future__ import annotations

import argparse
import os.path as osp
import time
from typing import Dict, List

import numpy as np
import torch

from faceoff_tpu_torch.cli import common
from faceoff_tpu_torch.data import geometry
from faceoff_tpu_torch.data.dataset import (_landmark_paths, denormalize,
                                            load_frame, normalize)
from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io.video import save_frames_as_video
from faceoff_tpu_torch.train.train_step import make_eval_step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True, help="source video dir (face)")
    p.add_argument("--target", required=True,
                   help="target video dir (pose/background)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--ckpt", default=None, help="step (default latest)")
    p.add_argument("--out", default="swapped.mp4",
                   help="the swapped video, an .mp4 (or .avi) file")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--chunk", type=int, default=32,
                   help="frames per device batch")
    p.add_argument("--save_streams", action="store_true",
                   help="also write composite/background/naive streams")
    p.add_argument("--blend", choices=["paste", "poisson"], default="paste",
                   help="how the naive baseline stream is blended (written "
                        "with --save_streams): a hard paste or the "
                        "iterative Laplacian (Poisson) blend")
    p.add_argument("--poisson_iters", type=int, default=1024,
                   help="Jacobi iterations for --blend poisson")
    p.add_argument("--device_pipeline", action="store_true",
                   help="run the hull/Umeyama/warp/composite geometry on "
                        "the device in chunks (the host only decodes "
                        "frames)")
    p.add_argument("--streaming", action="store_true",
                   help="frame-at-a-time online inference (constant "
                        "memory, 3-frame latency) instead of chunked "
                        "batches; prints per-frame latency stats")
    p.add_argument("--frames_per_call", type=int, default=1,
                   help="streaming: K frames per push_many call")
    common.add_model_flags(p)
    return p


def _prepare_on_device(args, src_paths, tgt_paths, n, dev):
    """The three streams from `ops/swap.prepare_swap_batch`, chunk by
    chunk; the tail chunk is padded with zero frames and landmarks, so
    every chunk has the same shape."""
    from faceoff_tpu_torch.ops.swap import prepare_swap_batch

    sources, backgrounds, naives = [], [], []
    for i in range(0, n, args.chunk):
        pairs = list(zip(src_paths[i: min(i + args.chunk, n)],
                         tgt_paths[i: min(i + args.chunk, n)]))
        raw = {"src": [], "src_lms": [], "tgt": [], "tgt_lms": []}
        for sp, tp in pairs:
            s_img, s_lms = load_frame(sp, args.size, dev)
            t_img, t_lms = load_frame(tp, args.size, dev)
            raw["src"].append(s_img)
            raw["src_lms"].append(s_lms)
            raw["tgt"].append(t_img)
            raw["tgt_lms"].append(t_lms)
        pad = args.chunk - len(pairs)
        stacked = {}
        for k, v in raw.items():
            arr = np.stack(v)
            if pad:
                arr = np.pad(arr, ((0, pad),) + ((0, 0),) * (arr.ndim - 1))
            stacked[k] = torch.from_numpy(arr).to(dev)
        with torch.no_grad():
            streams = prepare_swap_batch(
                stacked["src"], stacked["src_lms"], stacked["tgt"],
                stacked["tgt_lms"], poisson=args.blend == "poisson",
                poisson_iters=args.poisson_iters)
        keep = len(pairs)
        for out, key in ((sources, "source"), (backgrounds, "background"),
                         (naives, "combined")):
            out += list(streams[key][:keep].cpu().numpy())
    return sources, backgrounds, naives


def _prepare_on_host(args, src_paths, tgt_paths, n, dev):
    """The three streams from `data/geometry.generate_warped_image`, one
    frame pair at a time."""
    sources, backgrounds, naives = [], [], []
    for sp, tp in zip(src_paths[:n], tgt_paths[:n]):
        s_img, s_lms = load_frame(sp, args.size, dev)
        t_img, t_lms = load_frame(tp, args.size, dev)
        out = geometry.generate_warped_image(
            s_lms, t_lms, s_img, t_img, poisson=args.blend == "poisson")
        sources.append(normalize(out["source_face_transformed"]))
        backgrounds.append(normalize(out["target_without_face_features"]))
        naives.append(normalize(out["combined"]))
    return sources, backgrounds, naives


def main(argv=None, device: DeviceLike = None) -> Dict:
    """Swap, write the videos, and return what was computed: "frames"
    (the swapped uint8 frames), the float streams in [-1, 1] "sources",
    "backgrounds" and "naives", "naive_nonfinite_share", "latency_ms"
    (streaming: per emitted frame), "seconds" ("prepare" for the
    geometry, "model" for the VQVAE, both ending in a read of their
    results on the host) and "step", the checkpoint's."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if osp.splitext(args.out)[1].lower() not in (".mp4", ".avi"):
        parser.error(f"--out {args.out}: the port writes .mp4 (mp4v) or "
                     ".avi (uncompressed); name such a file")
    dev = resolve_device(device)

    src_paths = _landmark_paths(args.source)
    tgt_paths = _landmark_paths(args.target)
    n = min(len(src_paths), len(tgt_paths))
    if args.max_frames:
        n = min(n, args.max_frames)
    if n == 0:
        raise SystemExit("no overlapping frames with landmarks")

    t0 = time.perf_counter()
    prepare = _prepare_on_device if args.device_pipeline else _prepare_on_host
    sources, backgrounds, naives = prepare(args, src_paths, tgt_paths, n, dev)
    seconds = {"prepare": time.perf_counter() - t0}
    nonfinite = float(np.mean([1.0 - np.isfinite(f).mean() for f in naives]))
    if nonfinite:
        print(f"naive stream: a share {nonfinite:.6f} of its values is not "
              f"finite (the Poisson iteration diverges: ROADMAP.md, Queue 3)",
              flush=True)

    state = common.restore_for_inference(args, dev)
    t0 = time.perf_counter()
    latency: List[float] = []
    if args.streaming:
        frames_out = _run_streaming(args, state, sources, backgrounds, dev,
                                    latency)
    else:
        frames_out = _run_chunked(args, state, sources, backgrounds, n, dev)
    seconds["model"] = time.perf_counter() - t0

    save_frames_as_video(frames_out, args.out, fps=args.fps, device=dev)
    print(f"wrote {args.out} ({len(frames_out)} frames)", flush=True)
    if args.save_streams:
        stem, ext = osp.splitext(args.out)
        names = [f"{stem}_composite{ext}", f"{stem}_background{ext}",
                 f"{stem}_naive_{args.blend}{ext}"]
        for name, stream in zip(names, (sources, backgrounds, naives)):
            save_frames_as_video([denormalize(f) for f in stream], name,
                                 fps=args.fps, device=dev)
        print("wrote " + ", ".join(names), flush=True)
    return {"frames": frames_out, "sources": sources,
            "backgrounds": backgrounds, "naives": naives,
            "naive_nonfinite_share": nonfinite, "latency_ms": latency,
            "seconds": seconds, "step": state.step}


def _run_streaming(args, state, sources, backgrounds, dev, lat_ms):
    """Frame-at-a-time inference through `StreamingSwapper` (constant
    memory, `delay` frames of latency); with --frames_per_call K, K
    frames a `push_many` call. Appends each emitted frame's latency to
    `lat_ms` (a K-frame call's time shared among its frames)."""
    from faceoff_tpu_torch.serve import StreamingSwapper

    sw = StreamingSwapper(state.model, height=args.size, width=args.size,
                          device=dev)
    k = max(1, args.frames_per_call)
    stacked = [torch.from_numpy(np.concatenate([s, b], axis=-1)[None])
               for s, b in zip(sources, backgrounds)]
    frames_out = []
    for i in range(0, len(stacked), k):
        group = stacked[i: i + k]
        t0 = time.perf_counter()
        if k > 1:
            outs = sw.push_many(torch.stack(group).to(dev))
        else:
            out = sw.push(group[0].to(dev))
            outs = [] if out is None else [out]
        if outs:
            outs = [o.cpu().numpy() for o in outs]  # a read: the real end
            dt_ms = (time.perf_counter() - t0) * 1e3
            lat_ms += [dt_ms / len(group)] * len(outs)
            frames_out += [denormalize(o[0, ..., :3]) for o in outs]
    for out in sw.flush():
        frames_out.append(denormalize(out.cpu().numpy()[0, ..., :3]))
    if len(lat_ms) > 2:
        steady = np.asarray(sorted(lat_ms[1:]))  # without the first frame
        print(f"streaming latency/frame: mean {steady.mean():.1f} ms, "
              f"p50 {steady[len(steady) // 2]:.1f} ms, "
              f"p90 {steady[int(len(steady) * 0.9)]:.1f} ms "
              f"(pipeline delay {sw.delay} frames)", flush=True)
    return frames_out


def _run_chunked(args, state, sources, backgrounds, n, dev):
    """The VQVAE over chunks of --chunk frames, the tail chunk padded with
    zero frames (one clip of the chunk's length a call)."""
    eval_step = make_eval_step(state.model)
    frames_out = []
    for i in range(0, n, args.chunk):
        chunk_src = np.stack(sources[i: i + args.chunk])
        chunk_bg = np.stack(backgrounds[i: i + args.chunk])
        keep = len(chunk_src)
        pad = args.chunk - keep
        if pad:
            chunk_src = np.pad(chunk_src, ((0, pad), (0, 0), (0, 0), (0, 0)))
            chunk_bg = np.pad(chunk_bg, ((0, pad), (0, 0), (0, 0), (0, 0)))
        batch = {
            "input": torch.from_numpy(
                np.concatenate([chunk_src, chunk_bg], axis=-1)[None]).to(dev),
            "gt": torch.zeros((1, args.chunk, args.size, args.size, 3),
                              device=dev),
        }
        out, _ = eval_step(state, batch)
        out_np = out[0, :keep].to(torch.float32).cpu().numpy()
        frames_out += [denormalize(f) for f in out_np]
        print(f"swapped {min(i + args.chunk, n)}/{n} frames", flush=True)
    return frames_out


if __name__ == "__main__":
    main()
