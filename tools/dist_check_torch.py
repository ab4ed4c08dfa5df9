#!/usr/bin/env python3
"""Data-parallel training of the port across several GPUs (or CPU
processes): the shardmap step and the perceptual CLI's --multihost in N
processes, one a device.

    python3 tools/dist_check_torch.py [--world N] [--device cuda|cpu]
                                      [--narrow] [--out DIR] [--time K]

Spawns N processes joined over NCCL (gloo with --device cpu) on a free
localhost port; each holds one GPU (rank r takes cuda:r). Checks:

  step    the perceptual step at the train phase's setting (flagship
          widths, 256 px, T8, random-VGG LPIPS):
          float32 without TF32 for 2 steps on a prepared global batch of
          2 clips a rank
          (rank 0 prepares it and broadcasts it; each rank takes its
          block), against rank 0's one-process step on the whole batch
          from the same weights: every rank's parameters and codebooks
          bitwise equal to rank 0's, and within chip_smoke's train_check
          tolerances of the one-process step (losses 1e-3 relative,
          parameters 2 lr a step with 99 % within 1e-5, codebooks 1e-3
          of their magnitude where it exceeds 1);
  revive  dead codes re-seeded from the ranks' gathered rows: the
          codebooks bitwise equal on every rank;
  stop    `should_stop_global` with only rank 1's flag set: True on all;
  timing  bf16 at b16 a rank (the train phase's batch on each GPU): the
          shardmap step's ms (median of 5 after 2 warm-ups) beside rank
          0's plain step at b16 alone, and the frames/s of the N GPUs
          against one's;
  cli     `cli/train_faceoff_perceptual.main` with --multihost on a PNG
          dataset of 4 videos that rank 0 writes (--resident_data, b4 a
          rank, T8, one step an epoch, 3 epochs): the parameters bitwise
          equal on every rank, one checkpoint (step 3) in the run's
          directory.

With --time K the processes form `make_mesh(time=K)` (data = N / K)
and the checks are those of compute over a clip sharded in time
(K = 4 or 2 on four processes):

  time_step    float32 without TF32, flagship widths, 256 px, one clip a
               data group of T16 (rank 0 prepares it and broadcasts it;
               each rank takes its frame block), 2 steps against rank 0's
               one-process step on the whole batch, with the step
               check's tolerances; bitwise equal on every rank;
  time_revive  the revive from the ranks' blocks: bitwise equal on every
               rank, and within 1e-3 of rank 0's one-process revive on
               the whole batch (relative where a value exceeds 1);
  time_timing  bf16, 128 frames a GPU: K=4 one clip of T512 a data group,
               K=2 two clips of T128; the step's ms (median of 5 after 2
               warm-ups), frames/s of the N GPUs and a GPU's beside rank
               0's plain step at b16 x T8 from the same call, peak memory
               on every rank, the halo exchanges a step and, from one
               profiled step, the device time of their send/receive
               kernels against the step's wall time; the ms of preparing
               the whole clips, which every rank of a data group does.

With --permuted one process runs the step check's one-process side
(float32 without TF32, CHECK_STEPS steps on the global batch of --world
ranks) on the batch as it is, again, and with its clips in two other
orders (the same sums taken in another order), and reports `_compare`'s
measures between them and where the codebook measure peaks: the
rounding spread that the step check's limits must leave room for
(--deterministic: with cuDNN's deterministic algorithms). It exits
non-zero if two runs of one order differ.

Prints, on rank 0, the card's name and power limit (nvidia-smi) and one
JSON line; exits non-zero when a check fails. --narrow runs narrow
widths at 32 px (a CPU rehearsal; --time divides the timing's frames by
16).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from faceoff_tpu_torch.config import ModelConfig  # noqa: E402
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,  # noqa: E402
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import (generate_dataset,  # noqa: E402
                                              synthetic_corpus)
from faceoff_tpu_torch.models import VQVAE  # noqa: E402
from faceoff_tpu_torch.models.lpips import init_lpips  # noqa: E402
from faceoff_tpu_torch.parallel import collectives  # noqa: E402
from faceoff_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                             shard_batch)
from faceoff_tpu_torch.train.observability import PreemptionGuard  # noqa: E402
from faceoff_tpu_torch.train.shardmap_step import (  # noqa: E402
    make_shardmap_train_step)
from faceoff_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_optimizer)
from faceoff_tpu_torch.train.train_step import make_train_step  # noqa: E402

LR = 3e-4
CHECK_B, TIME_B, T = 2, 16, 8  # clips a rank: the check, the timing
CHECK_STEPS, WARMUP, TIMED = 2, 2, 5
# --time K: the check's frames a clip; the timing's clips a data group
# and frames a clip, 128 frames a GPU on four processes
TIME_CHECK_T = 16
TIME_TIMING = {4: (1, 512), 2: (2, 128)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(narrow: bool) -> ModelConfig:
    return (ModelConfig(channel=16, n_res_channel=8, embed_dim=8, n_embed=16)
            if narrow else ModelConfig())


def _state(cfg, dev, dtype=None):
    model = VQVAE(cfg, dtype=torch.float32, device=dev,
                  generator=torch.Generator().manual_seed(0))
    lpips = init_lpips(torch.Generator().manual_seed(1), device=dev,
                       dtype=dtype)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    return state, lpips


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compare(sd_a, sd_b, names, rec_a, rec_b):
    """chip_smoke's train_check measures between two state dicts."""
    diffs = torch.cat([(sd_a[k] - sd_b[k]).abs().ravel().cpu()
                       for k in names])
    cb = [k for k in sd_a if k not in names]
    return {
        "max_loss_rel_err": max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                                for a, b in zip(rec_a, rec_b)
                                for k in ("loss", "mse", "latent",
                                          "perceptual")),
        "max_param_diff": float(diffs.max()),
        "share_params_within_1e-5": float((diffs <= 1e-5).float().mean()),
        "max_codebook_scaled_diff": max(float(
            ((sd_a[k] - sd_b[k]).abs() / sd_b[k].abs().clamp_min(1)).max())
            for k in cb),
    }


def _equal_on_all_ranks(sd) -> bool:
    """Whether every rank's tensors equal rank 0's, bit for bit."""
    same = torch.ones((), device=next(iter(sd.values())).device)
    for v in sd.values():
        ref = v.clone()
        torch.distributed.broadcast(ref, 0)
        same = same * float(torch.equal(ref, v))
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def _corpus(cfg_size, dev, narrow):
    frames, lms, n = synthetic_corpus(8 if narrow else 16, 10 if narrow
                                      else 24, cfg_size, seed=3, device=dev)
    return corpus_from_arrays(frames, lms, n, device=dev)


def worker(rank, world, port, device, narrow, out):
    dev_type = device
    collectives.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       device=dev_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    size = 32 if narrow else 256
    cfg = _config(narrow)
    mesh = make_mesh()
    res = {"world": world, "device": dev_type}

    # step: float32, the global batch prepared once and broadcast
    torch.backends.cudnn.allow_tf32 = False
    corpus = _corpus(size, dev, narrow)
    prepare = make_resident_prepare(corpus, CHECK_B * world, T)
    with torch.no_grad():
        batch = prepare(torch.Generator(device=dev).manual_seed(11),
                        corpus.frames, corpus.landmarks)
    batch = {k: v.contiguous() for k, v in batch.items()
             if k in ("input", "gt")}
    for v in batch.values():
        torch.distributed.broadcast(v, 0)
    local = shard_batch(batch, mesh)
    state, lpips = _state(cfg, dev, torch.float32)
    step = make_shardmap_train_step(state.model, mesh, lpips=lpips,
                                    compute_dtype=torch.float32)
    recs = []
    for _ in range(CHECK_STEPS):
        state, m = step(state, local)
        recs.append({k: float(v) for k, v in m.items()})
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    names = {n for n, _ in state.model.named_parameters()}
    res["step_equal_on_all_ranks"] = _equal_on_all_ranks(sd)

    # revive: every top code and half the bottom's dead
    with torch.no_grad():
        for q, share in ((state.model.quantize_t, 1),
                         (state.model.quantize_b, 2)):
            q.cluster_size[: q.cluster_size.numel() // share] = 0.0
    state.model.revive_codes(local["input"], torch.Generator(device=dev)
                             .manual_seed(5))
    res["revive_equal_on_all_ranks"] = _equal_on_all_ranks(
        {k: v for k, v in state.model.state_dict().items()
         if k.startswith("quantize_")})

    # stop: rank 1's flag alone
    guard = PreemptionGuard(signals=())
    guard.should_stop = rank == 1
    res["stop_agreed"] = guard.should_stop_global(dev)
    del state, lpips, step
    if rank == 0:
        ref, lpips = _state(cfg, dev, torch.float32)
        ref_step = make_train_step(ref.model, lpips=lpips,
                                   compute_dtype=torch.float32)
        ref_recs = []
        for _ in range(CHECK_STEPS):
            ref, m = ref_step(ref, batch)
            ref_recs.append({k: float(v) for k, v in m.items()})
        res["step_vs_one_process"] = _compare(
            sd, ref.model.state_dict(), names, recs, ref_recs)
        res["step_vs_one_process"]["codebook_peak"] = _codebook_detail(
            sd, ref.model.state_dict(), names)
        del ref, lpips, ref_step
    torch.distributed.barrier()

    # timing: bf16 at b16 a rank
    torch.backends.cudnn.allow_tf32 = True
    prepare = make_resident_prepare(corpus, TIME_B, T)
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}

    state, lpips = _state(cfg, dev)
    ms, all_ms = _timed(make_shardmap_train_step(
        state.model, mesh, lpips=lpips, prepare_fn=prepare), state, raw, dev)
    res["shardmap_step_ms"], res["shardmap_step_ms_all"] = ms, all_ms
    del state, lpips
    torch.distributed.barrier()
    if rank == 0:
        state, lpips = _state(cfg, dev)
        ms1, all1 = _timed(make_train_step(state.model, lpips=lpips,
                                           prepare_fn=prepare), state, raw,
                           dev)
        res["plain_step_ms"], res["plain_step_ms_all"] = ms1, all1
        res["frames_per_s"] = world * TIME_B * T / (ms / 1e3)
        res["one_gpu_frames_per_s"] = TIME_B * T / (ms1 / 1e3)
        res["scaling"] = res["frames_per_s"] / (world
                                                 * res["one_gpu_frames_per_s"])
        del state, lpips
    torch.distributed.barrier()

    # cli: --multihost on a PNG dataset rank 0 writes
    from faceoff_tpu_torch.cli import train_faceoff_perceptual as cli

    data = Path(out) / "data"
    if rank == 0:
        generate_dataset(str(data), 4, 10, size, seed=5, device=dev)
    torch.distributed.barrier()
    widths = (["--channel", "16", "--n_res_channel", "8", "--embed_dim",
               "8", "--n_embed", "16"] if narrow else [])
    trainer = cli.main(
        ["--data_root", str(data), "--resident_data", "--batch_size", "4",
         "--train_frames", str(T), "--val_frames", str(T),
         "--size", str(size), "--epoch", "3", "--validate_at", "1000",
         "--num_workers", "2", "--checkpoint_dir", str(Path(out) / "ckpt"),
         "--sample_folder", str(Path(out) / "samples"), "--multihost",
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
         str(world), "--process_id", str(rank), *widths], device=dev_type)
    res["cli_steps"] = trainer.global_step
    res["cli_equal_on_all_ranks"] = _equal_on_all_ranks(
        {k: v.detach() for k, v in trainer.model.state_dict().items()})
    res["cli_checkpoints"] = sorted(os.listdir(trainer.ckpt.directory))
    torch.distributed.barrier()
    if rank == 0:
        with open(Path(out) / "result.json", "w") as f:
            json.dump(res, f)
    collectives.destroy()


def _kill_codes(model):
    """Every top code dead, half of the bottom's."""
    with torch.no_grad():
        for q, share in ((model.quantize_t, 1), (model.quantize_b, 2)):
            q.cluster_size[: q.cluster_size.numel() // share] = 0.0


def _codebooks(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith("quantize_")}


def _profile_halos(step_fn, state, raw, dev):
    """One step under torch.profiler: its wall ms and the device ms of the
    send/receive kernels (the halo exchanges) and of the all-reduces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(state, raw, seed=0)
        _sync(dev)
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def ms(word):
        return sum(e.self_device_time_total for e in kernels
                   if word in e.key) / 1e3

    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "send_recv_device_ms": ms("SendRecv"),
            "all_reduce_device_ms": ms("AllReduce"), "device_busy_ms": busy,
            "halo_share_of_step": ms("SendRecv") / wall}


def time_worker(rank, world, port, device, narrow, out, k):
    """The --time K checks (module docstring) on one process."""
    dev_type = device
    collectives.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       device=dev_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    size = 32 if narrow else 256
    cfg = _config(narrow)
    mesh = make_mesh(time=k)
    clips, clip_t = TIME_TIMING[k]
    if narrow:
        clip_t //= 16
    res = {"world": world, "device": dev_type, "mesh": [mesh.data, k],
           "timing_clips_a_data_group": clips, "timing_frames_a_clip": clip_t,
           "timing_frames_a_gpu": clips * clip_t // k}

    # time_step: float32 without TF32, the global batch prepared once
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames, lms, n = synthetic_corpus(4, max(clip_t, T) + 8, size, seed=3,
                                      device=dev)
    corpus = corpus_from_arrays(frames, lms, n, device=dev)
    del frames
    prepare = make_resident_prepare(corpus, mesh.data, TIME_CHECK_T)
    with torch.no_grad():
        batch = prepare(torch.Generator(device=dev).manual_seed(11),
                        corpus.frames, corpus.landmarks)
    batch = {key: v.contiguous() for key, v in batch.items()
             if key in ("input", "gt")}
    for v in batch.values():
        torch.distributed.broadcast(v, 0)
    local = shard_batch(batch, mesh, time_axis=1)
    state, lpips = _state(cfg, dev, torch.float32)
    step = make_shardmap_train_step(state.model, mesh, lpips=lpips,
                                    compute_dtype=torch.float32)
    recs = []
    for _ in range(CHECK_STEPS):
        state, m = step(state, local)
        recs.append({key: float(v) for key, v in m.items()})
    sd = {key: v.detach().clone()
          for key, v in state.model.state_dict().items()}
    names = {name for name, _ in state.model.named_parameters()}
    res["step_equal_on_all_ranks"] = _equal_on_all_ranks(sd)

    # time_revive: from the ranks' blocks
    _kill_codes(state.model)
    before = {key: v.clone() for key, v in state.model.state_dict().items()}
    state.model.revive_codes(local["input"], torch.Generator(device=dev)
                             .manual_seed(5))
    revived = _codebooks(state.model)
    res["revive_equal_on_all_ranks"] = _equal_on_all_ranks(revived)
    del state, lpips, step
    if rank == 0:
        ref, lpips = _state(cfg, dev, torch.float32)
        ref_step = make_train_step(ref.model, lpips=lpips,
                                   compute_dtype=torch.float32)
        ref_recs = []
        for _ in range(CHECK_STEPS):
            ref, m = ref_step(ref, batch)
            ref_recs.append({key: float(v) for key, v in m.items()})
        res["step_vs_one_process"] = _compare(
            sd, ref.model.state_dict(), names, recs, ref_recs)
        ref.model.load_state_dict(before)
        ref.model.revive_codes(batch["input"], torch.Generator(device=dev)
                               .manual_seed(5))
        want = _codebooks(ref.model)
        res["revive_vs_one_process_scaled_diff"] = max(float(
            ((revived[key] - want[key]).abs()
             / want[key].abs().clamp_min(1)).max()) for key in want)
        del ref, lpips, ref_step
    del batch, local
    torch.distributed.barrier()

    # time_timing: bf16, 128 frames a GPU
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    prepare = make_resident_prepare(corpus, clips, clip_t)
    exchanges = [0]
    exchange = collectives._exchange

    def counted(*args):
        exchanges[0] += 1
        return exchange(*args)

    collectives._exchange = counted
    state, lpips = _state(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step = make_shardmap_train_step(state.model, mesh, lpips=lpips,
                                    prepare_fn=prepare)
    ms, all_ms = _timed(step, state, raw, dev)
    res["time_step_ms"], res["time_step_ms_all"] = ms, all_ms
    res["halo_exchanges_a_step"] = exchanges[0] / (WARMUP + TIMED)
    collectives._exchange = exchange
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    res["peak_memory_bytes_by_rank"] = [None] * world
    torch.distributed.all_gather_object(res["peak_memory_bytes_by_rank"],
                                        peak)
    res["profile"] = (_profile_halos(step, state, raw, dev)
                      if dev.type == "cuda" else None)
    gen = torch.Generator(device=dev).manual_seed(0)
    res["prepare_whole_clips_ms"] = _timed(
        lambda st, r, seed: (st, {"loss": prepare(gen, r["frames"],
                                                  r["landmarks"])["gt"]
                                  .sum()}), None, raw, dev)[0]
    del state, lpips, step
    torch.distributed.barrier()
    if rank == 0:
        state, lpips = _state(cfg, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        ms1, all1 = _timed(make_train_step(
            state.model, lpips=lpips,
            prepare_fn=make_resident_prepare(corpus, TIME_B, T)), state, raw,
            dev)
        res["plain_step_ms"], res["plain_step_ms_all"] = ms1, all1
        res["plain_peak_memory_bytes"] = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
        per_gpu = res["timing_frames_a_gpu"]
        res["frames_per_s"] = world * per_gpu / (ms / 1e3)
        res["frames_per_s_a_gpu"] = per_gpu / (ms / 1e3)
        res["one_gpu_plain_frames_per_s"] = TIME_B * T / (ms1 / 1e3)
        res["a_gpu_against_plain"] = (res["frames_per_s_a_gpu"]
                                      / res["one_gpu_plain_frames_per_s"])
        del state, lpips
        with open(Path(out) / "result.json", "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    collectives.destroy()


def _codebook_detail(sd_a, sd_b, names) -> dict:
    """Where `_compare`'s codebook measure peaks: the tensor, the code
    (column), both values, that code's cluster size, and per quantizer
    the codes whose cluster size moved by more than 1e-3 (an EMA step
    moves a code's size by (1 - decay) = 0.01 for each row that changes
    code)."""
    worst = (-1.0, None, None)
    moved = {}
    for k in sd_a:
        if k in names:
            continue
        d = (sd_a[k] - sd_b[k]).abs() / sd_b[k].abs().clamp_min(1)
        i = int(d.argmax())
        if float(d.reshape(-1)[i]) > worst[0]:
            worst = (float(d.reshape(-1)[i]), k, i)
        if k.endswith("cluster_size"):
            moved[k] = int(((sd_a[k] - sd_b[k]).abs() > 1e-3).sum())
    _, k, i = worst
    code = i % sd_a[k].shape[-1]
    size = sd_b[k.rsplit(".", 1)[0] + ".cluster_size"][code]
    return {"tensor": k, "code": code,
            "values": [float(sd_a[k].reshape(-1)[i]),
                       float(sd_b[k].reshape(-1)[i])],
            "cluster_size": float(size), "codes_moved": moved}


def permuted_check(device: str, narrow: bool, world: int,
                   deterministic: bool = False) -> dict:
    """The step check's one-process run against itself with the global
    batch's clips permuted: `_compare`'s measures for each other order
    (and where the codebook measure peaks), and whether a second run of
    the first order repeats it bit for bit. `deterministic` asks cuDNN
    for deterministic algorithms."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    cfg = _config(narrow)
    corpus = _corpus(32 if narrow else 256, dev, narrow)
    prepare = make_resident_prepare(corpus, CHECK_B * world, T)
    with torch.no_grad():
        batch = prepare(torch.Generator(device=dev).manual_seed(11),
                        corpus.frames, corpus.landmarks)
    batch = {k: v.contiguous() for k, v in batch.items()
             if k in ("input", "gt")}
    n = batch["input"].shape[0]
    orders = {"as_is": list(range(n)), "as_is_again": list(range(n)),
              "reversed": list(range(n))[::-1],
              "rotated": list(range(1, n)) + [0]}
    runs = {}
    for name, order in orders.items():
        st, lpips = _state(cfg, dev, torch.float32)
        step = make_train_step(st.model, lpips=lpips,
                               compute_dtype=torch.float32)
        b = {k: v[order].contiguous() for k, v in batch.items()}
        recs = []
        for _ in range(CHECK_STEPS):
            st, m = step(st, b)
            recs.append({k: float(v) for k, v in m.items()})
        names = {k for k, _ in st.model.named_parameters()}
        runs[name] = ({k: v.detach().clone() for k, v in
                       st.model.state_dict().items()}, recs, names)
        del st, lpips, step
    base, base_recs, names = runs["as_is"]
    res = {"permuted_clips": n, "device": device,
           "cudnn_deterministic": deterministic}
    for name in ("as_is_again", "reversed", "rotated"):
        sd, recs, _ = runs[name]
        res[name] = _compare(sd, base, names, recs, base_recs)
        res[name]["codebook_peak"] = _codebook_detail(sd, base, names)
    res["repeats_bitwise"] = all(torch.equal(runs["as_is_again"][0][k], v)
                                 for k, v in base.items())
    return res


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _timed(step_fn, st, raw, dev):
    """Median ms of TIMED calls after WARMUP, each ending in a read of its
    loss; and every call's ms."""
    times = []
    for _ in range(WARMUP + TIMED):
        _sync(dev)
        t = time.perf_counter()
        st, m = step_fn(st, raw, seed=0)
        float(m["loss"])
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[WARMUP:]), times


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=None,
                   help="processes (default: every visible GPU)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--narrow", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--time", type=int, default=None, choices=sorted(
        TIME_TIMING), help="shard each clip's frames over K processes")
    p.add_argument("--permuted", action="store_true",
                   help="one process: the step check against itself with "
                        "the batch's clips permuted")
    p.add_argument("--deterministic", action="store_true",
                   help="with --permuted: cuDNN's deterministic algorithms")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dist_check_torch: no CUDA device", file=sys.stderr)
        return 1
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    if args.permuted:
        res = permuted_check(args.device, args.narrow, world,
                             args.deterministic)
        if args.device == "cuda":
            res["card"] = _card()
            print(res["card"], flush=True)
        print(json.dumps(res), flush=True)
        return 0 if res["repeats_bitwise"] else 1
    if args.time and world != 4:
        print("dist_check_torch: --time runs on four processes",
              file=sys.stderr)
        return 1
    if args.rank is not None:
        if args.time:
            time_worker(args.rank, world, args.port, args.device,
                        args.narrow, args.out, args.time)
        else:
            worker(args.rank, world, args.port, args.device, args.narrow,
                   args.out)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        port = _free_port()
        env = dict(os.environ, LOCAL_RANK="")
        procs = []
        for r in range(world):
            env_r = dict(env, LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--world", str(world), "--device",
                 args.device, "--out", out, "--rank", str(r), "--port",
                 str(port)] + (["--narrow"] if args.narrow else [])
                + (["--time", str(args.time)] if args.time else []),
                env=env_r))
        rcs = [proc.wait(timeout=1500) for proc in procs]
        if any(rcs):
            print(f"dist_check_torch: ranks exited {rcs}", file=sys.stderr)
            return 1
        with open(Path(out) / "result.json") as f:
            res = json.load(f)
    if args.device == "cuda":
        res["card"] = _card()
        print(res["card"], flush=True)
    print(json.dumps(res), flush=True)
    cmp = res["step_vs_one_process"]
    if args.time:
        ok = (res["revive_vs_one_process_scaled_diff"] <= 1e-3
              and res["halo_exchanges_a_step"] > 0)
    else:
        ok = (res["stop_agreed"] and res["cli_equal_on_all_ranks"]
              and res["cli_steps"] == 3
              and res["cli_checkpoints"] == ["ckpt_00000003.pt"])
    ok = (ok and res["step_equal_on_all_ranks"]
          and res["revive_equal_on_all_ranks"]
          and cmp["max_loss_rel_err"] <= 1e-3
          and cmp["max_param_diff"] <= 2 * LR * CHECK_STEPS + 1e-6
          and cmp["share_params_within_1e-5"] >= 0.99
          and cmp["max_codebook_scaled_diff"] <= 1e-3)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
