"""Metrics, tracing and failure handling for the trainer, counterpart of
`faceoff_tpu/train/observability.py`.

  * MetricsWriter: an append-only JSONL log, one record a step, in the JAX
    package's format. Records are buffered with their tensors and read at
    `flush`, so that the loop does not wait for the card every step.
  * StepProfiler: a `torch.profiler` trace of steps [start, start + count),
    written as a Chrome trace into the log directory.
  * PreemptionGuard: SIGTERM/SIGINT become a request to checkpoint at the
    next step boundary and stop; `should_stop_global` makes the processes
    of a torch.distributed run agree on it.
  * StallWatchdog: exits with STALL_EXIT_CODE when no step finished for
    `timeout` seconds, so that a supervisor restarts with --ckpt latest.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, Optional

import torch

STALL_EXIT_CODE = 117  # distinctive: wrappers can key auto-resume on it


class MetricsWriter:
    """`write` enqueues (tensors stay where they are); `flush` reads the
    values and appends one JSON line a record."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._buffer = []
        self._warned = set()

    def write(self, step: int, metrics: Dict[str, float], **extra) -> None:
        self._buffer.append((step, time.time(), metrics, extra))

    def flush(self) -> None:
        for step, t, metrics, extra in self._buffer:
            record = {"step": step, "time": t, **extra}
            for k, v in metrics.items():
                try:
                    record[k] = float(v)
                except (TypeError, ValueError, RuntimeError) as e:
                    # keep the record, drop the value, and say so once a key
                    if k not in self._warned:
                        self._warned.add(k)
                        print(f"metrics: dropping unreadable '{k}' ({e})",
                              flush=True)
            self._f.write(json.dumps(record) + "\n")
        self._buffer.clear()

    def close(self) -> None:
        self.flush()
        self._f.close()


class StepProfiler:
    """Trace steps [start, start + count) with torch.profiler (host and,
    where there is one, CUDA activity) into `log_dir`."""

    def __init__(self, log_dir: Optional[str], start: int = 10,
                 count: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.count = count
        self._prof = None

    def step(self, step_idx: int) -> None:
        if self.log_dir is None:
            return
        if step_idx == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and step_idx >= self.start + self.count:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"profiler trace written to {path}", flush=True)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


class PreemptionGuard:
    """Installs handlers for `signals`; `should_stop` turns True after any
    fires. The training loop checks it at step boundaries."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or an unsupported signal

    def _handler(self, signum, frame):
        print(f"received signal {signum}: checkpointing at next step "
              f"boundary", flush=True)
        self.should_stop = True

    def should_stop_global(self, device=None) -> bool:
        """Whether any process was asked to stop (an all-reduce MAX of the
        local flags; `device` is where the flag travels: the process's
        CUDA device under NCCL, the CPU under gloo). Signals land per
        process: a save on a local flag alone would leave the others
        waiting at the checkpoint's barrier. One process: the local
        flag."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() <= 1:
            return self.should_stop
        if device is None:
            device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        flag = torch.tensor([1 if self.should_stop else 0], dtype=torch.int32,
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed:
            self.should_stop = True  # the processes that saw no signal too
        return agreed

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


class StallWatchdog:
    """A daemon thread that, after `timeout` seconds without `beat()`,
    prints a diagnosis and exits the process with STALL_EXIT_CODE (a call
    blocked in a hung device runtime cannot be interrupted from Python). 0
    disables it; `stop()` disarms it; `on_stall` replaces the exit in
    tests."""

    def __init__(self, timeout: float = 3600.0, on_stall=None,
                 poll_interval: Optional[float] = None):
        self.timeout = float(timeout)
        self._last_beat = time.monotonic()
        self._stopped = threading.Event()
        self._on_stall = on_stall or self._default_on_stall
        self._poll = poll_interval or min(30.0, max(0.05, self.timeout / 10))
        self._thread = threading.Thread(target=self._watch,
                                        name="stall-watchdog", daemon=True)
        if self.timeout > 0:
            self._thread.start()

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def stop(self) -> None:
        self._stopped.set()

    def _watch(self) -> None:
        while not self._stopped.wait(self._poll):
            idle = time.monotonic() - self._last_beat
            if idle > self.timeout:
                self._on_stall(idle)
                return

    def _default_on_stall(self, idle: float) -> None:
        print(f"STALL: no step heartbeat for {idle:.0f}s (> "
              f"{self.timeout:.0f}s); exiting {STALL_EXIT_CODE} so that a "
              f"supervisor can restart and resume from the last checkpoint.",
              flush=True)
        os._exit(STALL_EXIT_CODE)
