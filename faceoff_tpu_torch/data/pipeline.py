"""The host data loader and the copy to the card, counterpart of
`faceoff_tpu/data/pipeline.py`.

`DataLoader` builds clips in a pool of threads (PNG decoding through zlib
and the resampling's torch CPU ops release the interpreter lock) into a
bounded queue, in a seeded epoch order; each clip's Generator is seeded
from (seed, epoch, position) as in the JAX package, so both packages
build the same items. `prefetch_to_device` is the counterpart of the JAX
package's `prefetch_to_device`: a thread copies each host batch into
pinned memory and on to the card with a non-blocking copy on a side
stream, at most `depth` batches ahead.

shard_index/shard_count give each torch.distributed process its own
balanced shard of every epoch's order (the CLIs' --multihost).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from faceoff_tpu_torch.data.dataset import TemporalAlignmentDataset, pack_batch
from faceoff_tpu_torch.device import DeviceLike, resolve_device


class DataLoader:
    """Iterate batches of `batch_clips` clips, each clip seeded from
    (seed, epoch, position in the epoch)."""

    def __init__(
        self,
        dataset: TemporalAlignmentDataset,
        batch_clips: int = 1,
        *,
        shuffle: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        pack: Callable = pack_batch,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_clips = batch_clips
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.pack = pack
        self.epoch = 0
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)

    def __len__(self) -> int:
        per_shard = len(self.dataset) // self.shard_count
        return max(1, per_shard // self.batch_clips)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.shard_count > 1:
            # balanced shards: every process gets len // shard_count items
            per = len(order) // self.shard_count
            if per == 0:
                order = order[[self.shard_index % len(order)]]
            else:
                order = order[self.shard_index:: self.shard_count][:per]
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()

        def load_clip(epoch: int, pos: int) -> Dict[str, np.ndarray]:
            idx = int(order[pos % len(order)])
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + epoch) * 1_000_003 + pos)
            return self.dataset.get_item(idx, rng)

        def _put(item) -> bool:
            """A bounded put that gives up once the consumer is gone."""
            while not abandoned.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futures = [
                        pool.submit(load_clip, self.epoch,
                                    b * self.batch_clips + c)
                        for b in range(n_batches)
                        for c in range(self.batch_clips)
                    ]
                    for b in range(n_batches):
                        if abandoned.is_set():
                            for f in futures:
                                f.cancel()
                            return
                        items = [futures[b * self.batch_clips + c].result()
                                 for c in range(self.batch_clips)]
                        if not _put(self.pack(items)):
                            for f in futures:
                                f.cancel()
                            return
            except Exception as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                _put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            thread.join()
        finally:
            # the consumer stopped early: release the producer and workers
            abandoned.set()
        self.epoch += 1


def prefetch_to_device(iterator, device: DeviceLike = None, depth: int = 2):
    """Yield the dicts of numpy arrays of `iterator` as tensors on
    `device` (CUDA unless named), staged by a background thread at most
    `depth` batches ahead. On CUDA each array goes through pinned memory
    in a non-blocking copy on a side stream; the consumer's stream waits
    for that copy before it uses the batch."""
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    out_q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    abandoned = threading.Event()

    def stage(batch):
        if stream is None:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in
                    batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(dev, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _put(item) -> bool:
        while not abandoned.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not _put(stage(batch)):
                    return
        except Exception as e:  # surface loader errors to the consumer
            _put(e)
        finally:
            _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(done)
                for t in batch.values():
                    t.record_stream(current)
            yield batch
        thread.join()
    finally:
        abandoned.set()
