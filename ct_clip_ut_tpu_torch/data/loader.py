"""Batched, multi-threaded, prefetching data loader.

A copy of ct_clip_ut_tpu/data/loader.py (the port imports nothing of the
JAX package). Replaces the reference's torch DataLoader + DistributedSampler
(reference CTClipTrainer.py:88-105). Design:
  * worker threads run the (numpy / host-CPU torch) preprocessing pipeline —
    the CPU-side hot loop #1 of the reference (SURVEY.md 3.1) — while the
    card executes the previous batch;
  * a bounded prefetch queue keeps a steady pipeline without unbounded RAM
    (each preprocessed ctclip volume is 221 MB fp32);
  * shard-aware iteration replaces DistributedSampler: with (num_shards,
    shard_index) set, each process sees its contiguous interleaved subset,
    matching DistributedSampler(shuffle, drop_last) semantics.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


class ShardedSampler:
    """DistributedSampler-equivalent index stream
    (reference CTClipTrainer.py:88-102)."""

    def __init__(self, n: int, num_shards: int = 1, shard_index: int = 0,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.n = n
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> Sequence[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            per = self.n // self.num_shards
            idx = idx[: per * self.num_shards]
        elif self.n % self.num_shards:
            # pad by wrapping so every shard has EQUAL length (torch
            # DistributedSampler semantics): unequal shards desynchronize
            # collective eval loops across processes — one host enters a
            # collective its peers never reach
            pad = self.num_shards - self.n % self.num_shards
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_index::self.num_shards].tolist()


class DataLoader:
    """Iterable of collated batches with worker-thread prefetch.

    Collation: arrays stack on a new batch axis; strings and other objects
    become lists (torch default_collate-like for this schema)."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _collate(items):
        first = items[0]
        out = []
        for field_idx in range(len(first)):
            vals = [it[field_idx] for it in items]
            if isinstance(vals[0], np.ndarray):
                out.append(np.stack(vals))
            else:
                out.append(vals)
        return tuple(out)

    def __iter__(self) -> Iterator:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator:
        """Iterate skipping the first `start_batch` batches WITHOUT
        preprocessing them — the mid-epoch resume path (ct_clip_ut_tpu/train/trainer.py):
        the skipped samples' indices never enter the worker queue, so
        resuming at step k costs zero preprocessing for steps < k. The
        yielded batches are exactly `list(loader)[start_batch:]` for the
        sampler's current epoch."""
        order = self.sampler.indices()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = batches[start_batch:]

        sample_q: "queue.Queue" = queue.Queue()
        done_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size
                                            + self.num_workers)
        for i, b in enumerate(batches):
            for k, j in enumerate(b):
                sample_q.put((i, k, j))

        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    bi, pos, si = sample_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    done_q.put((bi, pos, self.dataset[si], None))
                except Exception as e:  # noqa: BLE001
                    done_q.put((bi, pos, None, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # items land at their SAMPLER position within the batch, not in
        # worker completion order — with num_workers > 1 completion order is
        # nondeterministic, and batch assembly must be reproducible for the
        # bit-for-bit resume contract (ct_clip_ut_tpu/train/trainer.py)
        pending: dict = {}
        next_batch = 0
        received = 0
        total = sum(len(b) for b in batches)
        try:
            while next_batch < len(batches):
                while len(pending.get(next_batch, {})) < len(batches[next_batch]):
                    if received >= total and not any(t.is_alive() for t in threads):
                        raise RuntimeError("loader workers exited early")
                    bi, pos, item, err = done_q.get()
                    if err is not None:
                        raise err
                    pending.setdefault(bi, {})[pos] = item
                    received += 1
                slots = pending.pop(next_batch)
                yield self._collate([slots[k] for k in range(len(slots))])
                next_batch += 1
        finally:
            stop.set()
