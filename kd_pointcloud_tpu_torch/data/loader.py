"""Batched data loading with multiprocess workers.

The port's copy of kd_pointcloud_tpu/data/loader.py, which replaces the
reference's torch.utils.data.DataLoader (train_bid_pointconv.py:70-95).
`num_workers >= 2` forks a persistent process pool at the first iteration
(the 8192-point numpy augmentation is GIL-bound, so threads cannot keep a
step fed). Each worker loads + transforms + collates whole batches; the
parent keeps `prefetch` batches in flight so host IO overlaps device
compute.

The pool forks after the model is already on the card. That is safe because
nothing a worker runs touches CUDA: data/ imports no torch, batches come
back as numpy, and batch_to_device runs in the parent. close() cancels the
pending batches and shuts the pool down without waiting.

`pad_last=True` pads a short final batch by repeating its last sample so
every step sees one shape; padded rows carry the sentinel path `PAD_PATH`
and `valid_count()` reports the real sample count; eval loops weight their
metric averages by it instead of silently truncating.

Each worker of the pool reseeds its dataset to seed + 1000 * (wid + 1) by
arrival order, and the pool hands out batches as workers come free: with 2
or more workers the batches hold the same scenes in the same order, but
which worker, and so which random stream, transforms a batch is not
reproducible. With 0 or 1 workers the batches are, bit for bit.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
              List[str]]

PAD_PATH = "<pad>"

# ---------------------------------------------------------------- workers

_WORKER_DATASET = None


def _init_worker(dataset, base_seed: int, counter):
    """Pool initializer: install the dataset and give this worker its own RNG
    stream (fork duplicates the parent's generator state — without reseeding
    every worker would produce identical augmentations)."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    if hasattr(dataset, "reseed"):
        dataset.reseed(base_seed + 1000 * (wid + 1))


def _load_batch(idxs) -> Batch:
    ds = _WORKER_DATASET
    return collate([ds[int(i)] for i in idxs])


def collate(samples: Sequence) -> Batch:
    pc1 = np.stack([s[0] for s in samples]).astype(np.float32)
    pc2 = np.stack([s[1] for s in samples]).astype(np.float32)
    norm1 = np.stack([s[2] for s in samples]).astype(np.float32)
    norm2 = np.stack([s[3] for s in samples]).astype(np.float32)
    sf = np.stack([s[4] for s in samples]).astype(np.float32)
    paths = [s[5] for s in samples]
    return pc1, pc2, norm1, norm2, sf, paths


def pad_batch(batch: Batch, batch_size: int) -> Batch:
    """Repeat the last row until the batch is full; padded paths = PAD_PATH."""
    n = batch[0].shape[0]
    if n == batch_size:
        return batch
    reps = batch_size - n
    arrs = tuple(np.concatenate([a, np.repeat(a[-1:], reps, axis=0)])
                 for a in batch[:5])
    return arrs + (list(batch[5]) + [PAD_PATH] * reps,)


def valid_count(batch: Batch) -> int:
    """Number of non-padded samples in a batch."""
    return sum(1 for p in batch[5] if p != PAD_PATH)


class DataLoader:
    """Iterate fixed-size batches with optional shuffling and background
    prefetch.

    num_workers <= 0: synchronous in-process loading.
    num_workers == 1: one background thread (cheap; enough for eval bs=1).
    num_workers >= 2: persistent fork pool, one task per batch.

    drop_last=True keeps the jitted step shape static by discarding the
    remainder; pad_last=True keeps it static by padding instead (see
    module docstring)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 2, prefetch: int = 4,
                 pad_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._pool: Optional[ProcessPoolExecutor] = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _maybe_pad(self, batch: Batch) -> Batch:
        if self.pad_last:
            return pad_batch(batch, self.batch_size)
        return batch

    # ------------------------------------------------------------- pool
    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            ctx = mp.get_context("fork")
            counter = ctx.Value("i", 0)
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_init_worker,
                initargs=(self.dataset, self.seed, counter))
        return self._pool

    def close(self):
        """Shut down worker processes (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # --------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        if self.num_workers <= 0:
            for idxs in batches:
                yield self._maybe_pad(
                    collate([self.dataset[int(i)] for i in idxs]))
            return
        if self.num_workers == 1:
            yield from self._iter_threaded(batches)
            return
        yield from self._iter_pool(batches)

    def _iter_pool(self, batches) -> Iterator[Batch]:
        pool = self._ensure_pool()
        pending: deque = deque()
        it = iter(batches)
        try:
            for idxs in it:
                pending.append(pool.submit(_load_batch, idxs))
                if len(pending) >= self.prefetch + self.num_workers:
                    yield self._maybe_pad(pending.popleft().result())
            while pending:
                yield self._maybe_pad(pending.popleft().result())
        finally:
            for f in pending:
                f.cancel()

    def _iter_threaded(self, batches) -> Iterator[Batch]:
        q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for idxs in batches:
                    item = collate([self.dataset[int(i)] for i in idxs])
                    # bounded put that honors shutdown — a plain blocking
                    # q.put would leak this thread forever if the consumer
                    # abandons the iterator while the queue is full
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            finally:
                while not stop.is_set():
                    try:
                        q.put(None, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield self._maybe_pad(item)
        finally:
            stop.set()
