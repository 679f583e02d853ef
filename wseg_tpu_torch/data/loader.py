"""Host input pipeline: shuffling, batching, thread-pool prefetch
(counterpart of wseg_tpu/data/loader.py; replaces the reference's torch
DataLoader(num_workers=8), contrast_train.py:80-86).

Image decode and PIL augmentation release the GIL, so a pool of threads
keeps the card fed without worker processes. With `pin_memory=True` each
batch's arrays become pinned torch tensors in the worker thread, ready for
`.to(device, non_blocking=True)`.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wseg_tpu_torch.parallel.mesh import rows_of


PREFETCH = 4  # batches in flight


def collate(samples):
    """Stack tuple elements: numpy arrays with np.stack, the rest as lists."""
    return tuple(np.stack(col) if isinstance(col[0], np.ndarray) else list(col)
                 for col in zip(*samples))


class DataLoader:
    """Batches of `batch_size` (the last partial batch is dropped), in a
    shuffled order or, with `shuffle=False`, in the dataset's, each the
    dataset's items combined by `collate`, fetched `num_workers` at a time.

    shard=(rank, world): every rank walks the same order of global batches
    of `batch_size` (the same seed and epoch) and yields only its
    contiguous rows of each (parallel/mesh.py:rows_of), so the ranks' rows
    together are the one-process epoch, batch for batch."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, seed: int = 1,
                 pin_memory: bool = False, collate=collate, shuffle: bool = True,
                 shard: tuple[int, int] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = slice(None) if shard is None else rows_of(batch_size, *shard)
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.pin_memory = pin_memory
        self.collate = collate
        self._rng = random.Random(seed)
        self._epoch = None

    def set_epoch(self, epoch: int):
        """Epoch-indexed determinism: epoch e's order is a function of (seed,
        e), so a restarted process that calls set_epoch(e) sees the order the
        original run saw. Forwarded to the dataset's augmentation seeding
        when it has one. Never calling it keeps one stateful stream."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _fetch(self, idxs):
        batch = self.collate([self.dataset[i] for i in idxs])
        if self.pin_memory:
            batch = tuple(torch.from_numpy(c).pin_memory() if isinstance(c, np.ndarray) else c
                          for c in batch)
        return batch

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng = (random.Random(f"{self.seed}:{self._epoch}") if self._epoch is not None
                   else self._rng)
            rng.shuffle(order)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size][self.rows]
                   for i in range(len(self))]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            it = iter(batches)
            pending = [pool.submit(self._fetch, b) for b in
                       (next(it, None) for _ in range(PREFETCH)) if b is not None]
            while pending:
                fut = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(self._fetch, b))
                yield fut.result()
