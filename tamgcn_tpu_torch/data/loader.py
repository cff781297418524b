"""Host-side batch loader (numpy copy of tamgcn_tpu/data/loader.py).

A plain numpy pipeline with deterministic per-epoch shuffling and
fixed-shape stacked batches: a dataset's batched `get_batch` first (the
NW-UCLA feeder's native core), and thread-pool sample assembly where it has
none or it returns None; `prefetch` overlaps the next batch's assembly and
host->device copy with the current step.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


def _collate(samples: Sequence[tuple]) -> tuple:
    cols = list(zip(*samples))
    out = []
    for col in cols:
        first = col[0]
        if isinstance(first, np.ndarray):
            out.append(np.stack(col))
        else:
            out.append(np.asarray(col))
    return tuple(out)


class Loader:
    """Deterministic shuffling batch loader over a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.Generator(
                np.random.Philox(key=self.seed, counter=[0, 0, self.epoch, 1])
            )
            rng.shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        nb = len(self)
        get_batch = getattr(self.dataset, "get_batch", None)
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            for b in range(nb):
                chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                if get_batch is not None:
                    batch = get_batch(chunk)
                    if batch is not None:  # the native fast path
                        yield batch
                        continue
                samples = list(pool.map(self.dataset.__getitem__, chunk))
                yield _collate(samples)


def prefetch(iterator, put=None, size: int = 2):
    """Pipeline an iterator through a background thread, keeping up to `size`
    items in flight.

    `put` runs in the producer thread — pass the host->device transfer so
    the next batch's copy and the feeder's CPU work overlap the current step
    instead of serialising with it (reference processor/processor.py:57-70
    uses DataLoader workers for the same).
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    done = object()

    def producer():
        try:
            for item in iterator:
                q.put(put(item) if put is not None else item)
            q.put(done)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
