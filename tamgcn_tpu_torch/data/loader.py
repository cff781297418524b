"""Host-side batch loader (numpy copy of tamgcn_tpu/data/loader.py).

A plain numpy pipeline with deterministic per-epoch shuffling and
fixed-shape stacked batches: a dataset's batched `get_batch` first (the
NW-UCLA feeder's native core), and thread-pool sample assembly where it has
none or it returns None; `prefetch` overlaps the next batch's assembly and
host->device copy with the current step.

Process sharding, as the JAX loader's (:48-80): with process_count > 1
each process takes its contiguous shard of the (shuffled) indices, n //
process_count of them (the tail remainder dropped), in batches of
batch_size // process_count where that divides (the global batch being
the processes' batches in process order).
"""
from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from ..utils.spans import span


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
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1 and batch_size % process_count == 0:
            # per-process share of the global batch
            self.local_batch = batch_size // process_count
        else:
            self.local_batch = batch_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
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
        if self.process_count > 1:
            # equalise shard sizes by dropping the tail remainder
            per = n // self.process_count
            start = self.process_index * per
            idx = idx[start:start + per]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.local_batch
        return -(-n // self.local_batch)

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        nb = len(self)
        get_batch = getattr(self.dataset, "get_batch", None)
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            for b in range(nb):
                chunk = idx[b * self.local_batch:(b + 1) * self.local_batch]
                with span("tamgcn.loader.assemble", b):
                    batch = get_batch(chunk) if get_batch is not None else None
                    if batch is None:  # no native fast path
                        batch = _collate(list(pool.map(self.dataset.__getitem__, chunk)))
                yield batch


def prefetch(iterator, put=None, size: int = 2):
    """Pipeline an iterator through a background thread, keeping up to `size`
    items in flight.

    `put` runs in the producer thread — pass the host->device transfer so
    the next batch's copy and the feeder's CPU work overlap the current step
    instead of serialising with it (reference processor/processor.py:57-70
    uses DataLoader workers for the same).

    Spans (utils/spans.py), keyed by the item's index: the producer's `put`
    (`tamgcn.loader.h2d`) and its wait for room in the queue
    (`tamgcn.loader.put_wait`); the consumer's wait for the item
    (`tamgcn.loader.wait`; the first takes in the thread's start, and one
    more waits for the end of the iterator).
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    done = object()

    def producer():
        try:
            for k, item in enumerate(iterator):
                if put is not None:
                    with span("tamgcn.loader.h2d", k):
                        item = put(item)
                with span("tamgcn.loader.put_wait", k):
                    q.put(item)
            q.put(done)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    for k in itertools.count():
        with span("tamgcn.loader.wait", k):
            if k == 0:
                t.start()
            item = q.get()
        if item is done:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
