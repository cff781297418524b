"""Host-side batch loader (numpy copy of tamgcn_tpu/data/loader.py).

A plain numpy pipeline with deterministic per-epoch shuffling and
fixed-shape stacked batches: a dataset's batched `get_batch` first (the
NW-UCLA feeder's native core), and thread-pool sample assembly where it has
none or it returns None; `prefetch` overlaps the next batch's assembly and
host->device copy with the current step, and a `Copier` makes that copy
(on the card from pinned memory on a copy stream of its own).

Process sharding, as the JAX loader's (:48-80): with process_count > 1
each process takes its contiguous shard of the (shuffled) indices, n //
process_count of them (the tail remainder dropped), in batches of
batch_size // process_count where that divides (the global batch being
the processes' batches in process order).
"""
from __future__ import annotations

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from ..utils.spans import span

DEPTH = 2  # the batches `prefetch` keeps in its queue
SLOTS = DEPTH + 2  # a Copier's pinned slots per (shape, dtype): deeper than the batches in flight


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


@dataclasses.dataclass
class CopyStats:
    """What the copiers did since the last `reset_stats`."""

    pinned: int = 0  # batches copied from pinned slots on a copy stream
    plain: int = 0  # batches copied by `.to(device)` (a CPU device)
    slot_waits: int = 0  # the producer's waits for a slot whose copy was in flight


stats = CopyStats()


def reset_stats() -> None:
    for field in dataclasses.fields(CopyStats):
        setattr(stats, field.name, 0)


class _Card:
    """The CUDA calls of the pinned path on one device (a test hands the
    copier a stand-in with the same methods)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)

    def host(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def event(self):
        return torch.cuda.Event()

    def copying(self):
        return torch.cuda.stream(self.stream)

    def copy(self, out: torch.Tensor, host: torch.Tensor) -> None:
        out.copy_(host, non_blocking=True)

    def hand_over(self, event, tensors: Sequence[torch.Tensor]) -> None:
        stream = torch.cuda.current_stream(tensors[0].device)
        stream.wait_event(event)
        for t in tensors:  # their blocks are not reused before `stream` is past here
            t.record_stream(stream)


class _Slot:
    __slots__ = ("host", "view", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host, self.view, self.event = host, host.numpy(), event


@dataclasses.dataclass(slots=True)
class Ready:
    """A batch whose device tensors a copy stream may still be writing:
    `prefetch` hands it to its consumer with `hand_over`, which orders the
    consumer's current stream after `event` and returns `item`."""

    item: object
    event: object
    tensors: tuple
    card: _Card

    def hand_over(self):
        self.card.hand_over(self.event, self.tensors)
        return self.item


class Copier:
    """A batch's arrays to `device`, kept for a trainer's lifetime.

    On a CPU device each array is `torch.from_numpy(...).to(device)`, the
    item built from those tensors. On the card each array goes through a
    ring of SLOTS pinned host buffers per (shape, dtype), each with its
    event: the producer waits for the slot's previous copy (`stats.slot_waits`,
    span `tamgcn.loader.slot_wait`; the ring is deeper than the batches in
    flight, so it should not engage), writes the array into it, enqueues the
    copy into a tensor allocated on the copier's own stream and records the
    slot's event. The copy then runs beside the steps queued on the
    consumer's stream instead of behind them, and the item comes back as a
    `Ready` that the batch's last event makes ready."""

    def __init__(self, device, card=None):
        self.device = torch.device(device)
        if card is None and self.device.type == "cuda":
            card = _Card(self.device)
        self.card = card
        self.rings: dict[tuple, Iterator[_Slot]] = {}  # (shape, dtype) -> its slots in turn

    def __call__(self, arrays: Sequence[np.ndarray], build: Callable):
        """`build(*tensors)` of `arrays` on the device; on the card a
        `Ready` of it."""
        if self.card is None:
            stats.plain += 1
            return build(*(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                           for a in arrays))
        with self.card.copying():
            copies = [self._copy(a) for a in arrays]
        stats.pinned += 1
        tensors = tuple(t for t, _ in copies)
        # one stream: the last copy's event follows every copy before it
        return Ready(build(*tensors), copies[-1][1], tensors, self.card)

    def _copy(self, a: np.ndarray):
        key = (a.shape, a.dtype)
        ring = self.rings.get(key)
        if ring is None:
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            ring = self.rings[key] = itertools.cycle(
                [_Slot(self.card.host(a.shape, dtype), self.card.event())
                 for _ in range(SLOTS)])
        slot = next(ring)
        if not slot.event.query():
            stats.slot_waits += 1
            with span("tamgcn.loader.slot_wait"):
                slot.event.synchronize()
        np.copyto(slot.view, a)
        out = torch.empty(a.shape, dtype=slot.host.dtype, device=self.device)
        self.card.copy(out, slot.host)
        slot.event.record(self.card.stream)
        return out, slot.event


def prefetch(iterator, put=None, size: int = DEPTH):
    """Pipeline an iterator through a background thread, keeping up to `size`
    items in flight.

    `put` runs in the producer thread — pass the host->device transfer (a
    `Copier`) so the next batch's assembly and copy overlap the current
    step instead of serialising with it (reference processor/processor.py:
    57-70 uses DataLoader workers for the same). An item that `put` returns
    as a `Ready` is handed over before it is yielded: the consumer's current
    stream waits for its copy, so whatever the consumer runs on that stream
    sees the whole batch.

    Spans (utils/spans.py), keyed by the item's index: the producer's `put`
    (`tamgcn.loader.h2d`: on the card the copy's enqueue) and its wait for
    room in the queue (`tamgcn.loader.put_wait`); the consumer's wait for the
    item and its hand-over (`tamgcn.loader.wait`; the first takes in the
    thread's start, and one more waits for the end of the iterator).
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
            if isinstance(item, Ready):
                item = item.hand_over()
        if item is done:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
