"""The trainer's steps as CUDA graphs: the port's counterpart of `jax.jit`.

The JAX trainer jits its train, eval and fast-eval steps
(tamgcn_tpu/train/trainer.py:319-366): one compiled executable per input
shape, no per-op dispatch. `GraphedStep` does the same on the card for a
step ``fn(*tensors) -> tuple of tensors``:

  * one `torch.cuda.CUDAGraph` per (shape, dtype) of the inputs, captured
    at the first call with those shapes, like a jit cache (the NW-UCLA val
    split, 7 batches of 64 and one of 16, takes two eval graphs);
  * before a capture the step runs WARMUP times on a side stream, as
    utils/timing.py:_graph does, so that library plans, handles and
    workspaces exist; the tensors of `preserve` (a train step's flat state,
    train/packing.py) are copied aside first and written back after, so the
    warm-up leaves no trace in the training state;
  * each call copies its inputs into the graph's static buffers, replays
    the graph and returns clones of its outputs, so a result outlives the
    next replay (the span `tamgcn.graph.replay`; a capture with its warm-up
    is `tamgcn.graph.capture`, utils/spans.py);
  * the graph reads the parameters and statistics at the addresses it was
    captured on. The packed state is updated in place, and `load_state_dict`
    copies in place, so a graph captured in epoch 1 computes with the
    weights of epoch 5.

There is no eager fallback: a capture that fails, or a host read inside the
step (`.item()`, a Python branch on a tensor's value), raises. The capture
runs in "thread_local" mode, so the loader's producer thread may meanwhile
copy the next batch to the card on its copier's own stream, wait for a
slot's event and allocate (data/loader.py:Copier): that mode forbids such
calls to the capturing thread alone.

The kernel wrappers count their launches where they launch
(ops/cuda.launch_counts), which inside a capture records a launch that
runs at every replay. `stats[name]` keeps, per step name, the captures, the
warm-up calls, the replays, the counts each graph's capture moved
(`captured`) and those counts times its replays (`replayed`); the launches
that ran on the card are the counters less `captured` plus `replayed`
(`launches_run`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import torch

from ..ops.cuda import launch_counts
from ..utils.spans import span

WARMUP = 3


@dataclasses.dataclass
class GraphStats:
    captures: int = 0
    warmups: int = 0
    replays: int = 0
    captured: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    replayed: collections.Counter = dataclasses.field(default_factory=collections.Counter)


stats: dict[str, GraphStats] = collections.defaultdict(GraphStats)


def reset_stats() -> None:
    stats.clear()


def launches_run() -> dict[str, int]:
    """The kernel launches that ran on the card, by counter: the wrappers'
    counts (ops/cuda.launch_counts) less what captures counted plus what
    replays ran, over `stats`. Taken when the counters and the stats were
    last set to 0, it counts since then."""
    out = dict(launch_counts())
    for s in stats.values():
        for k, n in s.captured.items():
            out[k] -= n
        for k, n in s.replayed.items():
            out[k] += n
    return out


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: tuple
    launches: dict


class GraphedStep:
    """`fn` (``fn(*tensors) -> tuple of tensors``, no host read inside) run
    as CUDA graphs, one per input shape and dtype; `name` keys `stats`;
    `preserve`, the tensors `fn` writes in place, are restored after the
    warm-up. Call it as `fn`, with tensors on the card."""

    def __init__(self, fn: Callable, name: str, preserve: Sequence[torch.Tensor] = ()):
        self.fn = fn
        self.name = name
        self.preserve = list(preserve)
        self.graphs: dict[tuple, _Graph] = {}

    def __call__(self, *args: torch.Tensor) -> tuple:
        key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(args)
        with span("tamgcn.graph.replay", self.name):
            for static, a in zip(entry.inputs, args):
                static.copy_(a)
            entry.graph.replay()
            s = stats[self.name]
            s.replays += 1
            s.replayed.update(entry.launches)
            return tuple(o.clone() for o in entry.outputs)

    def _capture(self, args) -> _Graph:
        if not all(a.is_cuda for a in args):
            raise ValueError(f"{self.name}: a CUDA graph takes tensors on the card")
        with span("tamgcn.graph.capture", self.name):
            inputs = [a.clone() for a in args]
            saved = [t.clone() for t in self.preserve]
            with torch.cuda.device(args[0].device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(WARMUP):
                        self.fn(*inputs)
                    for t, s in zip(self.preserve, saved):
                        t.copy_(s)
                torch.cuda.current_stream().wait_stream(side)
                del saved
                graph = torch.cuda.CUDAGraph()
                before = launch_counts()
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    outputs = tuple(self.fn(*inputs))
                after = launch_counts()
            launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
            s = stats[self.name]
            s.captures += 1
            s.warmups += WARMUP
            s.captured.update(launches)
            return _Graph(graph, inputs, outputs, launches)
