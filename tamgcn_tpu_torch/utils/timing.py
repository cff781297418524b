"""Device timing of chained applications.

Counterpart of tamgcn_tpu/utils/timing.py. `time_chained` runs `chain`
applications of a function in a row, each fed the previous one's output
through `feedback` (a true data dependency, so no application can be
skipped or overlapped with the next), `iters` times, and synchronises once
at the end. There is no `lax.scan`: the chain is a Python loop of launches.

On CUDA tensors the time comes from CUDA events recorded around the timed
loop and one `torch.cuda.synchronize()`; on CPU tensors from
`time.perf_counter`, after `hard_sync` has fetched a scalar.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def hard_sync(x) -> float:
    """Fetch a scalar derived from every tensor in `x` (a tensor or nested
    tuples, lists and dicts of them): the value cannot exist before the work
    that made them has finished."""
    return float(sum(t.detach().float().abs().sum().item() for t in _tensors(x)))


def _on_cuda(args) -> bool:
    return any(t.is_cuda for t in _tensors(args))


def time_chained(fn: Callable, feedback: Callable, args: tuple, *,
                 chain: int = 20, iters: int = 5, warmup: int = 2) -> float:
    """Seconds per application of `fn(*args)` with serial chaining.

    `feedback(out, args) -> args` threads each output into the next
    application's inputs. Each of the `warmup + iters` runs starts from
    `args` and applies `fn` `chain` times; the `iters` runs are timed
    together."""

    def run():
        a, out = args, None
        for _ in range(chain):
            out = fn(*a)
            a = feedback(out, a)
        return out

    out = None
    for _ in range(warmup):
        out = run()
    if _on_cuda(args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / (iters * chain)
    if out is not None:
        hard_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    hard_sync(out)
    return (time.perf_counter() - t0) / (iters * chain)
