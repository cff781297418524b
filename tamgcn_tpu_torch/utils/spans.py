"""Spans of the port's host loop and loader, kept only while a profiler collects.

`with span(name, ident):` marks one stretch of host work at a layer
boundary (the names and where they sit: README.md, at `--profile_dir`). While no
torch profiler collects it costs one read of torch's global flag
(`torch.autograd.profiler._is_profiler_enabled`, read from the module at
each call) and nothing else. While one collects (the flag is global, so
every thread sees it, and a scheduled profile sets it only in its active
phase), a span

  * on the main thread, enters a profiler range of its name
    (`torch._C._profiler._RecordFunctionFast`, the C++ scope that
    `record_function` reaches through two dispatched ops, at a fraction of
    its cost), so that it lies on the trace's own timeline beside the
    ops and kernels; kineto keeps no range of a thread started inside the
    profile (the loader's producer), so those are kept here alone;
  * appends a `Record` to a bounded list: its name, the OS thread id, start
    and end in Unix nanoseconds (the clock of kineto's events), `ident`
    (the batch index for the loader's and the loop's spans) and the index
    of the enclosing span's record on the same thread (-1 for none);
  * adds to its name's `Total`: count, seconds, and self seconds (its
    duration less that of its children on the same thread), which go on
    counting once the list is full.

The span's own cost lies inside it, so a parent's self time holds none of
its children's. `totals()`, `records()` and `reset()` (with no span open)
read and clear the table; `add_to_chrome_trace` puts the spans kineto does
not see into a trace that `export_chrome_trace` wrote.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 20  # records kept; totals count every span


class Record(NamedTuple):
    name: str
    tid: int  # OS thread id
    start_ns: int  # Unix nanoseconds
    end_ns: int  # 0 while the span is open
    ident: object
    parent: int  # index in records() of the enclosing span on this thread, or -1


@dataclasses.dataclass
class Total:
    count: int = 0
    seconds: float = 0.0
    self_seconds: float = 0.0


_lock = threading.Lock()
_records: list = []  # [name, tid, start_ns, end_ns, ident, parent] each
_totals: dict[str, list] = {}  # name -> [count, ns, self ns]
_local = threading.local()  # .stack, the open spans; .tid, the OS thread id
_MAIN = threading.main_thread().ident
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "ident", "start", "child_ns", "index", "rec", "range")

    def __init__(self, name: str, ident):
        self.name, self.ident = name, ident

    def __enter__(self):
        self.start = time.time_ns()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        self.range = None
        if threading.get_ident() == _MAIN:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.child_ns, self.index, self.rec = 0, -1, None
        rec = [self.name, _local.tid, self.start, 0, self.ident,
               stack[-1].index if stack else -1]
        with _lock:
            if len(_records) < CAP:  # the slot now, so that children can name it
                self.index, self.rec = len(_records), rec
                _records.append(rec)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = _local.stack
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        duration = end - self.start
        if stack:
            stack[-1].child_ns += duration
        if self.rec is not None:
            self.rec[3] = end
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                total = _totals[self.name] = [0, 0, 0]
            total[0] += 1
            total[1] += duration
            total[2] += duration - self.child_ns
        return False


def span(name: str, ident=None):
    """A context manager that marks `name` (for the batch, step or epoch
    `ident`) while a profiler collects, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, ident)


def totals() -> dict[str, Total]:
    with _lock:
        return {name: Total(n, ns / 1e9, self_ns / 1e9)
                for name, (n, ns, self_ns) in _totals.items()}


def records() -> list[Record]:
    with _lock:
        return [Record(*r) for r in _records]


def reset() -> None:
    with _lock:
        _records.clear()
        _totals.clear()


def add_to_chrome_trace(path: str) -> int:
    """Add the closed spans of every thread but the main one (kineto keeps
    the main thread's as its own ranges) to the Chrome trace at `path`, as
    complete events on the trace's time base, under their threads' ids;
    returns how many."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)  # ts = (Unix ns - base) / 1e3
    main, pid = threading.main_thread().native_id, os.getpid()
    events = [{"ph": "X", "cat": "tamgcn_span", "name": r.name, "pid": pid, "tid": r.tid,
               "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
               "args": {"ident": str(r.ident)}}
              for r in records() if r.tid != main and r.end_ns]
    names = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": f"thread {tid} (spans)"}} for tid in {e["tid"] for e in events}]
    trace["traceEvents"].extend(events + names)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(events)
