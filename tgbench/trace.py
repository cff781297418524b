"""The traced window of a `--trace 1` run: torch.profiler over part of the
window, reduced to what the per-layer metrics read.

`Traced` profiles the work inside its `with` block (CPU and CUDA activity;
one warm-up step first, since a fresh trace can drop its first kernels).
The block is one `record_function` range, `tgbench.window`, whose length
is `window_s`. `busy_s` is the union of the device's activity intervals
(kernels, copies, sets) inside it; the gaps between them are idle. Each
idle gap is named by what the host was doing at its middle: the innermost
traced range or op on the main thread and, after a "+", on another thread
(the loader's producer); gaps under SHORT_GAP_NS are the spacing of
launches and summed unnamed.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading

import torch

WINDOW = "tgbench.window"
SHORT_GAP_NS = 20_000  # gaps shorter than this are launch spacing, not named


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict  # device op name -> seconds inside the window
    gaps: dict  # host activity -> idle seconds
    device_events: int

    def device_time(self, prefixes) -> float | None:
        """Seconds of the device ops whose name holds any of `prefixes`;
        None where none ran."""
        hits = [s for name, s in self.kernels.items() if any(p in name for p in prefixes)]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _times(e):
    start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
    dur = e.duration_ns() if hasattr(e, "duration_ns") else 1000 * e.duration_us()
    return start, start + dur


def summarise(events, main_tid: int) -> Summary:
    window = None
    device, host = [], []
    for e in events:
        kind = str(e.device_type())
        start, end = _times(e)
        user_range = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        if kind.endswith("CUDA"):
            # a record_function range is mirrored on the device's timeline
            # as an annotation: not device work
            if not user_range and not e.name().startswith(("tgbench.", "ProfilerStep")):
                device.append((start, end, e.name()))
        elif e.name() == WINDOW:
            window = (start, end)
        elif not e.name().startswith("ProfilerStep"):
            host.append((start, end, e.name(), e.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window
    kernels = collections.Counter()
    spans = []
    for start, end, name in device:
        start, end = max(start, w0), min(end, w1)
        if end > start:
            kernels[name] += (end - start) / 1e9
            spans.append((start, end))
    spans.sort()
    busy, gaps, cursor = 0, [], w0
    for start, end in spans:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    named = collections.Counter()
    host.sort()
    active, at = [], 0  # a sweep over the host ranges by start, heap by end
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            named[f"gaps under {SHORT_GAP_NS // 1000} us, between launches"] += (g1 - g0) / 1e9
            continue
        mid = (g0 + g1) / 2
        while at < len(host) and host[at][0] <= mid:
            start, end, name, tid = host[at]
            heapq.heappush(active, (end, start, name, tid))
            at += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        inner = {}
        for end, start, name, tid in active:
            main = tid == main_tid
            best = inner.get(main)
            if best is None or end - start < best[0] - best[1]:
                inner[main] = (end, start, name)
        label = inner[True][2] if True in inner else "python, no traced op"
        if False in inner:
            label += " + " + inner[False][2]
        named[label] += (g1 - g0) / 1e9
    return Summary((w1 - w0) / 1e9, busy / 1e9, dict(kernels), dict(named), len(device))


class Traced:
    """`with Traced(device) as t:` profiles the block; `t.summary` after."""

    def __init__(self, device):
        self.device = device
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, on_trace_ready=self._ready,
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.__enter__()
        torch.ones(8, device=self.device).sum().item()  # the warm-up step
        self._prof.step()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def _ready(self, prof):
        self.summary = summarise(prof.profiler.kineto_results.events(),
                                 threading.main_thread().native_id)

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(*exc)
        self._prof.step()
        self._prof.__exit__(*exc)
        if exc[0] is None and self.summary is None:
            raise RuntimeError("the profiler returned no trace")
        return False
