"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

A cell of BENCHMARK.json names a configuration (`configs/<config>.json`)
and a traffic mix (`traffic/<traffic>.json`); the mix names its driver
(`drivers/<driver>.py`), each per-layer metric has its reader
(`metrics/<metric>.py`) and each cell its limits (`limits/<cell>.json`).
Everything is found by name, so a later cell or metric is a new file.

A driver is a class `Driver(run, fault=None)` whose constructor is the
set-up, with `window(seconds, traced)` -> Window, `release()` (frees the
program's state) and `check()` -> [Check] (the comparison with the plain
reference, after the window).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tamgcn_tpu")


@dataclasses.dataclass
class Check:
    """A number compared with the reference and its limit; a number
    without a limit is a reading only (printed, not compared)."""
    name: str
    value: float
    limit: float | None

    @property
    def compared(self) -> bool:
        return self.limit is not None

    @property
    def passed(self) -> bool:
        return not self.compared or (math.isfinite(self.value) and self.value <= self.limit)


@dataclasses.dataclass
class Window:
    seconds: float
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    facts: dict  # what the per-layer readers read


class Phases:
    """Host seconds of each named phase of set-up, printed to standard
    error (where set-up goes is what PERF.md lists for later PRs)."""

    def __init__(self):
        self.at, self.done = time.perf_counter(), []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.done.append((name, now - self.at))
        self.at = now


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object
    tmp: str
    overrides: dict  # model_args overrides (the lower-precision control)
    phases: Phases | None = None


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: end-to-end with trace 0,
    per-layer with trace 1; those with a `workloads` key only in the cells
    it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def driver_class(name: str):
    return importlib.import_module(f"tgbench.drivers.{name}").Driver


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"tgbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """The top-level names of loaded modules that the benchmark's process
    must not hold, compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def device_record(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def make_run(bench: dict, cell: str, seed: int, device, tmp: str,
             overrides: dict | None = None) -> Run:
    w = workload(bench, cell)
    return Run(cell, load_json(HERE, "configs", f"{w['config']}.json"),
               load_json(HERE, "traffic", f"{w['traffic']}.json"),
               load_json(HERE, "limits", f"{cell}.json"), seed, device, tmp,
               dict(overrides or {}))


def execute(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
            t0: float, chips: int = 1, fault: str | None = None,
            overrides: dict | None = None, adjust=None) -> tuple[dict, list[Check]]:
    """Set-up, window and check of one run; returns (result, checks).
    `fault` plants a fault (faults.py), `overrides` sets model arguments
    (the lower-precision control), `adjust(run)` edits the run before
    set-up (the tests' small sizes); a benchmark run uses none of them."""
    import torch

    from .trace import Traced

    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = tempfile.mkdtemp(prefix="tgbench-", dir=base)
    try:
        run = make_run(bench, cell, seed, device, tmp, overrides)
        if adjust is not None:
            adjust(run)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        run.phases = Phases()
        run.phases.done.append(("start and imports", run.phases.at - t0))
        drv = driver_class(run.traffic["driver"])(run, fault=fault)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        print("set-up phases (s): " + ", ".join(f"{name} {sec:.3f}"
                                                for name, sec in run.phases.done),
              file=sys.stderr, flush=True)
        tracer = Traced(device) if trace else None
        win = drv.window(seconds, tracer)
        record = device_record(device, chips)
        metrics = {}
        for m in metrics_for(bench, cell, trace):
            if not trace and m["name"] == "setup_s":
                value = setup_s
            elif not trace:
                value = win.end_to_end[m["name"]]
            else:
                value = reader(m["name"])(Context(run, win, tracer.summary))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace:
            s = tracer.summary
            record.update(busy_s=s.busy_s, window_s=s.window_s)
        drv.release()
        checks = drv.check()
        for key, value in getattr(drv, "notes", {}).items():
            print(f"note {key}: {value}", file=sys.stderr, flush=True)
        result = {"correct": all(c.passed for c in checks) and any(c.compared for c in checks),
                  "attempted": win.attempted,
                  "failed": win.failed, "metrics": metrics, "device": record}
        if trace:
            result["breakdown"] = tracer.summary.breakdown()
        result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                            for c in checks if c.compared}
        return result, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the run, its window's facts and the
    trace summary."""
    run: Run
    window: Window
    trace: object
