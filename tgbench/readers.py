"""The arithmetic the per-layer readers share. Each takes the reader's
context (harness.Context) and returns a number, or None where the run has
nothing to read (no card, nothing traced, no such kernel)."""
from __future__ import annotations

import json
import os

from .work import bounds


def _device(ctx) -> bool:
    return ctx.run.device.type == "cuda" and ctx.trace.busy_s > 0


def per_step_ms(ctx, seconds: float):
    steps = ctx.window.facts["traced_steps"]
    return 1e3 * seconds / steps if steps else None


def step_device_ms(ctx):
    return per_step_ms(ctx, ctx.trace.busy_s) if _device(ctx) else None


def idle_share(ctx):
    if not _device(ctx):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    """The model's FLOPs of the traced samples over the traced window and
    the data-sheet dense peak of the configuration's precision."""
    if not _device(ctx):
        return None
    facts = ctx.window.facts
    peak = bounds.PEAK_FLOPS[ctx.run.config["precision"]]
    return 100.0 * facts["traced_samples"] * facts["flops_per_sample"] / (
        ctx.trace.window_s * peak)


def unit_op_roofline(ctx, metric_file: str, train: bool):
    """The least time of the unit op's calls in the traced window over the
    device time of the kernels named by the prefixes in the metric's data
    file (`<metric>.json` beside its reader)."""
    if not _device(ctx):
        return None
    with open(os.path.splitext(metric_file)[0] + ".json") as f:
        prefixes = json.load(f)["kernel_prefixes"]
    seconds = ctx.trace.device_time(prefixes)
    if not seconds:
        return None
    cfg = ctx.run.config
    facts = ctx.window.facts
    batches = facts.get("traced_batches") or {facts["batch"]: facts["traced_steps"]}
    least = sum(count * bounds.unit_op_s(cfg["model"], cfg["time_steps"], int(batch), train,
                                         cfg["precision"])
                for batch, count in batches.items())
    return 100.0 * least / seconds
