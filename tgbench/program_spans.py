"""What the readers of the program's spans share. The span table
(tamgcn_tpu_torch/utils/spans.py) collects while a torch profiler is
active, which in a `--trace 1` run is the traced part of the window, and is
read after it. A reader returns None for a program without the table (a
checkout older than it), where the span is absent, and off the card: on
the CPU the step runs eagerly and no copy crosses to a device, so the
spans time other work than the metrics name."""
from __future__ import annotations

from .readers import per_step_ms


def total(ctx, name: str):
    """The span's totals (count, seconds, self_seconds), or None."""
    if ctx.run.device.type != "cuda":
        return None
    try:
        from tamgcn_tpu_torch.utils import spans
    except ImportError:
        return None
    t = spans.totals().get(name)
    return t if t is not None and t.count else None


def ms_per_step(ctx, name: str, self_time: bool = False):
    """The span's seconds (or self seconds) over the traced steps, in ms."""
    t = total(ctx, name)
    if t is None:
        return None
    return per_step_ms(ctx, t.self_seconds if self_time else t.seconds)


def ms_per_span(ctx, name: str):
    """The span's mean length, in ms."""
    t = total(ctx, name)
    return None if t is None else 1e3 * t.seconds / t.count
