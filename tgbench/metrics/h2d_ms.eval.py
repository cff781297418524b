"""The producer thread's host-to-device copy of each batch (`tamgcn.loader.h2d`,
the trainer's `_put`; pageable, on the default stream, so it waits for the
replays queued ahead of it) over the traced batches (ms a batch)."""
from tgbench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tamgcn.loader.h2d")
