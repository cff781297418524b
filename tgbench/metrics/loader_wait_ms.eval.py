"""The evaluation loop's wait for its next batch (`tamgcn.loader.wait`; the
first of a pass takes in the producer thread's start, and one more a pass
waits for the loader's end) over the traced batches (ms a batch)."""
from tgbench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tamgcn.loader.wait")
