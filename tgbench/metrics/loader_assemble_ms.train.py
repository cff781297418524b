"""Self time of the producer thread's batch assembly (`tamgcn.loader.assemble`:
the native core's `get_batch`, or the thread pool and collate) over the
traced steps (ms a step)."""
from tgbench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tamgcn.loader.assemble", self_time=True)
