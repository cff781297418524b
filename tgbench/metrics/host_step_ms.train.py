"""The host's part of each train step (`tamgcn.train.step`: the learning
rate set, the inputs copied into the graph's buffers, the replay enqueued,
the outputs cloned) over the traced steps (ms a step)."""
from tgbench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tamgcn.train.step")
