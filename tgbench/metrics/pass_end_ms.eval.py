"""The end of each evaluation pass (`tamgcn.eval.pass_end`: the losses and
scores copied to the host, which waits for the last replays, top-k and the
log lines), ms a pass."""
from tgbench.program_spans import ms_per_span


def read(ctx):
    return ms_per_span(ctx, "tamgcn.eval.pass_end")
