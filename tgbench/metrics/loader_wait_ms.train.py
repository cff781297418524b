"""The trainer's "dataloader" timer over the traced epochs: the host clock
around the loop's wait for its next batch, per step (ms)."""


def read(ctx):
    facts = ctx.window.facts
    steps = facts["traced_steps"]
    return 1e3 * facts["loader_wait_s"] / steps if steps else None
