"""The unit op's least time in the traced train steps (forward, x3
gradient, parameter gradients of every block) over the device time of the
kernels named in roofline.unit_op.train.json (%)."""
from tgbench.readers import unit_op_roofline


def read(ctx):
    return unit_op_roofline(ctx, __file__, train=True)
