"""The CTR-GCN's FLOPs per sample from a configuration's shapes, two per
multiply-add, counting what torch.utils.flop_counter counts: every
convolution and 1x1 product, the unit op's refinement product (tanh(x1 -
x2) @ w4) and aggregation, and the classifier. Normalisation, pooling and
elementwise work are not counted. Training counts each product three
times: the forward, the gradient of its input and that of its weight."""
from __future__ import annotations

import math

from ..reference.model import DILATIONS, KERNEL, SUBSETS, plan, rel_channels


def blocks(cfg: dict, time_steps: int):
    """[(n_rows_per_sample, t_in, t_out, v, cin, c, r, stride, residual)]:
    the shapes each block sees, per sample (n_rows = persons)."""
    out, t = [], time_steps
    for cin, c, stride, residual in plan(cfg["base_channel"], cfg.get("in_channels", 3)):
        t_out = math.ceil(t / stride)
        out.append((cfg["num_person"], t, t_out, cfg["num_point"], cin, c,
                    rel_channels(cin), stride, residual))
        t = t_out
    return out


def forward_per_sample(cfg: dict, time_steps: int) -> int:
    total = 0
    for m, t, t_out, v, cin, c, r, stride, residual in blocks(cfg, time_steps):
        bc = c // 4
        g = (2 * v * cin * 2 * SUBSETS * r          # conv12 on the time mean
             + 2 * t * v * cin * SUBSETS * c        # conv3
             + SUBSETS * 2 * v * v * r * c          # tanh(x1 - x2) @ w4
             + SUBSETS * 2 * t * v * v * c          # the aggregation
             + 2 * t * v * c * c)                   # the offset conv
        if cin != c:
            g += 2 * t * v * cin * c                # the down conv
        tc = (2 * t * v * c * 3 * bc                # the branches' entry 1x1
              + len(DILATIONS) * 2 * t_out * v * bc * bc * KERNEL
              + 2 * t_out * v * c * bc)             # the strided 1x1 branch
        if residual and (cin != c or stride != 1):
            tc += 2 * t_out * v * cin * c           # the residual 1x1
        total += m * (g + tc)
    return total + 2 * 4 * cfg["base_channel"] * cfg["num_class"]


def train_per_sample(cfg: dict, time_steps: int) -> int:
    return 3 * forward_per_sample(cfg, time_steps)
