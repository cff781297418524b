"""Focused stage-2 probes: repeatability and bf16 operands, at the
deep-layer shape (N=64, T=13, V=20, C=256, S=3).

Counterpart of tools/exp_stage2b.py, with its candidates and names: three
repeats of the production unit op (K1, under the JAX name `bcast`) and of
the stage-2 kernel's tile form (T2) in f32 (`t128a2`, `t128a3`) and on bf16
operands (`t128a2bf`, accumulated in f32, rounded once to bf16). The JAX
names' lane tile and accumulator count are TPU schedules and mean nothing
on the card: `t128a2` and `t128a3` run the same kernel. The bf16 operands
are cast once, outside the timing.

    python -m tamgcn_tpu_torch.tools.exp_stage2b [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.aggregation import unit_ctr_gc
from ..ops.stage2 import stage2_aggregate
from ..utils.timing import time_chained
from . import device_name, log, tool_args, tool_device
from .exp_stage2 import feed_md

# the benchmark shape; read at call time, so a caller may set them smaller
N, T, V, C, R, S = 64, 13, 20, 256, 32, 3
SC = S * C
REPS = 3
# JAX candidate name -> operand type of T2's tile form (None: K1)
CANDIDATES = (("bcast", None), ("t128a2", torch.float32),
              ("t128a2bf", torch.bfloat16), ("t128a3", torch.float32))


def main(argv=None):
    args = tool_args(argv, __doc__.splitlines()[0], chain=30, iters=10)
    device = tool_device(args.device)
    rs = np.random.RandomState(0)
    log(f"device={device} {device_name(device)}")

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    md = put(rs.randn(V, V, SC) * 0.05)
    x3 = put(rs.randn(N, T, V, SC))
    prod = (
        put(rs.randn(N, S, V, R)), put(rs.randn(N, S, V, R)), x3,
        put(rs.randn(S, R, C) * 0.1), put(rs.randn(S, C) * 0.1), put([0.1]),
        put(rs.rand(S, V, V) * 0.02),
    )

    def feed_prod(out, a):
        return a[:2] + (torch.cat([out] * S, -1) * 1e-3,) + a[3:]

    def tile(m, x):
        return stage2_aggregate(m, x, "tile")

    cands = {name: (unit_ctr_gc, feed_prod, prod) if dtype is None
             else (tile, feed_md, (md.to(dtype), x3.to(dtype)))
             for name, dtype in CANDIDATES}
    times = {name: [] for name in cands}
    with torch.no_grad():
        for rep in range(REPS):
            for name, (f, feed, a) in cands.items():
                dt = time_chained(f, feed, a, chain=args.chain, iters=args.iters)
                times[name].append(dt)
                log(f"rep{rep} {name:9s} {dt*1e6:9.1f} us")
    return times


if __name__ == "__main__":
    main()
