"""Stage-2 aggregation experiments: the stage-2 kernel (T2) in each of its
forms beside the production unit op (K1), at the deep-layer benchmark shape
(N=64, T=13, V=20, C=256, S=3), with a given M shared by the batch:

    out[t,u,c] = sum_v M[u,v,c] * x3[t,v,c]

Counterpart of tools/exp_stage2.py, with its shapes and variant names. The
JAX tool's variants are schedules of one computation on the TPU (lane
tiles, accumulator chains, batch blocks); on the card each maps to the one
kernel T2 in the form it computes, and is printed under its JAX name:

  bcast, roll             K1, the production unit op (ops/aggregation.py:unit_ctr_gc)
  tile128 ... t256a2      T2, tile form (M laid out (v, u, c))
  win                     T2, diagonal form (v = (u + d) mod V)
  floor1, floor4          T2, floor form (v = u)
  flat(ss=1), flat(ss=0)  T2, diagonal form on flattened operands, with and
                          without the subset sum

then the flat form's numerics against a numpy oracle.

    python -m tamgcn_tpu_torch.tools.exp_stage2 [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.aggregation import unit_ctr_gc
from ..ops.stage2 import stage2_aggregate
from ..utils.timing import time_chained
from . import device_name, log, tool_args, tool_device

# the benchmark shape; read at call time, so a caller may set them smaller
N, T, V, C, R, S = 64, 13, 20, 256, 32, 3
SC = S * C

# (JAX variant name, T2 form) of the probes on a given M
PROBES = (
    ("tile128", "tile"), ("t128a2", "tile"), ("t128a4", "tile"), ("t128b2", "tile"),
    ("t128b4", "tile"), ("t128a2b2", "tile"), ("t256a2", "tile"),
    ("win", "win"), ("floor1", "floor"), ("floor4", "floor"),
)
PRODUCTION = ("bcast", "roll")


def feed_md(out, a):
    # thread a trivial dependency through the first arg to serialize
    return (a[0] + out.reshape(-1)[:1].float().mean() * 1e-20, a[1])


def main(argv=None):
    args = tool_args(argv, __doc__.splitlines()[0], chain=30, iters=5)
    device = tool_device(args.device)
    chain, iters = args.chain, args.iters
    rs = np.random.RandomState(0)
    log(f"device={device} {device_name(device)}")

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    # ---------------- production form (real op, K1) ----------------
    prod = (
        put(rs.randn(N, S, V, R)), put(rs.randn(N, S, V, R)),
        put(rs.randn(N, T, V, SC)), put(rs.randn(S, R, C) * 0.1),
        put(rs.randn(S, C) * 0.1), put([0.1]), put(rs.rand(S, V, V) * 0.02),
    )

    def feed_prod(out, a):
        return a[:2] + (torch.cat([out] * S, -1) * 1e-3,) + a[3:]

    times = {}
    with torch.no_grad():
        for form in PRODUCTION:
            dt = time_chained(unit_ctr_gc, feed_prod, prod, chain=chain, iters=iters)
            times[form] = dt
            log(f"{form:8s} {dt*1e6:9.1f} us  (K1)")

        # ---------------- probes on a given M (T2) ----------------
        md = put(rs.randn(V, V, SC) * 0.05)
        x3 = prod[2]
        for name, form in PROBES:
            dt = time_chained(lambda m, x, form=form: stage2_aggregate(m, x, form),
                              feed_md, (md, x3), chain=chain, iters=iters)
            times[name] = dt
            log(f"{name:8s} {dt*1e6:9.1f} us  (T2 {form})")

        mdflat = put(rs.randn(V, V * SC) * 0.05)
        x3flat = x3.reshape(N, T, V * SC)
        for ss in (True, False):
            dt = time_chained(lambda m, x, ss=ss: stage2_aggregate(m, x, "flat", S, ss),
                              feed_md, (mdflat, x3flat), chain=chain, iters=iters)
            times[f"flat(ss={int(ss)})"] = dt
            log(f"flat(ss={int(ss)}) {dt*1e6:7.1f} us  (T2 flat)")

        # ---------------- flat-form numerics vs oracle ----------------
        # out[t,u,sc] = sum_d MD[d, u*SC+sc] * x3[t, (u+d)%V, sc]
        mdr = mdflat.cpu().numpy().reshape(V, V, SC)  # [d, u, sc]
        x3n = x3.cpu().numpy()                         # [n, t, v, sc]
        m_full = np.zeros((V, V, SC), np.float32)      # [u, v, sc]
        for d in range(V):
            for u in range(V):
                m_full[u, (u + d) % V] = mdr[d, u]
        want = np.einsum("uvc,ntvc->ntuc", m_full, x3n)
        want = want.reshape(N, T, V, S, C).sum(3)
        got = stage2_aggregate(mdflat, x3flat, "flat", S, True).cpu().numpy()
        err = np.abs(got.reshape(N, T, V, C) - want).max() / max(np.abs(want).max(), 1e-9)
    log(f"flat numerics vs oracle: rel-max-err {err:.2e}")
    times["flat_rel_err"] = float(err)
    return times


if __name__ == "__main__":
    main()
