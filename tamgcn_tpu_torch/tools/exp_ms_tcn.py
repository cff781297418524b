"""The eval multi-scale TCN kernel (T1) against the fast-eval engine's
composition (two F.conv2d, F.max_pool2d, the affine and torch.cat, which
run on cuDNN and PyTorch's own kernels on the card), at the NW-UCLA block
shapes. Counterpart of tools/exp_ms_tcn.py, with its shapes, its check and
its log lines; T1 stands where the Pallas kernel stood and the composition
where XLA's did.

    python -m tamgcn_tpu_torch.tools.exp_ms_tcn [--device cpu]

On the CPU both sides are the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.ms_tcn import KS, ms_tcn_fused, ms_tcn_plain
from ..utils.timing import time_chained
from . import device_name, log, tool_args, tool_device

# (N, T, V, C, stride) of the JAX tool: the blocks l2-l4, l5, l6-l7, l8,
# l9-l10 at batch 64, and an NTU-shaped shallow block (two persons folded
# into N); bc = C / 4
SHAPES = (
    (64, 52, 20, 64, 1),
    (64, 52, 20, 128, 2),
    (64, 26, 20, 128, 1),
    (64, 26, 20, 256, 2),
    (64, 13, 20, 256, 1),
    (32, 64, 25, 64, 1),
)


def bench(n, t, v, c, stride=1, *, device, chain=60, iters=10):
    """One shape: the kernel's relative error against the plain version
    (asserted below 2e-2, the JAX tool's check), then both timed with
    time_chained. Returns (kernel s, plain s, rel err)."""
    bc = c // 4
    rs = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    prefix = put(rs.randn(n, t, v, 3 * bc))
    w = put(rs.randn(2, KS, bc, bc) * 0.1)
    b = put(rs.randn(2, bc) * 0.1)
    mp = put(np.stack([np.ones(bc), np.zeros(bc)]))

    with torch.no_grad():
        got = ms_tcn_fused(prefix, w, b, mp, stride)
        want = ms_tcn_plain(prefix, w, b, mp, stride)
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()
    assert err < 2e-2, f"numerics mismatch rel {err}"

    def feed(out, a):
        if stride == 1:
            return (out * 0.5 + a[0] * 0.5,)
        return (a[0] + out.mean() * 1e-9,)

    with torch.no_grad():
        dt_k = time_chained(lambda p: ms_tcn_fused(p, w, b, mp, stride), feed,
                            (prefix,), chain=chain, iters=iters)
        dt_x = time_chained(lambda p: ms_tcn_plain(p, w, b, mp, stride), feed,
                            (prefix,), chain=chain, iters=iters)
    log(f"T={t:3d} C={c:3d} bc={bc:3d} s={stride}: kernel {dt_k*1e6:8.1f} us"
        f"   cudnn {dt_x*1e6:8.1f} us   ({dt_x/dt_k:.2f}x)  rel_err {err:.1e}")
    return dt_k, dt_x, err


def main(argv=None):
    args = tool_args(argv, __doc__.splitlines()[0], chain=60, iters=10)
    device = tool_device(args.device)
    log("device:", device, device_name(device))
    return [bench(*shape, device=device, chain=args.chain, iters=args.iters)
            for shape in SHAPES]


if __name__ == "__main__":
    main()
