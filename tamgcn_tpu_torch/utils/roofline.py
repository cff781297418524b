"""Speed-of-light (roofline) bounds on an NVIDIA H100.

Counterpart of tamgcn_tpu/utils/roofline.py, with the H100 in place of the
TPU table. The bound of a call is the larger of two times: the bytes it
must move (each input read once, each output written once) over the card's
memory rate, and the operations it does (an FMA counts two) over the peak
rate for their type. The port's kernels run f32 arithmetic outside the
tensor cores, so the operations are held to the f32 peak.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W limit: 80 GB
of HBM3 at 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores. A card set
below 700 W runs slower under load; a roofline share is stated against
these peaks with the card's limit beside it.
"""
from __future__ import annotations

import math

HBM_BW = 3.35e12  # bytes/s
F32_FLOPS = 67e12  # FLOP/s, f32 outside the tensor cores


def bound(elems: int, flops: int, *, itemsize: int = 4):
    """(ms, 'bytes' | 'operations'): `elems` values of `itemsize` bytes over
    the memory rate, or `flops` over the f32 peak, whichever is larger."""
    bytes_ms = itemsize * elems / HBM_BW * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def unit_ctr_gc_sol(n: int, t: int, v: int, c: int, r: int, s: int = 3):
    """The unit CTR-GC forward (K1): x1s, x2s, x3s, w4s, b4s, alpha, As in,
    (n,t,v,c) out; the FMAs of M (v*v*r*c per sample and subset) and of the
    aggregation (t*v*v*c). Returns bound()'s (ms, by)."""
    elems = (2 * n * s * v * r + n * t * v * s * c + s * r * c + s * c + 1
             + s * v * v + n * t * v * c)
    return bound(elems, 2 * n * s * (v * v * r * c + t * v * v * c))


def ms_tcn_sol(n: int, t: int, v: int, bc: int, stride: int = 1):
    """The eval multi-scale TCN (T1) on a prefix (n,t,v,3*bc): the prefix,
    w (2,5,bc,bc), b (2,bc) and the max-pool affine (2,bc) in, (n,ceil(t/
    stride),v,3*bc) out; per output frame and joint 2*5*bc*bc FMAs of the two
    dilated branches and, per max-pool output, two maxima and one FMA."""
    t_out = math.ceil(t / stride)
    rows = n * t_out * v
    elems = n * t * v * 3 * bc + rows * 3 * bc + 2 * 5 * bc * bc + 4 * bc
    return bound(elems, 2 * rows * 2 * 5 * bc * bc + 4 * rows * bc)


def stage2_sol(n: int, t: int, v: int, l: int, subsets: int = 1, *, itemsize: int = 4):
    """The stage-2 aggregation (T2) from a given M (v,v,l) on x3 (n,t,v,l):
    out (n,t,v,l), or (n,t,v,l/subsets) with the subset sum; v FMAs per
    output joint and channel. Returns bound()'s (ms, by)."""
    elems = v * v * l + n * t * v * l + n * t * v * (l // subsets)
    return bound(elems, 2 * n * t * v * v * l, itemsize=itemsize)
