"""The least time of the unit op's kernels on one NVIDIA H100, against the
data-sheet peaks.

The operation and byte counts are those of the program's roofline module
for the unit op's forward (K1), its x3 gradient (K2) and its parameter
gradients (K3), copied here. The least time of a call is the larger of its
bytes (each input read once, each output written once) at the memory rate
and its operations at the dense tensor-core peak of its operands'
precision: f32 operands at the TF32 peak, bf16 at the bf16 peak. No f32
product on this card runs faster than the TF32 peak, so no implementation
can read above 100% of these bounds, whichever unit it runs on.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 3.35 TB/s of
HBM3, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on the tensor cores."""
from __future__ import annotations

from ..reference.model import SUBSETS
from .flops import blocks

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
ACT_BYTES = {"float32": 4, "bfloat16": 2}


def _seconds(act_elems: int, param_elems: int, flops: int, precision: str) -> float:
    nbytes = ACT_BYTES[precision] * act_elems + 4 * param_elems
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[precision])


def forward_s(n, t, v, c, r, s=SUBSETS, precision="float32") -> float:
    """K1: x1s, x2s, x3s and the parameters in, (n, t, v, c) out; M's
    product and the aggregation."""
    acts = 2 * n * s * v * r + n * t * v * s * c + n * t * v * c
    params = s * r * c + s * c + 1 + s * v * v
    return _seconds(acts, params, 2 * n * s * t * v * v * c + 2 * n * s * v * v * r * c,
                    precision)


def dx3_s(n, t, v, c, r, s=SUBSETS, precision="float32") -> float:
    """K2: x1s, x2s, the output gradient and the parameters in, the x3
    gradient out; as K1's products."""
    acts = 2 * n * s * v * r + n * t * v * c + n * t * v * s * c
    params = s * r * c + s * c + 1 + s * v * v
    return _seconds(acts, params, 2 * n * s * t * v * v * c + 2 * n * s * v * v * r * c,
                    precision)


def param_s(n, t, v, c, r, s=SUBSETS, precision="float32") -> float:
    """K3: g, x3s, x1s, x2s and the parameters in; dx1s, dx2s and the
    parameter gradients out. dm = sum_t g x3 (t v v c per sample and subset),
    then D^T dm and dm w4^T (v v r c each)."""
    acts = n * t * v * c + n * t * v * s * c + 4 * n * s * v * r
    params = 2 * (s * r * c + s * c + 1) + s * v * v
    flops = 2 * n * s * t * v * v * c + 4 * n * s * v * v * r * c
    return _seconds(acts, params, flops, precision)


def unit_op_s(cfg: dict, time_steps: int, batch: int, train: bool,
              precision: str = "float32") -> float:
    """The least time of the unit op's kernels in one step of `batch`
    samples: every block's forward and, in training, its x3 and parameter
    gradients."""
    total = 0.0
    for m, t, _, v, cin, c, r, _, _ in blocks(cfg, time_steps):
        n = batch * m
        total += forward_s(n, t, v, c, r, precision=precision)
        if train:
            total += dx3_s(n, t, v, c, r, precision=precision)
            total += param_s(n, t, v, c, r, precision=precision)
    return total
