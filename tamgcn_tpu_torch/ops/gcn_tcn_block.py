"""The whole eval-mode GCN+TCN block: its plain version and the dispatcher of K5.

Counterpart of tamgcn_tpu/ops/pallas/gcn_tcn_block.py. In eval mode every
BatchNorm of a TCN_GCN_unit is a per-channel affine folded into the 1x1 conv
beside it (models/ctrgcn_infer.py), and the block up to its dilated temporal
branches is

    x3     = x @ W3 + b3                       # packed conv3 of the S subsets
    y      = unit_ctr_gc(x1, x2, x3)           # the CTR-GC aggregation
    y      = y * gy[0] + gy[1]                 # unit_gcn BN
    res    = x  |  x @ Wd + bd                 # identity / folded down conv
    off    = tanh((res - y) @ Wo + bo)         # TAM offset conv (folded)
    h      = relu(y + off + res)               # unit_gcn output
    prefix = relu(h @ Wp + bp)                 # TCN entry conv (folded)
    pw     = h @ Wpw + bpw                     # TCN 1x1 branch (folded)

`gcn_tcn_block_fused` runs it through the custom op `tamgcn::gcn_tcn_block`
(one node of a `torch.export` graph): the plain version for CPU tensors,
the CUDA kernel K5 (ops/cuda/gcn_tcn_block.py) for CUDA tensors, with no
fallback.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .aggregation import unit_ctr_gc_plain


def gcn_tcn_block_plain(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                        wp, bp, wpw, bpw, wd=None, bd=None,
                        aggregate=unit_ctr_gc_plain):
    """Plain version of K5. x (N,T,V,Cin); x1s/x2s (N,S,V,R); w3 (Cin,S*C);
    b3 (S*C,); w4s (S,R,C); b4s (S,C); alpha (1,); As (S,V,V); gy (2,C);
    wo (C,C); bo (C,); wp (C,P); bp (P,); wpw (C,BC); bpw (BC,); wd (Cin,C)
    and bd (C,), or None for an identity residual. Returns (prefix
    (N,T,V,P), pw (N,T,V,BC)), pw at every frame. `aggregate` computes the
    unit op (ops/aggregation.py:unit_ctr_gc_plain; the folded comparison
    path passes the dispatcher unit_ctr_gc, K1 on the card)."""
    x3 = torch.matmul(x, w3) + b3
    y = aggregate(x1s, x2s, x3, w4s, b4s, alpha, As)
    y = y * gy[0] + gy[1]
    res = x if wd is None else torch.matmul(x, wd) + bd
    off = torch.tanh(torch.matmul(res - y, wo) + bo)
    h = F.relu(y + off + res)
    return F.relu(torch.matmul(h, wp) + bp), torch.matmul(h, wpw) + bpw


# K5's launcher limits (csrc/gcn_tcn_block.cu), copied so that the CPU can
# read the rule without a build: its aggregation is K1's, which takes any V
# in one of its two designs, and K5 takes V up to 28 (the widths it was
# sized and checked at); its epilogue phase keeps rows of all C channels
_SMEM_LIMIT = 232448  # bytes a block may use on sm_90
_MAX_V = 28


def _phase_b_fits(Cin: int, C: int) -> bool:
    def smem(br):
        return 4 * br * (C + 4 + max(Cin + 1, C + 4))

    br = max(32, min(128, 512 * 16 // C)) // 4 * 4
    while br > 4 and smem(br) > _SMEM_LIMIT:
        br //= 2
    return smem(br) <= _SMEM_LIMIT


def k5_takes(V: int, Cin: int, C: int, R: int) -> bool:
    """Whether K5's launcher takes a block of V joints, Cin input and C output
    channels and R = the embedding width (C % 4 == 0, R <= 32 as the wrapper
    checks): V <= 28 and rows of all channels fit its epilogue's block. Read
    from the shape alone, with no build and no launch;
    tests/test_torch_cuda.py holds it to the launcher."""
    if C < 4 or C % 4 or not 1 <= R <= 32 or V < 1 or Cin < 1:
        return False
    return V <= _MAX_V and _phase_b_fits(Cin, C)


_T = torch.Tensor


@torch.library.custom_op("tamgcn::gcn_tcn_block", mutates_args=(), device_types="cpu")
def gcn_tcn_block_op(x: _T, x1s: _T, x2s: _T, w3: _T, b3: _T, w4s: _T, b4s: _T,
                     alpha: _T, As: _T, gy: _T, wo: _T, bo: _T, wp: _T, bp: _T,
                     wpw: _T, bpw: _T, wd: Optional[_T], bd: Optional[_T]
                     ) -> tuple[_T, _T]:
    """K5 as the custom op `tamgcn::gcn_tcn_block`: the plain version on the
    CPU, K5 (ops/cuda/gcn_tcn_block.py:gcn_tcn_block_fwd) on a CUDA device.
    wd and bd None for an identity residual."""
    prefix, pw = gcn_tcn_block_plain(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy,
                                     wo, bo, wp, bp, wpw, bpw, wd, bd)
    return prefix.contiguous(), pw.contiguous()


@gcn_tcn_block_op.register_kernel("cuda")
def _gcn_tcn_block_cuda(*args):
    from .cuda import gcn_tcn_block

    return gcn_tcn_block.gcn_tcn_block_fwd(*args)


@gcn_tcn_block_op.register_fake
def _gcn_tcn_block_fake(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                        wp, bp, wpw, bpw, wd, bd):
    N, T, V, _ = x.shape
    return x.new_empty((N, T, V, wp.shape[-1])), x.new_empty((N, T, V, wpw.shape[-1]))


def gcn_tcn_block_fused(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                        wp, bp, wpw, bpw, wd=None, bd=None):
    """One eval-mode block on the device of x through `gcn_tcn_block_op`:
    the plain version for a CPU tensor, K5 for a CUDA tensor (which raises
    on what it does not take; there is no fallback). Shapes as
    gcn_tcn_block_plain."""
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"gcn_tcn_block_fused on device {x.device}")
    return gcn_tcn_block_op(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                            wp, bp, wpw, bpw, wd, bd)
