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

On a bfloat16 x the block follows the JAX kernel's bf16 body
(tamgcn_tpu/ops/pallas/gcn_tcn_block.py:52-149, `mm = bf16`): every product
(x @ W3, stage 1's tanh(x1 - x2) @ w4, x @ Wd, (res - y) @ Wo, h @ Wp and
h @ Wpw) takes both operands rounded to bf16 and sums in f32; x3 stays f32
and the aggregation is f32 x f32; the epilogue is f32, the identity
residual x widened; prefix and pw are rounded once to bf16 at the end.
x1s, x2s and the parameters may be float32 or bfloat16: they are widened
to f32 (exact), as the JAX kernel widens them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .aggregation import unit_ctr_gc_plain


def widened(x, *operands):
    """The operands of one block with every bfloat16 tensor but x widened to
    float32 where x is bfloat16 (None stays None); as they are otherwise."""
    if x.dtype != torch.bfloat16:
        return operands
    return tuple(t.float() if t is not None and t.dtype == torch.bfloat16 else t
                 for t in operands)


def unit_stage1_bf16(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """The unit op as the bf16 form of the block computes it: M's product
    over r on D = tanh(x1 - x2) and w4s rounded to bf16, summed in f32; the
    aggregation f32 x f32 on the f32 x3s. All inputs f32; -> (N,T,V,C) f32.
    (unit_ctr_gc_plain's bf16 form takes a bf16 x3s.)"""
    return unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, stage1=torch.bfloat16)


def _bf16_operand(t):
    """A product's operand in the bf16 form: rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


def gcn_tcn_block_plain(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                        wp, bp, wpw, bpw, wd=None, bd=None, aggregate=None):
    """Plain version of K5. x (N,T,V,Cin); x1s/x2s (N,S,V,R); w3 (Cin,S*C);
    b3 (S*C,); w4s (S,R,C); b4s (S,C); alpha (1,); As (S,V,V); gy (2,C);
    wo (C,C); bo (C,); wp (C,P); bp (P,); wpw (C,BC); bpw (BC,); wd (Cin,C)
    and bd (C,), or None for an identity residual. Returns (prefix
    (N,T,V,P), pw (N,T,V,BC)) in the dtype of x, pw at every frame; on a
    bfloat16 x the bf16 form (module docstring). `aggregate` computes the
    unit op (by default ops/aggregation.py:unit_ctr_gc_plain, in bf16
    unit_stage1_bf16; the folded comparison path passes the dispatcher
    unit_ctr_gc, K1 on the card)."""
    if x.dtype == torch.bfloat16:
        return _block_plain_bf16(x, *widened(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy,
                                              wo, bo, wp, bp, wpw, bpw, wd, bd),
                                 aggregate=aggregate or unit_stage1_bf16)
    aggregate = aggregate or unit_ctr_gc_plain
    x3 = torch.matmul(x, w3) + b3
    y = aggregate(x1s, x2s, x3, w4s, b4s, alpha, As)
    y = y * gy[0] + gy[1]
    res = x if wd is None else torch.matmul(x, wd) + bd
    off = torch.tanh(torch.matmul(res - y, wo) + bo)
    h = F.relu(y + off + res)
    return F.relu(torch.matmul(h, wp) + bp), torch.matmul(h, wpw) + bpw


def _block_plain_bf16(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp, wpw,
                      bpw, wd, bd, aggregate):
    """gcn_tcn_block_plain's bf16 form (module docstring), its operands
    other than x float32."""
    r = _bf16_operand
    xf = x.float()
    x3 = torch.matmul(r(xf), r(w3)) + b3
    y = aggregate(x1s, x2s, x3, w4s, b4s, alpha, As)
    y = y * gy[0] + gy[1]
    res = xf if wd is None else torch.matmul(r(xf), r(wd)) + bd
    off = torch.tanh(torch.matmul(r(res - y), r(wo)) + bo)
    h = r(F.relu(y + off + res))
    prefix = F.relu(torch.matmul(h, r(wp)) + bp)
    return prefix.to(x.dtype), (torch.matmul(h, r(wpw)) + bpw).to(x.dtype)


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
    gcn_tcn_block_plain; on a bfloat16 x, its bf16 form (either side widens
    the other operands to float32 where they are bfloat16)."""
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"gcn_tcn_block_fused on device {x.device}")
    return gcn_tcn_block_op(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                            wp, bp, wpw, bpw, wd, bd)
