"""The whole eval-mode GCN+TCN block on the card: the wrapper of K5.

  K5 `gcn_tcn_block_fwd`   csrc/gcn_tcn_block.cu  (f32: gcn_tcn_block_f32;
                                                  bf16: gcn_tcn_block_bf16)

Counterpart of tamgcn_tpu/ops/pallas/gcn_tcn_block.py:gcn_tcn_block_fused; its
plain version is ops/gcn_tcn_block.py:gcn_tcn_block_plain. The wrapper checks
its inputs, allocates the outputs and the scratch (x3, then the unit op's
output y, which pass through device memory between the kernel's three
phases), and launches them on the current stream as one call; it never
falls back to the plain version. On a bfloat16 x it launches the bf16 form
(the JAX kernel's bf16 body: bf16 products, x3 and the epilogue f32, bf16
outputs), the other operands widened to float32 where they are bfloat16,
and counts it on `launches_bf16`; its scratch holds the f32 form's and,
after it, the weights rounded once to bf16 by the call's first kernel (and
x padded where its rows are not 16-byte copies): as many floats as the C
query gcn_tcn_block_bf16_scratch_floats says.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ctr_gc import _check_unit, _launch

SOURCE = "gcn_tcn_block.cu"
# calls that launched K5 (its bf16 form) so far; a run sets them to 0 and
# reads them to show that a path went through the kernel
launches = 0
launches_bf16 = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# the argument types of the C entry points gcn_tcn_block_f32 and _bf16
ARGTYPES = [_P] * 21 + [_I] * 9 + [_P]
# what the launcher refuses once the wrapper's checks pass
REFUSED = ("K5 takes V <= 28 (wider blocks take the folded path), N * T * V * S * C < "
           "2**31, and rows of all C channels in a block's shared memory")


def _kernel(form: str = "f32"):
    return build.entry(SOURCE, f"gcn_tcn_block_{form}", ARGTYPES, ctypes.c_int)


def scratch_floats(N: int, T: int, V: int, S: int, C: int) -> int:
    """Floats of K5's scratch in f32: x3, rounded up to 4 floats, then y."""
    return (N * T * V * S * C + 3) // 4 * 4 + N * T * V * C


def scratch_floats_bf16(x_ptr: int, N: int, T: int, V: int, S: int, Cin: int, C: int, P: int,
                        BC: int) -> int:
    """Floats of K5's scratch in bf16 for a bf16 x at address x_ptr (whether
    x is padded depends on its alignment): the C launcher's own count."""
    query = build.entry(SOURCE, "gcn_tcn_block_bf16_scratch_floats", [_P] + [_I] * 8,
                        ctypes.c_longlong)
    return query(x_ptr, N, S, T, V, Cin, C, P, BC)


def gcn_tcn_block_fwd(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo,
                      wp, bp, wpw, bpw, wd=None, bd=None):
    """K5. x (N,T,V,Cin); x1s/x2s (N,S,V,R); w3 (Cin,S*C); b3 (S*C,); w4s
    (S,R,C); b4s (S,C); alpha (1,); As (S,V,V); gy (2,C); wo (C,C); bo (C,);
    wp (C,P); bp (P,); wpw (C,BC); bpw (BC,); wd (Cin,C) and bd (C,), or
    None for an identity residual (Cin == C). All contiguous on one CUDA
    device, 4-value aligned, with R <= 32 and C, P, BC % 4 == 0; x float32
    or bfloat16, the rest float32 (bfloat16 widened where x is bfloat16)
    -> (prefix (N,T,V,P), pw (N,T,V,BC)) in the dtype of x."""
    global launches, launches_bf16
    from ..gcn_tcn_block import widened

    (x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp, wpw, bpw, wd,
     bd) = widened(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp, wpw, bpw,
                   wd, bd)
    N, T, V, Cin = x.shape
    S, R = x1s.shape[1], x1s.shape[-1]
    C, P, BC = w4s.shape[-1], wp.shape[-1], wpw.shape[-1]
    device = x.device
    if (wd is None) != (bd is None):
        raise ValueError("wd and bd are both given or both None")
    if wd is None and Cin != C:
        raise ValueError(f"an identity residual needs Cin == C, got {Cin} and {C}")
    named = [
        ("x", x, (N, T, V, Cin)), ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)), ("w3", w3, (Cin, S * C)), ("b3", b3, (S * C,)),
        ("w4s", w4s, (S, R, C)), ("b4s", b4s, (S, C)), ("alpha", alpha, (1,)),
        ("As", As, (S, V, V)), ("gy", gy, (2, C)), ("wo", wo, (C, C)),
        ("bo", bo, (C,)), ("wp", wp, (C, P)), ("bp", bp, (P,)),
        ("wpw", wpw, (C, BC)), ("bpw", bpw, (BC,)),
    ]
    if wd is not None:
        named += [("wd", wd, (Cin, C)), ("bd", bd, (C,))]
    act = _check_unit("gcn_tcn_block_fwd", device, named, R, C,
                      aligned=[name for name, _, _ in named], activations=("x",))
    bf16 = act == torch.bfloat16
    for name, width in (("P", P), ("BC", BC)):
        if width % 4:
            raise ValueError(f"{name}={width}: the kernel reads channels in "
                             "fours and takes a multiple of 4")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=device, dtype=dtype)

    # scratch: x3 (N,T,V,S*C), rounded to 4 floats, then the unit op's output
    # (N,T,V,C), which pass between the kernel's phases, f32 in both forms;
    # in bf16 the rounded weights after them
    y = empty(scratch_floats_bf16(x.data_ptr(), N, T, V, S, Cin, C, P, BC) if bf16
              else scratch_floats(N, T, V, S, C))
    prefix, pw = empty(N, T, V, P, dtype=act), empty(N, T, V, BC, dtype=act)
    ptrs = [t.data_ptr() for t in (x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy)]
    ptrs += [None, None] if wd is None else [wd.data_ptr(), bd.data_ptr()]
    ptrs += [t.data_ptr() for t in (wo, bo, wp, bp, wpw, bpw, y, prefix, pw)]
    _launch(_kernel("bf16" if bf16 else "f32"), device,
            dict(N=N, S=S, T=T, V=V, Cin=Cin, R=R, C=C, P=P, BC=BC),
            *ptrs, N, S, T, V, Cin, R, C, P, BC, refused=REFUSED)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return prefix, pw
