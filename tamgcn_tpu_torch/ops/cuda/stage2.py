"""The stage-2 aggregation on the card: the wrapper of T2.

  T2 `stage2_aggregate_fwd`   csrc/stage2_aggregate.cu

Counterpart of the Pallas probes of tools/exp_stage2.py and
tools/exp_stage2b.py; its plain versions are in ops/stage2.py. The wrapper
checks its inputs, allocates the output and launches the kernel on the
current stream; it never falls back to a plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ctr_gc import _launch

SOURCE = "stage2_aggregate.cu"
# calls that launched T2 so far; a run sets it to 0 and reads it to show that
# a path went through the kernel
launches = 0

# the launcher's codes of the index rules and the operand types
RULE_CODES = {"tile": 0, "diag": 1, "floor": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the argument types of the launcher stage2_aggregate
ARGTYPES = [_P] * 3 + [_I] * 7 + [_P]


def _entry(name, argtypes):
    return build.entry(SOURCE, name, argtypes, ctypes.c_int)


def stage2_aggregate_fwd(m, x3, rule: str, subsets: int = 1):
    """T2. m (V,V,L) and x3 (N,T,V,L), contiguous, both float32 or both
    bfloat16 on one CUDA device; rule 'tile' (v = j), 'diag' (v = (u+j) mod
    V) or 'floor' (v = u); subsets 1, or S > 1 to sum the S subsets of L =
    S*C -> (N,T,V,L/subsets) in the operands' type, accumulated in f32."""
    global launches
    if rule not in RULE_CODES:
        raise ValueError(f"unknown rule {rule!r}; one of {tuple(RULE_CODES)}")
    device = x3.device
    if device.type != "cuda":
        raise ValueError(f"stage2_aggregate_fwd takes CUDA tensors, got {device}")
    if x3.ndim != 4:
        raise ValueError(f"x3 must be (N, T, V, L), got {tuple(x3.shape)}")
    N, T, V, L = x3.shape
    for name, t, shape in (("m", m, (V, V, L)), ("x3", x3, (N, T, V, L))):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in DTYPE_CODES or t.dtype != x3.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 or "
                            "bfloat16, the same for m and x3")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if subsets < 1 or L % subsets:
        raise ValueError(f"the subset sum needs L % S == 0, got L={L}, S={subsets}")
    if _entry("stage2_channel_tile", [_I] * 3)(V, L, subsets) == 0:
        raise ValueError(f"stage2_aggregate_fwd does not take V={V} (V <= 32): M "
                         "of a channel tile must fit a block's shared memory")
    out = torch.empty((N, T, V, L // subsets), device=device, dtype=x3.dtype)
    _launch(_entry("stage2_aggregate", ARGTYPES), device,
            dict(N=N, T=T, V=V, L=L, rule=rule, subsets=subsets),
            m.data_ptr(), x3.data_ptr(), out.data_ptr(), N, T, V, L,
            RULE_CODES[rule], subsets, DTYPE_CODES[x3.dtype])
    launches += 1
    return out
