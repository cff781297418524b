"""The eval multi-scale TCN on the card: the wrapper of T1.

  T1 `ms_tcn_fwd`   csrc/ms_tcn.cu

Counterpart of tools/exp_ms_tcn.py:ms_tcn_fused; its plain version is
ops/ms_tcn.py:ms_tcn_plain. The wrapper checks its inputs, allocates the
output and launches the kernel on the current stream; it never falls back
to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ctr_gc import _check, _launch

SOURCE = "ms_tcn.cu"
# calls that launched T1 so far; a run sets it to 0 and reads it to show that
# a path went through the kernel
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry(name, argtypes):
    return build.entry(SOURCE, name, argtypes, ctypes.c_int)


def ms_tcn_fwd(prefix, w, b, mp_affine, stride: int = 1):
    """T1. prefix (N,T,V,3*bc); w (2,5,bc,bc) as (in,out); b (2,bc);
    mp_affine (2,bc) (scale, bias), all contiguous float32 on one CUDA
    device; stride 1 or 2 -> (N, ceil(T/stride), V, 3*bc)."""
    global launches
    from ..ms_tcn import ms_tcn_dims

    N, T, V, bc = ms_tcn_dims(prefix, w, b, mp_affine, stride)
    device = prefix.device
    if device.type != "cuda":
        raise ValueError(f"ms_tcn_fwd takes CUDA tensors, got {device}")
    for name, t in (("prefix", prefix), ("w", w), ("b", b), ("mp_affine", mp_affine)):
        _check(name, t, t.shape, device)
    frames = _entry("ms_tcn_frames_per_block", [_I] * 4)(T, V, bc, stride)
    if frames < 1 or N > 65535:
        raise ValueError(
            f"ms_tcn_fwd does not take N={N} T={T} V={V} bc={bc} stride={stride}: "
            "N <= 65535, and a block's frames and one tap's weights must fit its "
            "shared memory and registers (bc <= 128 at V <= 25)")
    out = torch.empty((N, -(-T // stride), V, 3 * bc), device=device, dtype=torch.float32)
    _launch(_entry("ms_tcn_f32", [_P] * 5 + [_I] * 5 + [_P]), device,
            dict(N=N, T=T, V=V, bc=bc, stride=stride),
            prefix.data_ptr(), w.data_ptr(), b.data_ptr(), mp_affine.data_ptr(),
            out.data_ptr(), N, T, V, bc, stride)
    launches += 1
    return out
