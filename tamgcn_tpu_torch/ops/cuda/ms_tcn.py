"""The eval multi-scale TCN on the card: the wrapper of T1.

  T1 `ms_tcn_fwd`   csrc/ms_tcn.cu  (f32: ms_tcn_f32; bf16: ms_tcn_bf16)

Counterpart of tools/exp_ms_tcn.py:ms_tcn_fused; its plain version is
ops/ms_tcn.py:ms_tcn_plain. The wrapper checks its inputs, allocates the
output and launches the kernel on the current stream; it never falls back
to the plain version. On a bfloat16 prefix it launches the bf16 form (the
prefix staged as bf16, f32 w split into three bf16 parts for bf16 MMAs that
give the f32 products, f32 b and mp, the output rounded once to bf16) and
counts it on `launches_bf16`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ctr_gc import _check, _launch

SOURCE = "ms_tcn.cu"
# calls that launched T1 (its bf16 form) so far; a run sets them to 0 and
# reads them to show that a path went through the kernel
launches = 0
launches_bf16 = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# the argument types of the launchers ms_tcn_f32 and ms_tcn_bf16
ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]


def _entry(name, argtypes):
    return build.entry(SOURCE, name, argtypes, ctypes.c_int)


def ms_tcn_fwd(prefix, w, b, mp_affine, stride: int = 1):
    """T1. prefix (N,T,V,3*bc) float32 or bfloat16; w (2,5,bc,bc) as
    (in,out); b (2,bc); mp_affine (2,bc) (scale, bias) float32 (bfloat16
    widened where the prefix is bfloat16), all contiguous on one CUDA
    device; stride 1 or 2 -> (N, ceil(T/stride), V, 3*bc) in the prefix's
    dtype."""
    global launches, launches_bf16
    from ..ms_tcn import ms_tcn_dims

    if prefix.dtype == torch.bfloat16:
        w, b, mp_affine = (t.float() if t.dtype == torch.bfloat16 else t
                           for t in (w, b, mp_affine))

    N, T, V, bc = ms_tcn_dims(prefix, w, b, mp_affine, stride)
    device = prefix.device
    if device.type != "cuda":
        raise ValueError(f"ms_tcn_fwd takes CUDA tensors, got {device}")
    act = prefix.dtype
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prefix is {act}; ms_tcn_fwd takes it in float32 or bfloat16")
    for name, t in (("prefix", prefix), ("w", w), ("b", b), ("mp_affine", mp_affine)):
        _check(name, t, t.shape, device, act if name == "prefix" else torch.float32)
    bf16 = act == torch.bfloat16
    frames = _entry("ms_tcn_frames_per_block", [_I] * 5)(T, V, bc, stride, int(bf16))
    if frames < 1 or N > 65535:
        raise ValueError(
            f"ms_tcn_fwd does not take N={N} T={T} V={V} bc={bc} stride={stride}: "
            "N <= 65535, and one frame of one joint with its halo and the five "
            "taps' weights of 8 output channels must fit a block's shared memory "
            "(bc <= 336 at stride 1 in float32)")
    out = torch.empty((N, -(-T // stride), V, 3 * bc), device=device, dtype=act)
    _launch(_entry("ms_tcn_bf16" if bf16 else "ms_tcn_f32", ARGTYPES), device,
            dict(N=N, T=T, V=V, bc=bc, stride=stride),
            prefix.data_ptr(), w.data_ptr(), b.data_ptr(), mp_affine.data_ptr(),
            out.data_ptr(), N, T, V, bc, stride)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
