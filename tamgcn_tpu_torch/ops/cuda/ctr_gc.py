"""Unit CTR-GC forward on the card: the wrapper of csrc/unit_ctr_gc_fwd.cu.

Counterpart of tamgcn_tpu/ops/pallas/ctr_gc.py:unit_ctr_gc_fwd_pallas. The
kernel's plain version is ops/aggregation.py:unit_ctr_gc_plain. The wrapper
checks its inputs, allocates the output and launches the kernel on the
current stream; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "unit_ctr_gc_fwd.cu"
# what the launcher returns for a shape it does not take
_CUDA_ERROR_INVALID_VALUE = 1
# kernel launches so far; a run sets it to 0 and reads it to show that a path
# went through the kernel
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).unit_ctr_gc_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """x1s/x2s (N,S,V,R); x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C);
    alpha (1,); As (S,V,V), all contiguous float32 on one CUDA device, with
    R <= 32 and C % 4 == 0 -> out (N,T,V,C). Forward only: the backward kernels come with the
    training slice, so inputs that require grad raise."""
    global launches
    device = x3s.device
    if device.type != "cuda":
        raise ValueError(f"unit_ctr_gc_fwd takes CUDA tensors, got {device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x1s, x2s, x3s, w4s, b4s, alpha, As)
    ):
        raise NotImplementedError(
            "unit_ctr_gc_fwd has no backward yet (training slice); run "
            "under torch.no_grad() or torch.inference_mode()"
        )
    N, S, V, R = x1s.shape
    T = x3s.shape[1]
    C = w4s.shape[-1]
    for name, t, shape in (
        ("x1s", x1s, (N, S, V, R)),
        ("x2s", x2s, (N, S, V, R)),
        ("x3s", x3s, (N, T, V, S * C)),
        ("w4s", w4s, (S, R, C)),
        ("b4s", b4s, (S, C)),
        ("alpha", alpha, (1,)),
        ("As", As, (S, V, V)),
    ):
        _check(name, t, shape, device)
    if R > 32 or C % 4:
        raise ValueError(f"R={R}, C={C}: the kernel takes R <= 32 and C % 4 == 0")
    for name, t in (("x3s", x3s), ("w4s", w4s), ("b4s", b4s)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty((N, T, V, C), device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel()(
            x1s.data_ptr(), x2s.data_ptr(), x3s.data_ptr(), w4s.data_ptr(),
            b4s.data_ptr(), alpha.data_ptr(), As.data_ptr(), out.data_ptr(),
            N, S, T, V, R, C, stream,
        )
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"unit_ctr_gc_fwd_f32 does not take N={N} S={S} T={T} V={V} R={R} "
            f"C={C}: the refined adjacency of a channel tile must fit in a "
            "block's shared memory (V = 20 and V = 25 fit at every R <= 32)"
        )
    if err != 0:
        raise RuntimeError(
            f"unit_ctr_gc_fwd_f32 launch failed: CUDA error {err} "
            f"(N={N} S={S} T={T} V={V} R={R} C={C})"
        )
    launches += 1
    return out
