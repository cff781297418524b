"""CTR-GC graph aggregation: plain PyTorch versions and the kernel dispatcher.

Counterpart of tamgcn_tpu/ops/aggregation.py. Activations are NTVC (batch,
time, vertex, channel), as in the JAX package. The unit op

    out[n,t,u,c] = sum_s sum_v M_s[n,u,v,c] * x3s[n,t,v,s*C+c]
    M_s = (tanh(x1s[n,s,u,:] - x2s[n,s,v,:]) @ w4s[s] + b4s[s]) * alpha + As[s,u,v]

(reference models/ctrgcn.py:174-176, summed over the three subsets) runs
through `unit_ctr_gc`: the plain version below for CPU tensors, the
hand-written CUDA kernel (ops/cuda/ctr_gc.py) for CUDA tensors.
"""
from __future__ import annotations

import torch


def ctr_gc_dynamic_adjacency(x1, x2, w4, b4, alpha, A):
    """Channel-wise refined adjacency M[n,u,v,c] = (tanh(x1-x2)@w4 + b4)*alpha + A.

    x1 (N,U,R), x2 (N,V,R), w4 (R,C), b4 (C,) or None, alpha (1,), A (U,V).
    """
    d = torch.tanh(x1[:, :, None, :] - x2[:, None, :, :])  # (N, U, V, R)
    m = torch.matmul(d, w4)  # (N, U, V, C)
    if b4 is not None:
        m = m + b4
    return m * alpha + A[None, :, :, None]


def ctr_gc_aggregate(m, x3):
    """out[n,t,u,c] = sum_v m[n,u,v,c] * x3[n,t,v,c] (reference 'ncuv,nctv->nctu')."""
    return torch.einsum("nuvc,ntvc->ntuc", m, x3)


def unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """Plain version of the unit op (counterpart of `unit_ctr_gc_xla`).

    x1s/x2s (N,S,V,R); x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha (1,);
    As (S,V,V) -> (N,T,V,C).
    """
    S = x1s.shape[1]
    C = x3s.shape[-1] // S
    out = None
    for s in range(S):
        m = ctr_gc_dynamic_adjacency(
            x1s[:, s], x2s[:, s], w4s[s], b4s[s], alpha, As[s]
        )
        y = ctr_gc_aggregate(m, x3s[..., s * C:(s + 1) * C])
        out = y if out is None else out + y
    return out


def unit_ctr_gc(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """The unit op, dispatched on the device of x3s: a CPU tensor takes the
    plain version, a CUDA tensor launches the CUDA kernel (which raises on
    what it does not take; there is no fallback)."""
    if x3s.device.type == "cpu":
        return unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)
    if x3s.device.type == "cuda":
        from .cuda.ctr_gc import unit_ctr_gc_fwd

        return unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)
    raise NotImplementedError(f"unit_ctr_gc on device {x3s.device}")


def conv3_matmul(x, w3, b3):
    """The packed conv3 1x1 as a matmul: x (N,T,V,Cin) @ w3 (Cin,S*C) + b3."""
    return torch.matmul(x, w3) + b3
