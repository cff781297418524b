"""The stage-2 aggregation from a given M: plain versions and the dispatcher of T2.

Counterpart of the Pallas probes in tools/exp_stage2.py and
tools/exp_stage2b.py, which time K1's stage 2 alone, with M (V, V, L)
shared by the whole batch and x3 (N, T, V, L):

    out[n,t,u,l] = sum_j M[j,u,l] * x3[n,t,v(j,u),l]

with the index rule of the form:
  tile   v = j: M laid out (v, u, l)           (`_tile_kernel`, both tools)
  win    v = (u + j) mod V: M holds diagonals  (`_win_kernel`)
  floor  v = u: x3's joint pinned to u         (`_floor_kernel`)
  flat   win on M (V, V*L) and x3 (N, T, V*L)  (`_flat_kernel`)
and, with the subset sum, the S subsets of L = S*C summed:
out[n,t,u,c] = sum_s acc[n,t,u,s*C+c]. bf16 operands are accumulated in f32
and rounded once to the operand type, in the plain versions and in the
kernel alike (the Pallas bodies multiply and add in the operand type).

`stage2_aggregate` runs a form: the plain version for CPU tensors, the CUDA
kernel T2 (ops/cuda/stage2.py) for CUDA tensors, with no fallback.
ops/aggregation.py:ctr_gc_aggregate stays plain: the plain versions of
K1-K6 are built on it.
"""
from __future__ import annotations

import torch

FORMS = ("tile", "win", "floor", "flat")
# the kernel's index rule of each form (flat is win on flattened views)
RULES = {"tile": "tile", "win": "diag", "floor": "floor", "flat": "diag"}


def diag_to_vu(m_diag):
    """M of the diagonal forms (j, u, l), v = (u + j) mod V, laid out as the
    tile form's (v, u, l): m_vu[v, u] = m_diag[(v - u) mod V, u]."""
    V = m_diag.shape[0]
    ar = torch.arange(V, device=m_diag.device)
    return m_diag[(ar[:, None] - ar[None, :]) % V, ar[None, :]]


def _aggregate_f32(m, x3, rule: str, S: int):
    """The rule's sum in f32 (S > 1: the subsets summed too), not rounded."""
    m, x3 = m.float(), x3.float()
    if rule == "floor":
        out = torch.einsum("jul,ntul->ntul", m, x3)
    else:
        out = torch.einsum("vul,ntvl->ntul", diag_to_vu(m) if rule == "diag" else m, x3)
    if S > 1:
        N, T, V, L = out.shape
        out = out.reshape(N, T, V, S, L // S).sum(3)
    return out


def stage2_dims(m, x3, form: str, S: int, subset_sum: bool):
    """A form's operands as (V,V,L) and (N,T,V,L) views (the flat form's are
    flattened) with their sizes: (m, x3, N, T, V, L); raises on a mismatch."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    if form == "flat":
        if m.ndim != 2 or x3.ndim != 3 or m.shape[1] % m.shape[0] or x3.shape[2] != m.shape[1]:
            raise ValueError(f"the flat form takes M (V, V*L) and x3 (N, T, V*L), got "
                             f"{tuple(m.shape)} and {tuple(x3.shape)}")
        V = m.shape[0]
        m = m.reshape(V, V, m.shape[1] // V)
        x3 = x3.reshape(x3.shape[0], x3.shape[1], V, -1)
    if m.ndim != 3 or x3.ndim != 4:
        raise ValueError(f"M must be (V, V, L) and x3 (N, T, V, L), got "
                         f"{tuple(m.shape)} and {tuple(x3.shape)}")
    N, T, V, L = x3.shape
    if tuple(m.shape) != (V, V, L):
        raise ValueError(f"M has shape {tuple(m.shape)}, expected {(V, V, L)}")
    if m.dtype != x3.dtype:
        raise TypeError(f"M is {m.dtype} and x3 {x3.dtype}; they must match")
    if subset_sum and (S < 1 or L % S):
        raise ValueError(f"the subset sum needs L % S == 0, got L={L}, S={S}")
    return m, x3, N, T, V, L


def stage2_plain(m, x3, form: str, S: int = 3, subset_sum: bool = False):
    """The plain version of a form, on the tensors' own device; operands and
    output as stage2_aggregate's: tile m (V(v), V(u), L); win and floor m
    (V(j), V(u), L); flat m (V, V*L) with [j, u*L + l] and x3 (N, T, V*L)."""
    mv, xv, N, T, _, _ = stage2_dims(m, x3, form, S, subset_sum)
    out = _aggregate_f32(mv, xv, RULES[form], S if subset_sum else 1).to(x3.dtype)
    return out.reshape(N, T, -1) if form == "flat" else out


def stage2_aggregate(m, x3, form: str, S: int = 3, subset_sum: bool = False):
    """T2 on the device of x3: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (which raises on what it does not take; there
    is no fallback). m and x3 as the form takes them; the output is (N, T,
    V, L), or (N, T, V, L/S) with the subset sum, flattened to (N, T, -1) for
    the flat form."""
    if x3.device.type == "cpu":
        return stage2_plain(m, x3, form, S, subset_sum)
    if x3.device.type != "cuda":
        raise NotImplementedError(f"stage2_aggregate on device {x3.device}")
    from .cuda.stage2 import stage2_aggregate_fwd

    mv, xv, N, T, _, _ = stage2_dims(m, x3, form, S, subset_sum)
    out = stage2_aggregate_fwd(mv, xv, RULES[form], S if subset_sum else 1)
    return out.reshape(N, T, -1) if form == "flat" else out
