"""Edge-partitioned graph parallelism: the joint ring over a model group.

Counterpart of tamgcn_tpu/parallel/graph_parallel.py. The aggregation
`out[..., u, c] = sum_v A[u, v] * x[..., v, c]` with the joint (vertex)
axis split over the k ranks of a group: rank m owns the output joints of
block m and the adjacency rows of those joints; the joint blocks of x
travel the ring (`comm.shift`: send to rank + 1, receive from rank - 1), and
at step s rank m aggregates the block that originated on rank (m - s) mod k
against those columns of its rows. k steps see every block; the block is
shifted k - 1 times (the JAX loop's last ppermute brings it home unused).

Every op here takes its tensors replicated over the group, as the JAX
functions take global arrays, and returns its output replicated:
  * x (or x3s) enters by `comm.scatter` (the rank's block; its gradient is
    all-gathered back);
  * the other inputs enter by `comm.copy_to` (`_replicated_inputs`): each
    rank computes a part of their gradients (its rows, its columns, its
    share of the sums), and the backward sums the parts over the group;
  * the output blocks leave by `comm.gather` (all-gathered to every joint;
    the backward takes the rank's own rows).

`ring_unit_ctr_gc` is the CTR-GC unit op ringed: each ring step is a whole
unit op at V = vb over the resident block (the port's
`ops.aggregation.unit_ctr_gc`: on the card K1 forward, K2 and K3 backward,
the JAX kernel body of :203-233), with the local x1 rows, the x2 columns
and the (vb, vb) block of A of the block's source. V is padded with zero
joints to a multiple of k (:288-298): a zero x3 column adds nothing and the
padded output rows are dropped, so NTU's V = 25 rings at k = 2 and 4.
`ring_aggregate_stgcn` is ST-GCN's partition aggregation ringed (its local
step is an einsum, as in JAX; it needs V divisible by k, as JAX's does).
With a group of one rank each op is the dense op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.aggregation import unit_ctr_gc
from . import comm
from .comm import Group


def _blocks(V: int, group: Group) -> int:
    if V % group.size:
        raise ValueError(f"joint axis {V} not divisible by mesh axis {group.size}")
    return V // group.size


def _replicated_inputs(group: Group, *tensors):
    """Replicated tensors entering the ring: each rank computes a part of
    their gradients, summed over the group in the backward."""
    return [comm.copy_to(t, group) for t in tensors]


def _ring(block, group: Group, step):
    """sum over s of step(src, block at step s), the block shifted along the
    ring between steps; src = (rank - s) mod k is where the block began."""
    k, me = group.size, group.rank
    acc = None
    for s in range(k):
        part = step((me - s) % k, block)
        acc = part if acc is None else acc + part
        if s < k - 1:
            block = comm.shift(block, group)
    return acc


def ring_aggregate(x: torch.Tensor, A: torch.Tensor, group: Group) -> torch.Tensor:
    """out[..., u, c] = sum_v A[u, v] x[..., v, c]; x (..., V, C), A (V, V)."""
    if group.size == 1:
        return torch.einsum("uv,...vc->...uc", A, x)
    vb = _blocks(x.shape[-2], group)
    me = group.rank
    (A,) = _replicated_inputs(group, A)
    rows = A[me * vb:(me + 1) * vb]
    acc = _ring(comm.scatter(x, group, -2), group, lambda src, blk: torch.einsum(
        "uv,...vc->...uc", rows[:, src * vb:(src + 1) * vb], blk))
    return comm.gather(acc, group, -2)


def ring_aggregate_stgcn(x: torch.Tensor, A: torch.Tensor, group: Group) -> torch.Tensor:
    """out[n, t, w, c] = sum_{p, v} x[n, t, v, p, c] * A[p, v, w] (the dense
    ops.aggregation.stgcn_aggregate) with the joints ringed; x (N, T, V, K,
    C), A (K, V, V); computed in the wider of x's dtype and float32."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, A.dtype), torch.float32)
    if group.size == 1:
        return torch.einsum("ntvkc,kvw->ntwc", x.to(dtype), A.to(dtype))
    vb = _blocks(x.shape[-3], group)
    me = group.rank
    (A,) = _replicated_inputs(group, A.to(dtype))
    rows = A.transpose(1, 2)[:, me * vb:(me + 1) * vb]  # (K, W/k, V): A^T rows
    acc = _ring(comm.scatter(x.to(dtype), group, -3), group, lambda src, blk: torch.einsum(
        "puv,...vpc->...uc", rows[:, :, src * vb:(src + 1) * vb], blk))
    return comm.gather(acc, group, -2)


def ring_unit_ctr_gc(x1s, x2s, x3s, w4s, b4s, alpha, As, group: Group) -> torch.Tensor:
    """The unit op (ops.aggregation.unit_ctr_gc) with the joints ringed:

        M_s[u,v,c] = (tanh(x1_s[u] - x2_s[v]) @ w4_s + b4_s) * alpha + A_s[u,v]
        out[t,u,c] = sum_s sum_v M_s[u,v,c] * x3_s[t,v,c]

    x1s, x2s (N, S, V, R), x3s (N, T, V, S*C), w4s (S, R, C), b4s (S, C),
    alpha (1,), As (S, V, V). Each rank builds the M rows of its V/k output
    joints from its x1 rows and the x2 columns of the resident block; each
    ring step is the unit op at V = vb. Accumulated in at least float32,
    returned in x3s's dtype."""
    k = group.size
    if k == 1:
        return unit_ctr_gc(x1s, x2s, x3s, w4s, b4s, alpha, As)
    V = x1s.shape[2]
    Vp = -(-V // k) * k
    if Vp != V:
        pad = Vp - V
        x1s = F.pad(x1s, (0, 0, 0, pad))
        x2s = F.pad(x2s, (0, 0, 0, pad))
        x3s = F.pad(x3s, (0, 0, 0, pad))
        As = F.pad(As, (0, pad, 0, pad))
    vb, me = Vp // k, group.rank
    x1s, x2s, w4s, b4s, alpha, As = _replicated_inputs(group, x1s, x2s, w4s, b4s, alpha, As)
    x1l = x1s[:, :, me * vb:(me + 1) * vb].contiguous()
    Al = As[:, me * vb:(me + 1) * vb]
    acc_dtype = torch.promote_types(x3s.dtype, torch.float32)

    def step(src, block):
        cols = slice(src * vb, (src + 1) * vb)
        return unit_ctr_gc(x1l, x2s[:, :, cols].contiguous(), block, w4s, b4s, alpha,
                           Al[:, :, cols].contiguous()).to(acc_dtype)

    acc = _ring(comm.scatter(x3s, group, 2), group, step)
    return comm.gather(acc.to(x3s.dtype), group, 2)[:, :, :V]


def shard_joints(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's joint block of a replicated (..., V, C) tensor."""
    _blocks(x.shape[-2], group)
    return comm.scatter(x, group, -2)
