"""Collectives over a group of ranks, and their autograd Functions.

The port's counterpart of what GSPMD and shard_map insert for the JAX
package: every exchange of the parallel layer is one of these. A `Group` is
a set of ranks of the world (one process each) with its process group; a
group of one rank needs no process group and every op here is then the
identity.

The backend picks how an exchange moves a tensor, never a `try`:
  * NCCL: every op on the tensor where it lies;
  * gloo: `all_reduce` on the tensor where it lies (gloo reduces CUDA
    tensors); the all-gather and the point-to-point sends and receives are
    staged through host memory inside the exchange (gloo has them for CPU
    tensors only). A CPU tensor is its own staging copy.

The autograd Functions follow the tensor-parallel conventions: a tensor
replicated over the group stands for one value, and its gradient on every
rank is that value's whole gradient.
  * `copy_to`: identity forward, all-reduce backward (a replicated tensor
    entering computations that differ by rank);
  * `reduce_from`: all-reduce forward, identity backward (partial results
    summed into a replicated tensor);
  * `all_reduce`: all-reduce forward and backward (a sum whose every rank
    goes on to different computations);
  * `gather`: all-gather along a dim forward, the rank's own slice backward;
  * `scatter`: the rank's own slice forward, all-gather backward;
  * `shift`: the ring's step, send to rank + 1 and receive from rank - 1,
    whose backward shifts the other way (the transpose of `ppermute`);
  * `exchange`: any set of point-to-point pieces (the sequence-parallel
    halos), whose backward sends each piece's gradient back to its source.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """Ranks `ranks` (global ranks, in group order) with their process
    group `pg` (None for one rank), the `backend` ("nccl" or "gloo"), and
    this process's position `rank` in the group."""

    ranks: tuple
    rank: int
    pg: object = None
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return len(self.ranks)

    def staged(self, t: torch.Tensor) -> bool:
        """Whether an all-gather or a send of `t` goes through host memory."""
        return self.backend == "gloo" and t.device.type != "cpu"


SOLO = Group(ranks=(0,), rank=0)


def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum `t` over the group in place (t must be contiguous)."""
    if group.size > 1:
        dist.all_reduce(t, group=group.pg)
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (all of `t`'s shape) concatenated along `dim` in
    group order."""
    if group.size == 1:
        return t
    t = t.contiguous()
    if group.backend == "nccl":
        out = torch.empty((group.size * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group.pg)
        parts = out.chunk(group.size)
    else:
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(group.size)]
        dist.all_gather(parts, host, group=group.pg)
        parts = [p.to(t.device) for p in parts]
    return torch.cat(list(parts), dim=dim)


def all_gather_objects(obj, group: Group) -> list:
    """Each rank's picklable `obj`, in group order."""
    if group.size == 1:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def send_recv(sends: dict, recvs: dict, group: Group, like: torch.Tensor) -> dict:
    """Point-to-point pieces in one batch: `sends` {group rank: tensor},
    `recvs` {group rank: shape}; returns {group rank: received tensor} with
    `like`'s dtype and device. A rank may send to and receive from the same
    peer."""
    if not sends and not recvs:
        return {}
    stage = group.staged(like)
    out = {}
    ops = []
    for peer, shape in sorted(recvs.items()):
        buf = torch.empty(shape, dtype=like.dtype, device="cpu" if stage else like.device)
        out[peer] = buf
        ops.append(dist.P2POp(dist.irecv, buf, group.ranks[peer], group.pg))
    for peer, t in sorted(sends.items()):
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, group.ranks[peer],
                              group.pg))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {p: b.to(like.device) for p, b in out.items()} if stage else out


# -- autograd Functions --------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size, dim=ctx.dim)[ctx.group.rank].contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(group.size, dim=dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def _shift(x, group, step):
    k = group.size
    dst, src = (group.rank + step) % k, (group.rank - step) % k
    return send_recv({dst: x}, {src: x.shape}, group, x)[src]


class _Exchange(torch.autograd.Function):
    """forward(x, plan): plan.pieces are (src, dst, lo, hi, at) in `dim` of
    the source's tensor, written at offset `at` of the destination's output
    of length plan.out_len[dst]; pieces with src == dst are local copies;
    the rest of the output is `fill`."""

    @staticmethod
    def forward(ctx, x, group, plan, dim, fill):
        ctx.group, ctx.plan, ctx.dim, ctx.in_len = group, plan, dim, x.shape[dim]
        me = group.rank
        xs = x.movedim(dim, 0)
        sends = {d: xs[lo:hi] for s, d, lo, hi, _ in plan.pieces if s == me and d != me}
        recvs = {s: (hi - lo,) + xs.shape[1:] for s, d, lo, hi, _ in plan.pieces
                 if d == me and s != me}
        got = send_recv(sends, recvs, group, x)
        out = xs.new_full((plan.out_len[me],) + xs.shape[1:], fill)
        for s, d, lo, hi, at in plan.pieces:
            if d == me:
                out[at:at + hi - lo] = xs[lo:hi] if s == me else got[s]
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        group, plan, me = ctx.group, ctx.plan, ctx.group.rank
        gs = g.movedim(ctx.dim, 0)
        sends = {s: gs[at:at + hi - lo] for s, d, lo, hi, at in plan.pieces
                 if d == me and s != me}
        recvs = {d: (hi - lo,) + gs.shape[1:] for s, d, lo, hi, _ in plan.pieces
                 if s == me and d != me}
        got = send_recv(sends, recvs, group, g)
        dx = gs.new_zeros((ctx.in_len,) + gs.shape[1:])
        for s, d, lo, hi, at in plan.pieces:
            if s == me:
                dx[lo:hi] += gs[at:at + hi - lo] if d == me else got[d]
        return dx.movedim(0, ctx.dim), None, None, None, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _AllReduce.apply(x, group)


def gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return x if group.size == 1 else _Gather.apply(x, group, dim % x.ndim)


def scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return x if group.size == 1 else _Scatter.apply(x, group, dim % x.ndim)


def shift(x: torch.Tensor, group: Group, step: int = 1) -> torch.Tensor:
    return x if group.size == 1 else _Shift.apply(x, group, step)


def exchange(x: torch.Tensor, group: Group, plan, dim: int, fill: float = 0.0):
    return _Exchange.apply(x, group, plan, dim % x.ndim, fill)


@dataclass(frozen=True)
class Plan:
    """The pieces of an `exchange` and each rank's output length."""

    pieces: tuple
    out_len: tuple


def window_plan(starts: Sequence[int], windows: Sequence[tuple]) -> Plan:
    """The exchange that gives rank r the frames [lo_r, hi_r) of a tensor
    split over the group in contiguous ranges (rank q holds [starts[q],
    starts[q + 1])); frames outside [0, starts[-1]) are the fill value."""
    pieces = []
    for d, (lo, hi) in enumerate(windows):
        for q in range(len(starts) - 1):
            a, b = max(lo, starts[q]), min(hi, starts[q + 1])
            if a < b:
                pieces.append((q, d, a - starts[q], b - starts[q], a - lo))
    return Plan(tuple(pieces), tuple(max(0, hi - lo) for lo, hi in windows))
