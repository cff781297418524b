"""Sequence parallelism: the skeleton networks with their clip's time axis
split over the model group.

The hand-written counterpart of what GSPMD does for the JAX trainer's
--sequence_parallel (trainer.py:487-507, 534-567), which places every 5-D
or 3-D skeleton input time-sharded and every other input data-sharded
(`_sp_put`): each rank of a model group holds a contiguous range of the
clip's frames of a skeleton network (the CTR-GCN, ST-GCN, the fusion
model's `gcn`), and

  * every temporal conv and the max-pool branch take the halo frames they
    need from the ranks that hold them before they run (`window`:
    one `comm.exchange`; frames outside the clip are the conv's zero padding
    or the pool's -inf); a 1x1 conv with a stride takes the rank's frames of
    the stride's phase (`rows`);
  * each output frame of a strided op belongs to the rank that holds its
    centre frame, s * i: a rank holding frames [a, b) makes outputs
    [ceil(a / s), ceil(b / s)), so T = 52 over 2 ranks gives 26 + 26, then
    13 + 13 after l5's stride and 7 + 6 after l8's (`TimeLayout.strided`);
  * the reductions over time span the whole clip: every BatchNorm of a
    skeleton network over the world (parallel/sharded.py:parallelize),
    CTR-GC's mean over T that feeds x1 and x2 (`mean`: an all-reduce
    forward and backward, since each rank's frames use the mean), and the
    final pool (`pool_sum`: the all-reduced sum, whose gradient each rank
    already holds whole);
  * `extract_feature` returns the whole clip's features, as the JAX global
    array is (`gather`: the ranks' frames, uneven after the strides,
    concatenated on every rank; the gradient of the replicated features is
    the rank's own frames').

What sees the whole batch slice on every rank of the model group (the
head, the RGB trunk and the fusion's attention MLP and classifier: inputs
JAX places on the data axis only) is computed whole on each rank: its
BatchNorms take the data group's statistics and its gradients, which each
rank holds whole, are averaged over the model group, where the parameters
of the time-sharded part hold each rank's share and are summed
(`model.time_sharded` names them; parallel/sharded.py).

The layout of a forward's input comes from the ranks' frame counts (one
all-reduce); each block's input layout is set on the context before the
block runs, and its strided ops derive their output layout from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import comm


@dataclass(frozen=True)
class TimeLayout:
    """Rank r of the group holds frames [starts[r], starts[r + 1]) of T."""

    starts: tuple

    @property
    def T(self) -> int:
        return self.starts[-1]

    def strided(self, s: int) -> "TimeLayout":
        return TimeLayout(tuple(-(-a // s) for a in self.starts))


class SequenceContext:
    """The model group the frames are split over and the layout of the
    block that runs now."""

    def __init__(self, group: comm.Group):
        self.group = group
        self.layout: TimeLayout | None = None
        self._plans = {}

    def start(self, t_local: int, device) -> TimeLayout:
        """The layout of a forward's input, from each rank's frame count."""
        k, r = self.group.size, self.group.rank
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        counts[r] = t_local
        counts = comm.all_reduce_(counts, self.group).tolist()
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        self.layout = TimeLayout(tuple(starts))
        return self.layout

    def own(self) -> tuple:
        r = self.group.rank
        return self.layout.starts[r], self.layout.starts[r + 1]

    def window(self, x: torch.Tensor, stride: int, span: int, pad: int, fill: float):
        """The frames (axis 1 of NTVC) the rank's outputs of a window op of
        `span` frames (dilation * (kernel - 1) + 1), `stride` and `pad` read:
        a tensor of s * (n_out - 1) + span frames, the halo from the ranks
        that hold it, `fill` outside the clip."""
        key = (self.layout, stride, span, pad)
        plan = self._plans.get(key)
        if plan is None:
            windows = []
            for a, b in zip(self.layout.starts[:-1], self.layout.starts[1:]):
                i0, i1 = -(-a // stride), -(-b // stride)
                windows.append((stride * i0 - pad, stride * (i1 - 1) - pad + span)
                               if i1 > i0 else (0, 0))
            plan = self._plans[key] = comm.window_plan(self.layout.starts, windows)
        return comm.exchange(x, self.group, plan, dim=1, fill=fill)

    def rows(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        """The rank's frames at multiples of `stride` (a strided 1x1 conv)."""
        a, _ = self.own()
        return x[:, (-a) % stride::stride]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the clip's frames (axis 1)."""
        return comm.all_reduce(x.sum(dim=1), self.group) / self.layout.T

    def pool_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group (the pooled features, replicated after)."""
        return comm.reduce_from(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole clip's frames (axis 1) on every rank, in frame order;
        the gradient of the result (one replicated value) is the rank's own
        frames' part of it."""
        key = ("gather", self.layout)
        plan = self._plans.get(key)
        if plan is None:
            k, T = self.group.size, self.layout.T
            plan = self._plans[key] = comm.window_plan(self.layout.starts, [(0, T)] * k)
        return _Gathered.apply(x, self.group, plan, self.own())


class _Gathered(torch.autograd.Function):
    """SequenceContext.gather: the exchange of every rank's frames to every
    rank forward, the own frames' slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, plan, own):
        ctx.own = own
        return comm.exchange(x, group, plan, dim=1)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.own
        return g[:, a:b], None, None, None


def _skeleton_nets(model):
    """(name, network, its head's name) of the networks in `model` whose
    frames are split: the model itself where it is a CTR-GCN or an ST-GCN,
    or its submodules that are (the head runs on the pooled features)."""
    from ..models.ctrgcn import CTRGCN
    from ..models.stgcn import STGCN

    return [(name, net, "fc" if isinstance(net, CTRGCN) else "fcn")
            for name, net in model.named_modules() if isinstance(net, (CTRGCN, STGCN))]


def enable(model, mesh) -> None:
    """Split the time axis of the model's skeleton networks over the mesh's
    model group, and record in `model.time_sharded` the names of the
    parameters and BatchNorms (state-dict and module names) that see the
    time-sharded frames: each network's, but its head's. A model with no
    skeleton network (the RGB ResNet) computes whole on every rank."""
    from ..models.ctrgcn import Conv1x1, MultiScaleTCN, TemporalConv2d, UnitGCN
    from ..ops.norm import BatchNorm

    ctx = SequenceContext(mesh.model)
    sharded = set()
    for name, net, head in _skeleton_nets(model):
        for m in net.modules():
            if m is net or isinstance(m, (UnitGCN, MultiScaleTCN, TemporalConv2d, Conv1x1)):
                m.seq = ctx
        inside = [n for n, m in net.named_modules() if isinstance(m, BatchNorm)]
        inside += [n for n, _ in net.named_parameters()]
        sharded |= {f"{name}.{n}" if name else n for n in inside
                    if n != head and not n.startswith(head + ".")}
    model.time_sharded = frozenset(sharded)


def shard_time(x, mesh):
    """The rank's frames of a global clip batch: (N, C, T, V, M) or the
    flat (N, T, V*C) layout, T split evenly over the model group (the JAX
    trainer's _sp_put raises where the group does not divide T)."""
    k = mesh.model.size
    axis = 2 if x.ndim == 5 else 1
    T = x.shape[axis]
    if T % k:
        raise ValueError(
            f"--sequence_parallel: time axis T={T} is not divisible by the 'model' mesh "
            f"axis ({k}); pick a model_parallel that divides T or pad the clips.")
    per = T // k
    r = mesh.model.rank
    index = [slice(None)] * x.ndim
    index[axis] = slice(r * per, (r + 1) * per)
    return x[tuple(index)]
