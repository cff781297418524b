"""Sequence parallelism: the CTR-GCN with its clip's time axis split over
the model group.

The hand-written counterpart of what GSPMD does for the JAX trainer's
--sequence_parallel (trainer.py:487-507, 534-567): each rank of a model
group holds a contiguous range of the clip's frames, and

  * every temporal conv and the max-pool branch take the halo frames they
    need from the ranks that hold them before they run (`window`:
    one `comm.exchange`; frames outside the clip are the conv's zero padding
    or the pool's -inf); a 1x1 conv with a stride takes the rank's frames of
    the stride's phase (`rows`);
  * each output frame of a strided op belongs to the rank that holds its
    centre frame, s * i: a rank holding frames [a, b) makes outputs
    [ceil(a / s), ceil(b / s)), so T = 52 over 2 ranks gives 26 + 26, then
    13 + 13 after l5's stride and 7 + 6 after l8's (`TimeLayout.strided`);
  * the reductions over time span the whole clip: every BatchNorm over the
    world (parallel/sharded.py:parallelize), CTR-GC's mean over T that
    feeds x1 and x2 (`mean`: an all-reduce forward and backward, since each
    rank's frames use the mean), and the final pool (`pool_sum`: the
    all-reduced sum, whose gradient each rank already holds whole).

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


def enable(model, mesh) -> None:
    """Split the model's time axis over the mesh's model group."""
    from ..models.ctrgcn import CTRGCN, Conv1x1, MultiScaleTCN, TemporalConv2d, UnitGCN

    if not isinstance(model, CTRGCN):
        raise NotImplementedError(
            f"--sequence_parallel: the port's time-sharded model is the CTR-GCN, "
            f"not {type(model).__name__}")
    ctx = SequenceContext(mesh.model)
    for m in model.modules():
        if isinstance(m, (CTRGCN, UnitGCN, MultiScaleTCN, TemporalConv2d, Conv1x1)):
            m.seq = ctx


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
