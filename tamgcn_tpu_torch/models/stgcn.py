"""ST-GCN with learnable per-layer edge importance.

Counterpart of tamgcn_tpu/models/stgcn.py (reference models/stgcn.py:
ConvTemporalGraphical :37-63, st_gcn block :66-99, Model :102-252) with the
same parameter names, so convert.from_flax maps the JAX model's variables
onto this one by path (`blocks_3/tcn_conv/kernel` -> `blocks_3.tcn_conv.weight`,
`edge_importance_3` -> `edge_importance_3`). Activations are NTVC; the
spatial graph conv is a 1x1 conv to K partitions and `ops.stgcn_aggregate`
('ntvkc,kvw->ntwc', one torch.einsum); the temporal (9, 1) conv is
`F.conv2d` on the channels_last view, as in models/ctrgcn.py.

Parameters follow PyTorch's defaults (the reference applies no custom init
to ST-GCN): conv and head weights and biases U(+-1/sqrt(fan_in)), drawn from
`generator`; BatchNorm scale 1, bias 0; edge importance ones.

Compute dtype (`dtype`): float32 (None), or bfloat16 with float32
parameters, BatchNorm statistics and logits, as the port's CTR-GCN: each
conv casts its input, weight and bias to bf16 and adds the bias after the
product; the aggregation sums in f32 (a bf16 input with the f32 adjacency);
BatchNorm normalises in bf16 (ops/norm.py).

`dropout` (before the head) and `block_dropout` (in each block, after the
second temporal BN) are seeded dropout sites (ops/dropout.py), as the JAX
model's nn.Dropout. `graph_partition="ring"` aggregates over the joint ring
of the model group that `set_ring` gives (parallel/graph_parallel.py:
ring_aggregate_stgcn, the JAX model's :220-233; parallel/sharded.py:
parallelize calls it); a model built with it raises until it has a group.
Under sequence parallelism (`seq`, parallel/sequence.py) each rank holds
its range of the clip's frames: the (9, 1) temporal convs read their halo
(`window`), the strided residual convs the rank's frames of the stride's
phase (`rows`), the pool is the clip's mean over the group and
`extract_feature` gathers the whole clip's maps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graphs import get_graph
from ..ops import inits
from ..ops.aggregation import stgcn_aggregate
from ..ops.dropout import SeededDropout
from ..ops.norm import BatchNorm
from ..parallel.graph_parallel import ring_aggregate_stgcn
from .ctrgcn import CTRGCN, Conv1x1, TemporalConv2d, _cast_linear, compute_dtype

# (in channels or None for the model's input, out channels, stride, residual)
# per block (reference models/stgcn.py:140-150)
_PLAN = [
    (None, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True), (64, 64, 1, True),
    (64, 128, 2, True), (128, 128, 1, True), (128, 128, 1, True),
    (128, 256, 2, True), (256, 256, 1, True), (256, 256, 1, True),
]


class ConvTemporalGraphical(nn.Module):
    """Spatial graph conv: out = sum_k conv_k(x) @ A_k (reference :37-63), a
    1x1 conv to K * out channels and the partition aggregation (over the
    joint ring of `ring` where it is set)."""

    ring = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = Conv1x1(in_channels, out_channels * kernel_size, dtype=dtype)

    def reset_parameters(self, generator):
        inits.torch_conv_default_(self.conv.weight, generator)
        inits.torch_conv_default_(self.conv.bias, generator, self.conv.weight.shape[1])

    def forward(self, x, A):
        """x (N,T,V,Cin), A (K,V,V) -> (N,T,V,C) in float32 (or wider)."""
        h = self.conv(x)
        n, t, v, kc = h.shape
        h = h.reshape(n, t, v, self.kernel_size, kc // self.kernel_size)
        if self.ring is not None:
            return ring_aggregate_stgcn(h, A, self.ring)
        return stgcn_aggregate(h, A)


class STGCNBlock(nn.Module):
    """One ST-GCN block: GCN, TCN (BN, ReLU, (k,1) conv, BN), residual
    (reference st_gcn :66-99)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple,
                 stride: int = 1, dropout: float = 0.0, residual: bool = True,
                 dtype=None):
        super().__init__()
        if len(kernel_size) != 2 or kernel_size[0] % 2 != 1:
            raise ValueError(f"kernel_size (odd temporal, spatial), got {kernel_size}")
        dt = compute_dtype(dtype)
        self.drop = SeededDropout(dropout)
        self.res_mode = (
            "none" if not residual
            else "identity" if in_channels == out_channels and stride == 1
            else "conv"
        )
        if self.res_mode == "conv":
            self.res_conv = Conv1x1(in_channels, out_channels, stride=stride, dtype=dt)
            self.res_bn = BatchNorm(out_channels, dtype=dt)
        self.gcn = ConvTemporalGraphical(in_channels, out_channels, kernel_size[1],
                                         dtype=dt)
        self.tcn_bn1 = BatchNorm(out_channels, dtype=dt)
        self.tcn_conv = TemporalConv2d(out_channels, out_channels, kernel_size[0],
                                       stride, dtype=dt)
        self.tcn_bn2 = BatchNorm(out_channels, dtype=dt)

    def reset_parameters(self, generator):
        self.gcn.reset_parameters(generator)
        for conv in (self.tcn_conv, getattr(self, "res_conv", None)):
            if conv is not None:
                inits.torch_conv_default_(conv.weight, generator)
                inits.torch_conv_default_(conv.bias, generator,
                                          conv.weight[0].numel())

    def forward(self, x, A):
        h = F.relu(self.tcn_bn1(self.gcn(x, A)))
        h = self.drop(self.tcn_bn2(self.tcn_conv(h)))
        if self.res_mode == "none":
            return F.relu(h)
        res = x if self.res_mode == "identity" else self.res_bn(self.res_conv(x))
        return F.relu(h + res)


class STGCN(nn.Module):
    """ST-GCN model (reference models/stgcn.py:102-252).

    10 blocks 64 -> 128 (stride 2) -> 256 (stride 2), per-layer learnable
    edge-importance masks on the partitioned adjacency, a linear head on the
    pooled features. The reference's data_bn is consistent only for
    num_person == 1 (it declares M*V*C features and is fed V*C, reference
    :138 vs :181); this model, like the JAX one, normalises V*C features per
    (sample, person), the working M == 1 semantics.
    """

    seq = None  # parallel/sequence.py: the time-sharded model's context

    def __init__(self, in_channels: int = 3, num_class: int = 4, num_point: int = 20,
                 num_person: int = 1, graph=None, graph_args=None,
                 edge_importance_weighting: bool = True, dropout: float = 0.0,
                 block_dropout: float = 0.0, dtype=None, graph_partition: str = "none",
                 generator: torch.Generator | None = None):
        super().__init__()
        if graph_partition not in ("none", None, "ring"):
            raise ValueError(f"unknown graph_partition {graph_partition!r}")
        self.graph_partition = graph_partition or "none"
        if graph is None:
            raise ValueError("graph must be specified")
        if isinstance(graph, np.ndarray):
            A = graph
        elif isinstance(graph, str):
            A = get_graph(graph, **(graph_args or {})).A
        else:
            A = graph.A
        self.dtype = dt = compute_dtype(dtype)
        self.num_class = num_class
        self.num_point = num_point
        self.num_person = num_person
        self.drop = SeededDropout(dropout)
        # the adjacency is a constant of the graph, not part of the weights
        self.register_buffer("A", torch.as_tensor(np.asarray(A, np.float32)),
                             persistent=False)
        ks = (9, A.shape[0])
        for i, (cin, cout, stride, residual) in enumerate(_PLAN):
            setattr(self, f"blocks_{i}", STGCNBlock(
                in_channels if cin is None else cin, cout, ks, stride,
                dropout=block_dropout, residual=residual, dtype=dt))
        self.edge_importance_weighting = edge_importance_weighting
        if edge_importance_weighting:
            for i in range(len(_PLAN)):
                self.register_parameter(f"edge_importance_{i}",
                                        nn.Parameter(torch.ones(self.A.shape)))
        self.data_bn = BatchNorm(num_point * in_channels, dtype=dt)
        # head: the reference's 1x1 conv on pooled features, a Linear here
        self.fcn = nn.Linear(256, num_class)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @property
    def blocks(self) -> list[STGCNBlock]:
        return [getattr(self, f"blocks_{i}") for i in range(len(_PLAN))]

    @property
    def edge_importance(self) -> list:
        """Each block's importance mask (parameters), or 1.0 without
        edge-importance weighting."""
        if not self.edge_importance_weighting:
            return [1.0] * len(_PLAN)
        return [getattr(self, f"edge_importance_{i}") for i in range(len(_PLAN))]

    def set_ring(self, group) -> None:
        """Aggregate over the joint ring of `group` (graph_partition="ring");
        the group must divide num_point, as in JAX."""
        if self.num_point % group.size:
            raise ValueError(
                f"num_point={self.num_point} not divisible by the model mesh axis "
                f"({group.size}) for graph_partition='ring'")
        self.graph_partition = "ring"
        for blk in self.blocks:
            blk.gcn.ring = group

    def reset_parameters(self, generator):
        for blk in self.blocks:
            blk.reset_parameters(generator)
        inits.torch_conv_default_(self.fcn.weight, generator)
        inits.torch_conv_default_(self.fcn.bias, generator, self.fcn.in_features)

    # the input layouts CTR-GCN takes: (N,C,T,V,M) or (N,T,V*C)
    _to_ncvtm = CTRGCN._to_ncvtm

    def _stem(self, x):
        """data BN over (V, C) features per (N*M) sample (reference :179-184),
        on the input cast to the compute dtype."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        N, C, T, V, M = x.shape
        h = x.permute(0, 4, 2, 3, 1).reshape(N * M, T, V * C)
        h = self.data_bn(h).reshape(N * M, T, V, C)
        return h, N, M

    def _backbone(self, h):
        if self.graph_partition == "ring" and self.blocks[0].gcn.ring is None:
            raise ValueError("graph_partition='ring' requires a mesh "
                             "(parallel/sharded.py:parallelize)")
        for blk, importance in zip(self.blocks, self.edge_importance):
            layout = self.seq.layout if self.seq is not None else None
            h = blk(h, self.A * importance)
            stride = blk.tcn_conv.stride
            if layout is not None and stride != 1:
                self.seq.layout = layout.strided(stride)
        return h

    def _features(self, x):
        """(the backbone's features (N*M, T', V, 256) of the rank's frames, N,
        M), the layout of its frames started first under sequence
        parallelism."""
        x = self._to_ncvtm(x)
        if self.seq is not None:
            self.seq.start(x.shape[2], x.device)
        h, N, M = self._stem(x)
        return self._backbone(h), N, M

    def _head(self, h):
        if self.dtype is None:
            return self.fcn(h)
        return _cast_linear(h, self.fcn.weight, self.fcn.bias, self.dtype)

    def forward(self, x):
        h, N, M = self._features(x)  # (N*M, T', V, 256)
        if self.seq is None:
            h = h.mean(dim=(1, 2))
        else:  # the mean over the clip's frames on every rank
            h = self.seq.pool_sum(h.sum(dim=1)).mean(dim=1) / self.seq.layout.T
        h = self.drop(h.reshape(N, M, -1).mean(dim=1))
        # logits in float32 (or wider): the loss does not run in bf16
        out = self._head(h)
        return out.to(torch.promote_types(out.dtype, torch.float32))

    def extract_feature(self, x):
        """(output, feature) pre-pool maps, each (N, C', T', V, M) (reference
        models/stgcn.py:200-225): the head applied at every position, and
        the backbone's features (the whole clip's on every rank under
        sequence parallelism)."""
        h, N, M = self._features(x)  # (N*M, T', V, 256)
        if self.seq is not None:
            h = self.seq.gather(h)
        _, t, v, c = h.shape
        feature = h.reshape(N, M, t, v, c).permute(0, 4, 2, 3, 1)
        out = self._head(h)
        output = out.reshape(N, M, t, v, -1).permute(0, 4, 2, 3, 1)
        return output, feature


def edge_importance_per_joint(edge_importance) -> np.ndarray:
    """Per-joint importance from the per-layer edge masks, normalised to max
    1: incoming plus outgoing edge weights per joint, summed over partitions
    and layers (reference models/stgcn.py:227-252, get_edge_importance_per_joint).
    Takes arrays or tensors (K, V, V)."""
    masks = [m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
             for m in edge_importance]
    V = masks[0].shape[1]
    joint_scores = np.zeros(V)
    for imp in masks:
        for k in range(imp.shape[0]):
            joint_scores += imp[k].sum(axis=0)
            joint_scores += imp[k].sum(axis=1)
    return joint_scores / joint_scores.max()


def create_stgcn_nucla(**overrides) -> STGCN:
    """NW-UCLA ST-GCN config (reference tools/train_stgcn_group.py:24-42)."""
    kwargs = dict(
        in_channels=3,
        num_class=10,
        num_point=20,
        num_person=1,
        graph="ucla",
        graph_args={"labeling_mode": "spatial"},
    )
    kwargs.update(overrides)
    return STGCN(**kwargs)
