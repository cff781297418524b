"""TAM/CTR-GCN — channel-wise topology-refined GCN with the TAM offset branch.

Counterpart of tamgcn_tpu/models/ctrgcn.py with the same packed structure
and the same parameter names (so tamgcn_tpu_torch/convert.py maps one onto
the other by path): activations are NTVC (batch, time, vertex, channel);
1x1 convs are matmuls on the last axis; the temporal (k, 1) convs run as
`F.conv2d` on the `.permute(0, 3, 1, 2)` view, an NCHW tensor in
channels_last memory format; conv3 and the three CTR-GC subsets run as one
op (ops.aggregation.unit_ctr_gc_conv3), the CUDA kernels on the card.

Reference: CTRGC :150-177, unit_gcn :196-263 incl. the TAM offset branch
:219-223 and :256-259, MultiScale_TemporalConv :72-147, unit_tcn :179-193,
TCN_GCN_unit :266-284, Model :287-374.

Compute dtype (`dtype`: None or "float32", or "bfloat16"), the JAX model's
mixed precision (tamgcn_tpu/models/ctrgcn.py `dtype`): the parameters, the
BatchNorm statistics and the logits stay float32. In bfloat16 the stem
casts the input, and every conv, as a Flax `nn.Conv(dtype=bfloat16)`, casts
its input, weight and bias to bf16, rounds its product to bf16 and then adds
the bias in bf16; BatchNorm normalises in bf16 arithmetic (ops/norm.py); the
unit op takes bf16 activations with its float32 parameters (K1-K3's bf16
forms on the card); the head's logits are widened to float32. The casts of
the weights are part of the graph, so the optimizer gets float32 gradients.

Parallelism (parallel/sharded.py:parallelize wires a built model to a grid
of ranks): `graph_partition="ring"` runs each UnitGCN's conv3 unfused and
its unit op as the joint ring over the model group
(parallel/graph_parallel.py:ring_unit_ctr_gc, as the JAX UnitGCN does at
:190-199); a model built with it raises until it has a group. Under
sequence parallelism the modules' `seq` context (parallel/sequence.py)
splits the time axis over the model group: the temporal convs and the
max-pool take their halo frames, CTR-GC's mean over T and the final pool
span the clip.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graphs import get_graph
from ..ops import inits
from ..ops.aggregation import conv3_matmul, ctr_gc_fused, unit_ctr_gc_conv3
from ..parallel.graph_parallel import ring_unit_ctr_gc
from ..ops.dropout import SeededDropout
from ..ops.norm import BatchNorm
from ..parallel.sharded import linear


def _rel_channels(in_channels: int, rel_reduction: int = 8) -> int:
    """Reference models/ctrgcn.py:155-158."""
    return 8 if in_channels in (3, 9) else in_channels // rel_reduction


def _default_generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def compute_dtype(dtype) -> torch.dtype | None:
    """None for float32 compute (None, "float32", torch.float32),
    torch.bfloat16 for "bfloat16" or torch.bfloat16; raises on anything else."""
    if dtype in (None, "float32", torch.float32):
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise NotImplementedError(
        f"compute dtype {dtype!r}: the model computes in float32 or bfloat16")


def _cast_linear(x, weight, bias, dtype):
    """A Flax Dense/1x1 Conv with a compute dtype: input, weight and bias
    cast to `dtype`, the product rounded to it, then the bias added."""
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


class Conv1x1(nn.Module):
    """1x1 conv on NTVC: x (..., Cin) @ weight (Cout, Cin)^T + bias, with an
    optional temporal stride (axis 1). `blocks` > 1 marks a packed conv of
    `blocks` independent convs for the init. `dtype` is the compute dtype
    (compute_dtype)."""

    seq = None  # parallel/sequence.py: the time-sharded model's context

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 blocks: int = 1, dtype=None):
        super().__init__()
        self.stride = stride
        self.blocks = blocks
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator, zero: bool = False):
        if zero:
            nn.init.zeros_(self.weight)
        else:
            inits.kaiming_normal_fan_out_blocked_(self.weight, self.blocks, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.stride != 1:
            x = x[:, ::self.stride] if self.seq is None else self.seq.rows(x, self.stride)
        if self.dtype is not None:
            return _cast_linear(x, self.weight, self.bias, self.dtype)
        return F.linear(x, self.weight, self.bias)


class TemporalConv2d(nn.Module):
    """(k, 1) temporal conv on NTVC with stride and dilation, 'same' padding
    as the reference: conv2d on the channels_last NCHW view. Under sequence
    parallelism (`seq`) it runs unpadded on the rank's frames and their
    halo (parallel/sequence.py:SequenceContext.window)."""

    seq = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, dtype=None):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.dtype = compute_dtype(dtype)
        self.pad = (kernel_size + (kernel_size - 1) * (dilation - 1) - 1) // 2
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, 1)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator):
        inits.kaiming_normal_fan_out_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def _conv(self, x, weight, bias):
        pad = self.pad
        if self.seq is not None:
            span = self.dilation * (self.kernel_size - 1) + 1
            x, pad = self.seq.window(x, self.stride, span, self.pad, 0.0), 0
            if x.shape[1] == 0:  # a rank that holds no output frame
                return x.new_zeros(x.shape[:3] + (weight.shape[0],)) + 0 * weight.sum()
        y = F.conv2d(
            x.permute(0, 3, 1, 2), weight, bias,
            stride=(self.stride, 1), padding=(pad, 0),
            dilation=(self.dilation, 1),
        )
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        dt = self.dtype
        if dt is None:
            return self._conv(x, self.weight, self.bias)
        # as a Flax nn.Conv with a compute dtype: the product rounded, then
        # the bias added
        return self._conv(x.to(dt), self.weight.to(dt), None) + self.bias.to(dt)


class CTRGC(nn.Module):
    """Channel-wise topology refinement unit, the standalone single-subset
    form (reference models/ctrgcn.py:150-177; counterpart of the JAX
    package's `CTRGC`, models/ctrgcn.py:78-117). conv1/conv2/conv3 are 1x1
    convs with bias; x1 and x2 are conv-then-T-mean as in the JAX module;
    conv4_kernel keeps the Flax layout (1, 1, R, C). The refinement and
    aggregation run through ops.aggregation.ctr_gc_fused (K1 and K2 at S = 1
    on the card in f32). `dtype` is the compute dtype (compute_dtype): in
    bfloat16 the three convs compute in bf16 (x1, x2 and x3 bf16, the mean
    over T in bf16), the parameters stay float32 and the op is K4's bf16
    form, whose output is float32, as the JAX module's. `UnitGCN` runs the
    three subsets through the packed unit op instead."""

    def __init__(self, in_channels: int, out_channels: int,
                 rel_reduction: int = 8, generator: torch.Generator | None = None,
                 dtype=None):
        super().__init__()
        dt = compute_dtype(dtype)
        R = _rel_channels(in_channels, rel_reduction)
        self.conv1 = Conv1x1(in_channels, R, dtype=dt)
        self.conv2 = Conv1x1(in_channels, R, dtype=dt)
        self.conv3 = Conv1x1(in_channels, out_channels, dtype=dt)
        self.conv4_kernel = nn.Parameter(torch.empty(1, 1, R, out_channels))
        self.conv4_bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters(generator or _default_generator())

    def reset_parameters(self, generator):
        for conv in (self.conv1, self.conv2, self.conv3):
            conv.reset_parameters(generator)
        inits.kaiming_normal_fan_out_dense_(self.conv4_kernel, generator)
        nn.init.zeros_(self.conv4_bias)

    def forward(self, x, A, alpha):
        """x (N,T,V,Cin); A (V,V); alpha (1,) -> (N,T,V,C) float32 (or the
        dtype of x in f32 compute)."""
        x1 = self.conv1(x).mean(dim=1)  # (N, V, R)
        x2 = self.conv2(x).mean(dim=1)
        x3 = self.conv3(x)  # (N, T, V, C)
        return ctr_gc_fused(x1, x2, x3, self.conv4_kernel[0, 0], self.conv4_bias,
                            alpha, A)


class UnitGCN(nn.Module):
    """3-subset CTR-GC layer with adaptive adjacency and the TAM offset branch
    (reference models/ctrgcn.py:196-263). `graph_partition="ring"` runs the
    unit op as the joint ring over the group `ring` (set by
    parallel/sharded.py:parallelize)."""

    seq = None
    ring = None

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 adaptive: bool = True, residual: bool = True, dtype=None,
                 graph_partition: str = "none"):
        super().__init__()
        if graph_partition not in ("none", None, "ring"):
            raise ValueError(f"unknown graph_partition {graph_partition!r}")
        self.graph_partition = graph_partition or "none"
        self.dtype = dt = compute_dtype(dtype)
        A0 = torch.as_tensor(np.asarray(A, np.float32))
        self.num_subset = S = A0.shape[0]
        self.in_channels = in_channels
        self.out_channels = C = out_channels
        self.R = R = _rel_channels(in_channels)
        self.residual = residual
        self.adaptive = adaptive
        if adaptive:
            self.PA = nn.Parameter(A0.clone())
        else:
            self.register_buffer("PA", A0.clone())
        self.alpha = nn.Parameter(torch.zeros(1))
        # the subsets' 1x1 convs are PACKED, as in the JAX model: conv12 holds
        # conv1 and conv2 of all subsets, conv3 the three conv3s
        self.conv12 = Conv1x1(in_channels, 2 * S * R, blocks=2 * S, dtype=dt)
        self.conv3 = Conv1x1(in_channels, S * C, blocks=S, dtype=dt)
        self.conv4_kernel = nn.Parameter(torch.empty(S, R, C))
        self.conv4_bias = nn.Parameter(torch.zeros(S, C))
        self.bn = BatchNorm(C, dtype=dt)
        if residual and in_channels != out_channels:
            self.down_conv = Conv1x1(in_channels, C, dtype=dt)
            self.down_bn = BatchNorm(C, dtype=dt)
        self.offset_conv = Conv1x1(C, C, dtype=dt)
        self.offset_bn = BatchNorm(C, dtype=dt)

    def reset_parameters(self, generator):
        self.conv12.reset_parameters(generator)
        self.conv3.reset_parameters(generator)
        inits.kaiming_normal_fan_out_dense_(self.conv4_kernel, generator)
        # bn_init(self.bn, 1e-6): near-zero scale at init (reference :240)
        nn.init.constant_(self.bn.weight, 1e-6)
        if hasattr(self, "down_conv"):
            self.down_conv.reset_parameters(generator)
        # TAM offset branch: zero conv, a no-op at init
        self.offset_conv.reset_parameters(generator, zero=True)

    def forward(self, x):
        N, T, V, _ = x.shape
        S, R = self.num_subset, self.R
        # conv12 commutes with the T pool (a 1x1 conv is linear), so pooling
        # first does T x less work; same math as conv-then-mean
        xm = x.mean(dim=1) if self.seq is None else self.seq.mean(x)
        e12 = self.conv12(xm)  # (N, V, 2*S*R)
        x1s = e12[..., : S * R].reshape(N, V, S, R).permute(0, 2, 1, 3).contiguous()
        x2s = e12[..., S * R:].reshape(N, V, S, R).permute(0, 2, 1, 3).contiguous()
        # conv3 and the unit op: the unfused conv3_matmul + unit_ctr_gc, or
        # with TAMGCN_FUSE_CONV3=1 at C >= 128 the op whose backward is K6;
        # conv3 in the compute dtype, the unit op's parameters float32
        w3, b3 = self.conv3.weight.t(), self.conv3.bias
        if self.dtype is not None:
            x, w3, b3 = x.to(self.dtype), w3.to(self.dtype), b3.to(self.dtype)
        if self.graph_partition == "ring":
            if self.ring is None:
                raise ValueError("graph_partition='ring' requires a mesh "
                                 "(parallel/sharded.py:parallelize)")
            y = ring_unit_ctr_gc(x1s, x2s, conv3_matmul(x, w3, b3), self.conv4_kernel,
                                 self.conv4_bias, self.alpha, self.PA, self.ring)
        else:
            y = unit_ctr_gc_conv3(
                x, w3, b3, x1s, x2s,
                self.conv4_kernel, self.conv4_bias, self.alpha, self.PA,
            )
        y = self.bn(y)
        if not self.residual:
            res = 0.0
        elif hasattr(self, "down_conv"):
            res = self.down_bn(self.down_conv(x))
        else:
            res = x
        offset = torch.tanh(self.offset_bn(self.offset_conv(res - y)))
        return F.relu(y + offset + res)


class TemporalConv(nn.Module):
    """k x 1 dilated temporal conv + BN (reference models/ctrgcn.py:52-69)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, bn_weights_init: bool = False,
                 dtype=None):
        super().__init__()
        self.bn_weights_init = bn_weights_init
        self.conv = TemporalConv2d(in_channels, out_channels, kernel_size,
                                   stride, dilation, dtype=dtype)
        self.bn = BatchNorm(out_channels, dtype=compute_dtype(dtype))

    def reset_parameters(self, generator):
        self.conv.reset_parameters(generator)
        if self.bn_weights_init:
            inits.bn_weights_init_(self.bn.weight, generator)

    def forward(self, x):
        return self.bn(self.conv(x))


class MultiScaleTCN(nn.Module):
    """Multi-branch temporal conv (reference models/ctrgcn.py:72-147).

    The dilated and maxpool branches' entry 1x1+BN+ReLU run PACKED as one
    `prefix_conv`, and all branches' output BNs as one `out_bn`, as in the
    JAX model.
    """

    seq = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride: int = 1, dilations: Sequence[int] = (1, 2, 3, 4),
                 residual: bool = True, residual_kernel_size: int = 1, dtype=None):
        super().__init__()
        dt = compute_dtype(dtype)
        num_branches = len(dilations) + 2
        if out_channels % num_branches:
            raise ValueError("# out channels should be multiples of # branches")
        bc = self.branch_channels = out_channels // num_branches
        if isinstance(kernel_size, (list, tuple)):
            if len(kernel_size) != len(dilations):
                raise ValueError("kernel_size list must match dilations")
            kernel_sizes = list(kernel_size)
        else:
            kernel_sizes = [kernel_size] * len(dilations)
        self.n_dil = n_dil = len(dilations)
        self.stride = stride
        self.prefix_conv = Conv1x1(in_channels, (n_dil + 1) * bc, blocks=n_dil + 1,
                                   dtype=dt)
        self.prefix_bn = BatchNorm((n_dil + 1) * bc, dtype=dt)
        for i, (ks, dilation) in enumerate(zip(kernel_sizes, dilations)):
            setattr(self, f"branch{i}_tconv_conv",
                    TemporalConv2d(bc, bc, ks, stride, dilation, dtype=dt))
        self.pw_conv = Conv1x1(in_channels, bc, stride=stride, dtype=dt)
        self.out_bn = BatchNorm(out_channels, dtype=dt)
        self.res_mode = (
            "none" if not residual
            else "identity" if in_channels == out_channels and stride == 1
            else "conv"
        )
        if self.res_mode == "conv":
            self.residual = TemporalConv(in_channels, out_channels,
                                         residual_kernel_size, stride=stride,
                                         bn_weights_init=True, dtype=dt)

    def reset_parameters(self, generator):
        self.prefix_conv.reset_parameters(generator)
        inits.bn_weights_init_(self.prefix_bn.weight, generator)
        for i in range(self.n_dil):
            getattr(self, f"branch{i}_tconv_conv").reset_parameters(generator)
        inits.kaiming_normal_fan_out_(self.pw_conv.weight, generator)
        inits.bn_weights_init_(self.out_bn.weight, generator)
        if self.res_mode == "conv":
            self.residual.reset_parameters(generator)

    def forward(self, x):
        bc = self.branch_channels
        prefix = F.relu(self.prefix_bn(self.prefix_conv(x)))
        outs = [
            getattr(self, f"branch{i}_tconv_conv")(prefix[..., i * bc:(i + 1) * bc])
            for i in range(self.n_dil)
        ]
        # maxpool branch (reference :113-119)
        pool_in, pad = prefix[..., self.n_dil * bc:], 1
        if self.seq is not None:
            pool_in, pad = self.seq.window(pool_in, self.stride, 3, 1, float("-inf")), 0
        pooled = F.max_pool2d(
            pool_in.permute(0, 3, 1, 2),
            kernel_size=(3, 1), stride=(self.stride, 1), padding=(pad, 0),
        )
        outs.append(pooled.permute(0, 2, 3, 1))
        # plain strided 1x1 branch (reference :121-124)
        outs.append(self.pw_conv(x))
        out = self.out_bn(torch.cat(outs, dim=-1))
        if self.res_mode == "none":
            return out
        if self.res_mode == "identity":
            return out + x
        return out + self.residual(x)


class UnitTCN(nn.Module):
    """k x 1 temporal conv + BN residual unit (reference models/ctrgcn.py:179-193)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 stride: int = 1, dtype=None):
        super().__init__()
        self.conv = TemporalConv2d(in_channels, out_channels, kernel_size, stride,
                                   dtype=dtype)
        self.bn = BatchNorm(out_channels, dtype=compute_dtype(dtype))

    def reset_parameters(self, generator):
        self.conv.reset_parameters(generator)

    def forward(self, x):
        return self.bn(self.conv(x))


class TCNGCNUnit(nn.Module):
    """One GCN+TCN block: relu(tcn(gcn(x)) + residual(x)) (reference
    models/ctrgcn.py:266-284, dilations [1, 2])."""

    def __init__(self, in_channels: int, out_channels: int, A, stride: int = 1,
                 residual: bool = True, adaptive: bool = True,
                 kernel_size: int = 5, dilations: Sequence[int] = (1, 2),
                 dtype=None, graph_partition: str = "none"):
        super().__init__()
        self.stride = stride
        self.gcn1 = UnitGCN(in_channels, out_channels, A, adaptive=adaptive,
                            dtype=dtype, graph_partition=graph_partition)
        self.tcn1 = MultiScaleTCN(out_channels, out_channels,
                                  kernel_size=kernel_size, stride=stride,
                                  dilations=dilations, residual=False, dtype=dtype)
        self.res_mode = (
            "none" if not residual
            else "identity" if in_channels == out_channels and stride == 1
            else "conv"
        )
        if self.res_mode == "conv":
            self.residual = UnitTCN(in_channels, out_channels, kernel_size=1,
                                    stride=stride, dtype=dtype)

    def reset_parameters(self, generator):
        self.gcn1.reset_parameters(generator)
        self.tcn1.reset_parameters(generator)
        if self.res_mode == "conv":
            self.residual.reset_parameters(generator)

    def forward(self, x):
        y = self.tcn1(self.gcn1(x))
        if self.res_mode == "none":
            return F.relu(y)
        if self.res_mode == "identity":
            return F.relu(y + x)
        return F.relu(y + self.residual(x))


class CTRGCN(nn.Module):
    """Full TAM/CTR-GCN network (reference models/ctrgcn.py:287-374).

    10 TCN+GCN blocks, 64 -> 128 (stride 2 at l5) -> 256 (stride 2 at l8),
    data BN over (M, V, C) features, global (T, V) + person mean pooling,
    dropout, linear head. Parameters are drawn from `generator` (a CPU
    `torch.Generator`; seed 0 when none is given). `dtype` is the compute
    dtype (None or "float32", or "bfloat16"; the module docstring says what
    bf16 computes); the parameters are float32 in both, and so are the
    logits. `head=False` leaves out `fc` (and the dropout before it): a
    model that uses only `extract_feature`, as the cross-modal fusion model
    does, never initialises them in Flax. `graph_partition` "ring" rings
    every unit op over the model group that `set_ring` gives
    (parallel/sharded.py:parallelize).
    """

    seq = None

    def __init__(self, num_class: int = 60, num_point: int = 25,
                 num_person: int = 2, graph=None, graph_args=None,
                 in_channels: int = 3, drop_out: float = 0.0,
                 adaptive: bool = True, base_channel: int = 64,
                 generator: torch.Generator | None = None, dtype=None,
                 head: bool = True, graph_partition: str = "none"):
        super().__init__()
        self.dtype = dt = compute_dtype(dtype)
        if graph is None:
            raise ValueError("graph must be specified")
        if isinstance(graph, np.ndarray):
            A = graph
        elif isinstance(graph, str):
            A = get_graph(graph, **(graph_args or {})).A
        else:
            A = graph.A
        self.num_class = num_class
        self.num_point = num_point
        self.num_person = num_person
        bc = base_channel
        plan = [
            (in_channels, bc, 1, False), (bc, bc, 1, True), (bc, bc, 1, True),
            (bc, bc, 1, True), (bc, 2 * bc, 2, True), (2 * bc, 2 * bc, 1, True),
            (2 * bc, 2 * bc, 1, True), (2 * bc, 4 * bc, 2, True),
            (4 * bc, 4 * bc, 1, True), (4 * bc, 4 * bc, 1, True),
        ]
        for i, (cin, cout, stride, residual) in enumerate(plan):
            setattr(self, f"l{i + 1}", TCNGCNUnit(
                cin, cout, A, stride=stride, residual=residual, adaptive=adaptive,
                dtype=dt, graph_partition=graph_partition,
            ))
        self.data_bn = BatchNorm(num_person * num_point * in_channels, dtype=dt)
        self.fc = nn.Linear(4 * bc, num_class) if head else None
        # the head's dropout (ops/dropout.py: seeded, the identity in eval)
        self.dropout = SeededDropout(drop_out) if drop_out and head else None
        self.reset_parameters(generator or _default_generator())

    @property
    def blocks(self) -> list[TCNGCNUnit]:
        return [getattr(self, f"l{i}") for i in range(1, 11)]

    def set_ring(self, group) -> None:
        """Ring every unit op over `group` (graph_partition="ring")."""
        for blk in self.blocks:
            blk.gcn1.graph_partition = "ring"
            blk.gcn1.ring = group

    def reset_parameters(self, generator):
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.fc is not None:
            inits.fc_init_(self.fc.weight, self.num_class, generator)
            inits.torch_linear_bias_init_(self.fc.bias, self.fc.in_features, generator)

    def _to_ncvtm(self, x):
        """Accept reference layouts (N,C,T,V,M) or (N,T,V*C) -> (N,C,T,V,M)."""
        if x.ndim == 3:
            N, T, VC = x.shape
            x = x.reshape(N, T, self.num_point, VC // self.num_point)
            x = x.permute(0, 3, 1, 2)[..., None]  # (N, C, T, V, 1)
        return x

    def _stem(self, x):
        """data BN over flattened (M,V,C) features (reference :302, :330-332),
        on the input cast to the compute dtype."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        N, C, T, V, M = x.shape
        h = x.permute(0, 2, 4, 3, 1).reshape(N, T, M * V * C)
        h = self.data_bn(h).reshape(N, T, M, V, C)
        h = h.permute(0, 2, 1, 3, 4).reshape(N * M, T, V, C)
        return h, N, M

    def _backbone(self, h):
        for blk in self.blocks:
            layout = self.seq.layout if self.seq is not None else None
            h = blk(h)
            if layout is not None and blk.stride != 1:
                self.seq.layout = layout.strided(blk.stride)
        return h

    def forward(self, x):
        x = self._to_ncvtm(x)
        if self.seq is not None:
            self.seq.start(x.shape[2], x.device)
        h, N, M = self._stem(x)
        h = self._backbone(h)  # (N*M, T', V, 4*bc)
        h = h.reshape(N, M, -1, h.shape[-1])
        if self.seq is None:
            h = h.mean(dim=2).mean(dim=1)  # (N, C)
        else:  # the mean over the clip's frames on every rank
            h = self.seq.pool_sum(h.sum(dim=2)).mean(dim=1) / (
                self.seq.layout.T * self.num_point)
        if self.dropout is not None:
            h = self.dropout(h)
        # the head in the compute dtype, its logits widened to float32
        out = linear(self.fc, h, self.dtype)
        return out if self.dtype is None else out.float()

    def extract_feature(self, x):
        """Pre-pool features (N, C', T', V, M) — reference models/ctrgcn.py:350-374.

        Returns the feature tensor twice, matching the reference signature.
        Under sequence parallelism the whole clip's features on every rank,
        the ranks' frames gathered along T' (parallel/sequence.py).
        """
        x = self._to_ncvtm(x)
        if self.seq is not None:
            self.seq.start(x.shape[2], x.device)
        h, N, M = self._stem(x)
        h = self._backbone(h)  # (N*M, T', V, C')
        if self.seq is not None:
            h = self.seq.gather(h)
        _, Tp, V, Cp = h.shape
        h = h.reshape(N, M, Tp, V, Cp).permute(0, 4, 2, 3, 1)  # (N, C', T', V, M)
        return h, h


def create_ctrgcn_nucla(**overrides) -> CTRGCN:
    """NW-UCLA flagship config (reference config/nucla/gcn.yaml:20-27)."""
    kwargs = dict(
        num_class=10,
        num_point=20,
        num_person=1,
        graph="ucla",
        graph_args={"labeling_mode": "spatial"},
    )
    kwargs.update(overrides)
    return CTRGCN(**kwargs)
