"""CTR-GCN with the TAM offset branch, in plain PyTorch, as a function of a
dict of named tensors.

The network of Chen et al., "Channel-wise Topology Refinement Graph
Convolution for Skeleton-Based Action Recognition" (ICCV 2021), with TAM's
offset branch in each graph layer: ten blocks (widths 64, 64, 64, 64, 128,
128, 128, 256, 256, 256 at base width 64; stride 2 at the fifth and eighth),
each a graph layer and a multi-scale temporal layer (kernel 5, dilations 1
and 2, a max-pool branch and a strided 1x1 branch); a BatchNorm over the
input's (person, joint, coordinate) features, the mean over time, joints and
persons, and a linear classifier.

Activations are (batch, time, joint, channel). The graph layer of a block:

    x1s, x2s = the three subsets' 1x1 convs of the clip's mean over time
    x3s      = the three subsets' 1x1 convs of x
    M_s      = (tanh(x1s[u] - x2s[v]) @ w4_s + b4_s) * alpha + PA_s[u, v]
    y        = BN(sum_s sum_v M_s[u, v, c] x3s[t, v, c])
    res      = BN(down(x)) or x
    out      = relu(y + tanh(BN(offset(res - y))) + res)

The names and shapes of the tensors are those of the checkpoints the
system under test saves (`spec`), so one set of weights serves both. The
three subsets' 1x1 convs are kept packed in one weight each (rows of the
subsets one after the other), and the temporal layer's branch BatchNorms
are one BatchNorm over the concatenated branches: both are the same
function as separate layers. BatchNorm: biased batch variance in training,
running statistics in evaluation, eps 1e-5. Nothing here reads a kernel,
a cache or a batch plan.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graphs import spatial_graph

EPS = 1e-5
SUBSETS = 3
KERNEL = 5
DILATIONS = (1, 2)


def rel_channels(cin: int) -> int:
    return 8 if cin in (3, 9) else cin // 8


def plan(base: int, cin: int = 3):
    """(in, out, stride, residual) of the ten blocks."""
    b = base
    return [(cin, b, 1, False), (b, b, 1, True), (b, b, 1, True), (b, b, 1, True),
            (b, 2 * b, 2, True), (2 * b, 2 * b, 1, True), (2 * b, 2 * b, 1, True),
            (2 * b, 4 * b, 2, True), (4 * b, 4 * b, 1, True), (4 * b, 4 * b, 1, True)]


def spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, kind)] of every tensor of the network, in the order of
    the system's state dict. kind: 'conv:<fan_out>', 'conv4:<fan_out>', 'fc',
    'bias', 'bn_weight', 'bn_bias', 'mean', 'var', 'alpha', 'pa',
    'offset'."""
    v, m, k = cfg["num_point"], cfg["num_person"], cfg["num_class"]
    out = []

    def conv(name, cout, cin, blocks=1, kind="conv"):
        out.append((f"{name}.weight", (cout, cin), f"{kind}:{cout // blocks}"))
        out.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
                    (f"{name}.running_mean", (c,), "mean"),
                    (f"{name}.running_var", (c,), "var")])

    for i, (cin, c, stride, residual) in enumerate(plan(cfg["base_channel"],
                                                        cfg.get("in_channels", 3))):
        p, r, bc = f"l{i + 1}", rel_channels(cin), c // 4
        g = f"{p}.gcn1"
        out.append((f"{g}.PA", (SUBSETS, v, v), "pa"))
        out.append((f"{g}.alpha", (1,), "alpha"))
        out.append((f"{g}.conv4_kernel", (SUBSETS, r, c), f"conv4:{c}"))
        out.append((f"{g}.conv4_bias", (SUBSETS, c), "bias"))
        conv(f"{g}.conv12", 2 * SUBSETS * r, cin, 2 * SUBSETS)
        conv(f"{g}.conv3", SUBSETS * c, cin, SUBSETS)
        bn(f"{g}.bn", c)
        if cin != c:
            conv(f"{g}.down_conv", c, cin)
            bn(f"{g}.down_bn", c)
        conv(f"{g}.offset_conv", c, c, kind="offset")
        bn(f"{g}.offset_bn", c)
        t = f"{p}.tcn1"
        conv(f"{t}.prefix_conv", 3 * bc, c, 3)
        bn(f"{t}.prefix_bn", 3 * bc)
        for j in range(len(DILATIONS)):
            out.append((f"{t}.branch{j}_tconv_conv.weight", (bc, bc, KERNEL, 1),
                        f"conv:{bc * KERNEL}"))
            out.append((f"{t}.branch{j}_tconv_conv.bias", (bc,), "bias"))
        conv(f"{t}.pw_conv", bc, c)
        bn(f"{t}.out_bn", c)
        if residual and (cin != c or stride != 1):
            out.append((f"{p}.residual.conv.weight", (c, cin, 1, 1), f"conv:{c}"))
            out.append((f"{p}.residual.conv.bias", (c,), "bias"))
            bn(f"{p}.residual.bn", c)
    bn("data_bn", m * v * cfg.get("in_channels", 3))
    out.append(("fc.weight", (k, 4 * cfg["base_channel"]), "fc"))
    out.append(("fc.bias", (k,), "bias"))
    return out


def adjacency(cfg: dict) -> np.ndarray:
    return spatial_graph(cfg["graph"])


class Net:
    """The network on the tensors `w` (a dict by the names of `spec`).
    train=True normalises with the batch's statistics; `stats`, a dict, then
    receives each BatchNorm's (mean, unbiased variance) of the batch."""

    def __init__(self, cfg: dict, w: dict, train: bool, stats: dict | None = None):
        self.cfg, self.w, self.train, self.stats = cfg, w, train, stats

    def bn(self, name: str, x):
        w = self.w
        if self.train:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = ((flat - mean) ** 2).mean(dim=0)
            if self.stats is not None:
                n = flat.shape[0]
                self.stats[name] = (mean.detach(), var.detach() * n / max(n - 1, 1))
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        return (x - mean) / torch.sqrt(var + EPS) * w[f"{name}.weight"] + w[f"{name}.bias"]

    def lin(self, name: str, x):
        return F.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def tconv(self, x, weight, bias, stride: int, dilation: int):
        pad = dilation * (weight.shape[2] - 1) // 2
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=(stride, 1),
                     padding=(pad, 0), dilation=(dilation, 1))
        return y.permute(0, 2, 3, 1)

    def graph_layer(self, p: str, x, cin: int, c: int):
        w, g = self.w, f"{p}.gcn1"
        n, _, v, _ = x.shape
        r = rel_channels(cin)
        # the 1x1 convs of the time mean (a 1x1 conv commutes with the mean)
        e = self.lin(f"{g}.conv12", x.mean(dim=1))
        x1 = e[..., :SUBSETS * r].reshape(n, v, SUBSETS, r)
        x2 = e[..., SUBSETS * r:].reshape(n, v, SUBSETS, r)
        x3 = self.lin(f"{g}.conv3", x)
        y = 0
        for s in range(SUBSETS):
            d = torch.tanh(x1[:, :, None, s] - x2[:, None, :, s])  # (n, u, v, r)
            m = (torch.matmul(d, w[f"{g}.conv4_kernel"][s]) + w[f"{g}.conv4_bias"][s])
            m = m * w[f"{g}.alpha"] + w[f"{g}.PA"][s][None, :, :, None]
            y = y + torch.einsum("nuvc,ntvc->ntuc", m, x3[..., s * c:(s + 1) * c])
        y = self.bn(f"{g}.bn", y)
        res = self.bn(f"{g}.down_bn", self.lin(f"{g}.down_conv", x)) if cin != c else x
        offset = torch.tanh(self.bn(f"{g}.offset_bn", self.lin(f"{g}.offset_conv", res - y)))
        return F.relu(y + offset + res)

    def temporal_layer(self, p: str, x, stride: int):
        w, t = self.w, f"{p}.tcn1"
        bc = x.shape[-1] // 4
        prefix = F.relu(self.bn(f"{t}.prefix_bn", self.lin(f"{t}.prefix_conv", x)))
        outs = [self.tconv(prefix[..., j * bc:(j + 1) * bc], w[f"{t}.branch{j}_tconv_conv.weight"],
                           w[f"{t}.branch{j}_tconv_conv.bias"], stride, dil)
                for j, dil in enumerate(DILATIONS)]
        pool = F.max_pool2d(prefix[..., 2 * bc:].permute(0, 3, 1, 2), kernel_size=(3, 1),
                            stride=(stride, 1), padding=(1, 0))
        outs.append(pool.permute(0, 2, 3, 1))
        outs.append(self.lin(f"{t}.pw_conv", x[:, ::stride]))
        return self.bn(f"{t}.out_bn", torch.cat(outs, dim=-1))

    def __call__(self, x):
        """x (N, C, T, V, M) -> logits (N, classes)."""
        cfg, w = self.cfg, self.w
        n, cin, t, v, m = x.shape
        h = x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * cin)
        h = self.bn("data_bn", h).reshape(n, t, m, v, cin)
        h = h.permute(0, 2, 1, 3, 4).reshape(n * m, t, v, cin)
        for i, (ci, c, stride, residual) in enumerate(plan(cfg["base_channel"], cin)):
            p = f"l{i + 1}"
            y = self.temporal_layer(p, self.graph_layer(p, h, ci, c), stride)
            if residual and (ci != c or stride != 1):
                wr = w[f"{p}.residual.conv.weight"][:, :, 0, 0]
                y = y + self.bn(f"{p}.residual.bn",
                                F.linear(h[:, ::stride], wr, w[f"{p}.residual.conv.bias"]))
            elif residual:
                y = y + h
            h = F.relu(y)
        h = h.reshape(n, m, -1, h.shape[-1]).mean(dim=2).mean(dim=1)
        return F.linear(h, w["fc.weight"], w["fc.bias"])


def forward(cfg: dict, w: dict, x, train: bool = False, stats: dict | None = None):
    return Net(cfg, w, train, stats)(x)


def logits_in_blocks(cfg: dict, w: dict, x, rows: int = 64):
    """Eval-mode logits of x, `rows` samples at a time."""
    with torch.no_grad():
        return torch.cat([forward(cfg, w, x[i:i + rows]) for i in range(0, len(x), rows)])
