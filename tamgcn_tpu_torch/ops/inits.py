"""Parameter initialisers matching the reference's PyTorch init schemes.

Counterpart of tamgcn_tpu/ops/inits.py, for tensors in PyTorch layout:
conv weights (out, in, kh, kw), 1x1 convs and linears (out, in). Each
function fills its tensor in place from a `torch.Generator` on the CPU, so
a model built on the CPU from a seed has the same weights wherever it is
moved. Semantics mirror reference models/ctrgcn.py:17-49 (conv_init,
bn_init, weights_init), models/ctrgcn.py:317 (fc init) and, for ST-GCN,
PyTorch's default conv init (`torch_conv_default_`).
"""
from __future__ import annotations

import math

import torch


def _fill_normal(t: torch.Tensor, std: float, generator: torch.Generator,
                 mean: float = 0.0) -> torch.Tensor:
    with torch.no_grad():
        noise = torch.randn(t.shape, generator=generator, dtype=t.dtype)
        return t.copy_(noise * std + mean)


def _receptive(shape) -> int:
    receptive = 1
    for k in shape[2:]:
        receptive *= k
    return receptive


def kaiming_normal_fan_out_(t, generator):
    """nn.init.kaiming_normal_(mode='fan_out'): std = sqrt(2 / fan_out),
    fan_out = out_channels * prod(kernel dims). Reference :26-30 (conv_init)."""
    return _fill_normal(t, math.sqrt(2.0 / (t.shape[0] * _receptive(t.shape))), generator)


def kaiming_normal_fan_out_blocked_(t, blocks: int, generator):
    """kaiming fan-out for a PACKED conv holding `blocks` independent convs
    concatenated on the output axis: fan_out uses the per-block width, so
    packing does not change the per-slice distribution."""
    fan_out = (t.shape[0] // blocks) * _receptive(t.shape)
    return _fill_normal(t, math.sqrt(2.0 / fan_out), generator)


def kaiming_normal_fan_out_dense_(t, generator):
    """kaiming fan-out for an (..., in, out) kernel such as the stacked
    per-subset conv4 kernels (S, R, C): fan_out is the trailing width."""
    return _fill_normal(t, math.sqrt(2.0 / t.shape[-1]), generator)


def fc_init_(t, num_class: int, generator):
    """Normal(0, sqrt(2/num_class)) head init (reference models/ctrgcn.py:317)."""
    return _fill_normal(t, math.sqrt(2.0 / num_class), generator)


def torch_linear_bias_init_(t, fan_in: int, generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's nn.Linear bias init."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=t.dtype)
        return t.copy_(u * (2 * bound) - bound)


def bn_weights_init_(t, generator):
    """weights_init BN scale: normal(1.0, 0.02) (reference models/ctrgcn.py:45-49)."""
    return _fill_normal(t, 0.02, generator, mean=1.0)


def torch_conv_default_(t, generator, fan_in: int | None = None):
    """PyTorch's Conv2d/Linear default, kaiming_uniform_(a=sqrt(5)) ==
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in * prod(kernel dims) of a
    weight (out, in, ...) unless given (a bias takes its weight's fan_in).
    The ST-GCN init (tamgcn_tpu/models/stgcn.py: torch_conv_default_*_init)."""
    if fan_in is None:
        fan_in = t.shape[1] * _receptive(t.shape)
    return torch_linear_bias_init_(t, fan_in, generator)


def lecun_normal_(t, generator):
    """Flax's default Dense kernel init, lecun_normal: a normal truncated at
    two standard deviations, variance 1 / fan_in after the truncation
    (variance_scaling(1, "fan_in", "truncated_normal")); `t` is (out, in)."""
    std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                           generator=generator)
