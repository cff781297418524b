"""ResNet family for the RGB branch (torchvision lineage).

Counterpart of tamgcn_tpu/models/resnet.py (reference models/resnet.py):
`BasicBlock`, `Bottleneck`, `ResNet` with `features()`, and the
constructors resnet18 ... wide_resnet101_2. The submodules carry the Flax
module names (`conv1`, `bn1`, `layer1_0` ... `layer4_2`, in a block `conv1`
... `conv3`, `bn1` ... `bn3`, `downsample_conv`, `downsample_bn`, `fc`), so
convert.from_flax and convert.flax_param_paths map the JAX variables and
freeze prefixes one to one; torchvision's names (`layer1.0.conv1`,
`downsample.0`) come in through utils/torch_import.py.

Activations are NHWC, as in the JAX model: each k x k conv is `F.conv2d`
on the `.permute(0, 3, 1, 2)` view, an NCHW tensor in channels_last memory
format, on cuDNN (convolutions that XLA, not Pallas, computes in the JAX
package); BatchNorm (ops/norm.py, momentum 0.1 = Flax's 0.9, eps 1e-5)
normalises the last axis. The stem's 3x3 max-pool pads with -inf, as
Flax's does. Inits: kaiming normal fan-out for the convs, BatchNorm scale 1
and bias 0, and torch's nn.Linear uniform for `fc`.

Compute dtype (`dtype` None or "float32", or "bfloat16"): in bfloat16 the
stem casts the input, every conv casts its weight to bf16, BatchNorm
normalises in bf16 (ops/norm.py), the head runs in bf16 and its logits are
widened to float32 (the JAX model's promote at resnet.py:237-241); the
parameters and BatchNorm statistics stay float32.

`block_dropout` (the reference's p=0.1 "#Bruce" variant) is a seeded
dropout site (ops/dropout.py) after each ReLU of a block, as the JAX
model's nn.Dropout; the identity in eval.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import inits
from ..ops.dropout import SeededDropout
from ..ops.norm import BatchNorm
from ..parallel.sharded import linear
from .ctrgcn import _default_generator, compute_dtype


class Conv2d(nn.Module):
    """A bias-free k x k conv on NHWC activations (Flax nn.Conv with 'same'
    padding (k-1)//2 * dilation), weight (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dilation: int = 1, dtype=None):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.pad = dilation * (kernel - 1) // 2
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))

    def reset_parameters(self, generator):
        inits.kaiming_normal_fan_out_(self.weight, generator)

    def forward(self, x):
        w = self.weight if self.dtype is None else self.weight.to(self.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=self.pad,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1).contiguous()


class _Block(nn.Module):
    def _residual(self, x):
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(self.downsample_conv(x))

    def reset_parameters(self, generator):
        for m in self.children():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator)


class BasicBlock(_Block):
    """3x3 + 3x3 residual block (reference models/resnet.py:35-78)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, block_dropout: float = 0.0, dtype=None):
        super().__init__()
        dt = compute_dtype(dtype)
        self.drop = SeededDropout(block_dropout)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, dtype=dt)
        self.bn1 = BatchNorm(planes, dtype=dt)
        self.conv2 = Conv2d(planes, planes, 3, dtype=dt)
        self.bn2 = BatchNorm(planes, dtype=dt)
        self.downsample_conv = (Conv2d(inplanes, planes, 1, stride, dtype=dt)
                                if downsample else None)
        self.downsample_bn = BatchNorm(planes, dtype=dt) if downsample else None

    def forward(self, x):
        out = self.drop(F.relu(self.bn1(self.conv1(x))))
        out = self.bn2(self.conv2(out))
        return self.drop(F.relu(out + self._residual(x)))


class Bottleneck(_Block):
    """1x1 -> 3x3 -> 1x1 bottleneck block (reference models/resnet.py:81-129)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 64, dilation: int = 1,
                 block_dropout: float = 0.0, dtype=None):
        super().__init__()
        dt = compute_dtype(dtype)
        self.drop = SeededDropout(block_dropout)
        width = int(planes * (base_width / 64.0))
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, dtype=dt)
        self.bn1 = BatchNorm(width, dtype=dt)
        self.conv2 = Conv2d(width, width, 3, stride, dilation, dtype=dt)
        self.bn2 = BatchNorm(width, dtype=dt)
        self.conv3 = Conv2d(width, out, 1, dtype=dt)
        self.bn3 = BatchNorm(out, dtype=dt)
        self.downsample_conv = Conv2d(inplanes, out, 1, stride, dtype=dt) if downsample else None
        self.downsample_bn = BatchNorm(out, dtype=dt) if downsample else None

    def forward(self, x):
        out = self.drop(F.relu(self.bn1(self.conv1(x))))
        out = self.drop(F.relu(self.bn2(self.conv2(out))))
        out = self.bn3(self.conv3(out))
        return self.drop(F.relu(out + self._residual(x)))


_ARCH = {(BasicBlock, (2, 2, 2, 2)): "resnet18", (BasicBlock, (3, 4, 6, 3)): "resnet34",
         (Bottleneck, (3, 4, 6, 3)): "resnet50", (Bottleneck, (3, 4, 23, 3)): "resnet101",
         (Bottleneck, (3, 8, 36, 3)): "resnet152"}


class ResNet(nn.Module):
    """Reference models/resnet.py:132-224 trunk; input NCHW or NHWC images.

    `features(x)` returns the layer4 map (N, H/32, W/32, 512*expansion), the
    map the cross-modal attention model gates (resnet_gcn_attention.py).
    `head=False` leaves out `fc`, which a model that uses only `features`
    never initialises in Flax. Parameters are drawn from `generator` (a CPU
    `torch.Generator`; seed 0 when none is given)."""

    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, in_channels: int = 3,
                 width_per_group: int = 64, block_dropout: float = 0.0, dtype=None,
                 head: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = compute_dtype(dtype)
        self.in_channels = in_channels
        self.bottleneck = block is Bottleneck
        self.arch = _ARCH.get((block, tuple(layers)), "custom")
        self.conv1 = Conv2d(in_channels, 64, 7, 2, dtype=dt)
        self.bn1 = BatchNorm(64, dtype=dt)
        inplanes = 64
        self.layer_names = []
        for li, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                     (1, 2, 2, 2))):
            for bi in range(n):
                s = stride if bi == 0 else 1
                kwargs = dict(stride=s, block_dropout=block_dropout, dtype=dt,
                              downsample=bi == 0 and (
                                  s != 1 or inplanes != planes * block.expansion))
                if block is Bottleneck:
                    kwargs["base_width"] = width_per_group
                name = f"layer{li + 1}_{bi}"
                setattr(self, name, block(inplanes, planes, **kwargs))
                self.layer_names.append(name)
                inplanes = planes * block.expansion
        self.feature_dim = inplanes
        self.fc = nn.Linear(inplanes, num_classes) if head else None
        self.reset_parameters(generator or _default_generator())

    def reset_parameters(self, generator):
        self.conv1.reset_parameters(generator)
        for name in self.layer_names:
            getattr(self, name).reset_parameters(generator)
        if self.fc is not None:
            fan_in = self.fc.in_features
            inits.torch_linear_bias_init_(self.fc.weight, fan_in, generator)
            inits.torch_linear_bias_init_(self.fc.bias, fan_in, generator)

    def _to_nhwc(self, x):
        # accept NCHW (reference convention) or NHWC
        if x.shape[1] == self.in_channels and x.shape[-1] != self.in_channels:
            x = x.permute(0, 2, 3, 1)
        return x

    def stem(self, x):
        x = self._to_nhwc(x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        return y.permute(0, 2, 3, 1).contiguous()

    def features(self, x):
        """Stem + layer1..layer4 -> (N, H/32, W/32, C_feat), NHWC."""
        h = self.stem(x)
        for name in self.layer_names:
            h = getattr(self, name)(h)
        return h

    def forward(self, x):
        h = self.features(x).mean(dim=(1, 2))  # AdaptiveAvgPool2d((1,1)) + flatten
        # the head in the compute dtype, its logits widened to float32
        out = linear(self.fc, h, self.dtype)
        return out if self.dtype is None else out.float()


def resnet18(**kw):
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), **kw)


def resnet152(**kw):
    return ResNet(block=Bottleneck, layers=(3, 8, 36, 3), **kw)


def wide_resnet50_2(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), width_per_group=128, **kw)


def wide_resnet101_2(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), width_per_group=128, **kw)
