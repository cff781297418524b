"""Cross-modal attention fusion: frozen CTR-GCN features gate ResNet-50 channels.

Counterpart of tamgcn_tpu/models/resnet_gcn_attention.py (reference
models/resnet_gcn_attention.py:6-122), with the Flax module names:

  * `gcn`: the port's CTRGCN built with the same arguments, without its
    head (the fusion uses only `extract_feature`); its features are averaged
    over (T', V, M);
  * `resnet`: ResNet-50 with conv1 taking `in_channels_rgb` channels (the
    replicated ST-ROI stack; the 3 -> 15 inflation of pretrained weights
    happens at import, utils/torch_import.py), without its head;
  * the attention MLP 256 -> 1024 -> BN -> ReLU -> 2048 -> sigmoid
    (`attention_transform_dense1`, `_bn`, `_dense2`) gating the layer4 map,
    the global pool and `classifier`.

Freezing (`freeze_gcn`, the default, with `freeze_gcn_bn`, the default too):
the GCN runs in eval mode (running-stat BatchNorm) even while the fusion
model trains, as the JAX model's `gcn_train = train and not (freeze_gcn and
freeze_gcn_bn)` does, so `train()` leaves it in eval mode and its BN
statistics never move; it runs under `torch.no_grad()` (JAX's
stop_gradient), so no activation is kept for a backward and on the card
only K1 runs in it (never K2 or K3). The trainer's `--freeze_params gcn`
masks its update and weight decay (train/packing.py:freeze_mask_for).
`freeze_gcn_bn=False` is the reference's literal behaviour: the GCN's
BatchNorms follow the model's mode (batch statistics in training, running
buffers updated), the gradient still stopped. `freeze_gcn=False` trains
the GCN: the gradient flows into it (K2 and K3 on the card).

Compute dtype (`dtype`): the GCN, the ResNet and the attention MLP compute
in it; `classifier`, which has no dtype in Flax, multiplies the pooled
features widened to its parameters' dtype (float32, or float64 in an f64
model), so the logits are float32 under bfloat16.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import inits
from ..ops.norm import BatchNorm
from ..parallel.sharded import linear
from .ctrgcn import CTRGCN, _default_generator, compute_dtype
from .resnet import resnet50

GCN_DIM, RGB_DIM = 256, 2048


class ResNetGCNAttention(nn.Module):
    def __init__(self, num_class: int = 10, num_point: int = 20, num_person: int = 1,
                 graph=None, graph_args=None, in_channels_gcn: int = 3,
                 in_channels_rgb: int = 15, drop_out: float = 0.0, adaptive: bool = True,
                 freeze_gcn: bool = True, freeze_gcn_bn: bool = True, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if graph is None:
            raise ValueError("graph must be specified")
        generator = generator or _default_generator()
        self.num_class = num_class
        self.freeze_gcn = freeze_gcn
        self.freeze_gcn_bn = freeze_gcn_bn
        self.dtype = dt = compute_dtype(dtype)
        self.gcn = CTRGCN(num_class=num_class, num_point=num_point, num_person=num_person,
                          graph=graph, graph_args=graph_args, in_channels=in_channels_gcn,
                          drop_out=drop_out, adaptive=adaptive, dtype=dt, head=False,
                          generator=generator)
        self.resnet = resnet50(in_channels=in_channels_rgb, dtype=dt, head=False,
                               generator=generator)
        self.attention_transform_dense1 = nn.Linear(GCN_DIM, RGB_DIM // 2)
        self.attention_transform_bn = BatchNorm(RGB_DIM // 2, dtype=dt)
        self.attention_transform_dense2 = nn.Linear(RGB_DIM // 2, RGB_DIM)
        self.classifier = nn.Linear(RGB_DIM, num_class)
        for dense in (self.attention_transform_dense1, self.attention_transform_dense2,
                      self.classifier):  # Flax Dense: lecun_normal, zero bias
            inits.lecun_normal_(dense.weight, generator)
            nn.init.zeros_(dense.bias)
        self.train()

    def train(self, mode: bool = True):
        """As nn.Module.train, but a GCN frozen with its BatchNorms stays in
        eval mode."""
        super().train(mode)
        if self.freeze_gcn and self.freeze_gcn_bn:
            self.gcn.train(False)
        return self

    def _dense(self, layer, x):
        return linear(layer, x, self.dtype)

    def forward(self, x_gcn, x_rgb):
        """x_gcn: (N, C, T, V, M) skeletons; x_rgb: (N, 3F, H, W) or NHWC."""
        # 1. frozen GCN semantic guidance (reference :82-91)
        stop = torch.no_grad() if self.freeze_gcn else contextlib.nullcontext()
        with stop:
            f_gcn, _ = self.gcn.extract_feature(x_gcn)
        f_gcn = f_gcn.mean(dim=(2, 3, 4))  # (N, 256)
        att = F.relu(self.attention_transform_bn(
            self._dense(self.attention_transform_dense1, f_gcn)))
        att = torch.sigmoid(self._dense(self.attention_transform_dense2, att))  # (N, 2048)

        # 2. ResNet trunk to layer4 (reference :97-105); NHWC feature map
        f_rgb = self.resnet.features(x_rgb)  # (N, 7, 7, 2048)

        # 3. channel gate + global pool + classify (reference :112-120)
        out = (f_rgb * att[:, None, None, :]).mean(dim=(1, 2))
        weight = self.classifier.weight
        out = out.to(torch.promote_types(out.dtype, weight.dtype))
        return F.linear(out, weight, self.classifier.bias)

    def extract_feature(self, x_gcn):
        return self.gcn.extract_feature(x_gcn)
