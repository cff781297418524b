"""BatchNorm over the last axis with torch running-stat semantics.

Counterpart of tamgcn_tpu/ops/norm.py: normalisation uses the biased batch
variance in train mode and the running stats in eval mode; the running
variance accumulates the UNBIASED batch variance with momentum 0.1
(torch.nn.BatchNorm2d, as the reference constructs it in
models/ctrgcn.py:191,240-244), eps 1e-5. Activations are NTVC, so the
feature axis is the last one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of an (..., C) tensor."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        y = F.batch_norm(
            x.reshape(-1, self.num_features),
            self.running_mean,
            self.running_var,
            self.weight,
            self.bias,
            training=self.training,
            momentum=self.momentum,
            eps=self.eps,
        )
        return y.reshape(shape)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}, momentum={self.momentum}"
