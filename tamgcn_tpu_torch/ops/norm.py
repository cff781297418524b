"""BatchNorm over the last axis with torch running-stat semantics.

Counterpart of tamgcn_tpu/ops/norm.py: normalisation uses the biased batch
variance in train mode and the running stats in eval mode; the running
variance accumulates the UNBIASED batch variance with momentum 0.1
(torch.nn.BatchNorm2d, as the reference constructs it in
models/ctrgcn.py:191,240-244), eps 1e-5. Activations are NTVC, so the
feature axis is the last one.

With a compute dtype of bfloat16 (the module's `dtype`, else the input's, as
the JAX module takes `self.dtype or x.dtype`) it follows the JAX module's
order step by step (tamgcn_tpu/ops/norm.py:66-92): mean and variance (the
mean of squares less the squared mean, at least 0) in f32 from the input;
the running stats updated in f32; then the normalisation in bf16
arithmetic, with mean, variance, eps, scale and bias each rounded to bf16
first and every operation's result rounded to bf16. In float32 (and
float64) it is `F.batch_norm`, as before.

Over a group of ranks (`group`, a parallel.comm.Group of more than one rank,
set by parallel/sharded.py:parallelize): in train mode the statistics are
those of the group's whole batch, as GSPMD reduces the JAX BatchNorm's
means over a sharded axis. Each rank sums x, x*x and its count into one
vector, one all-reduce (parallel/comm.py:all_reduce, whose backward
all-reduces the gradients of those sums: the sum of dy and of dy*x-hat
in another form) gives the group's sums, and the variance is the mean of
squares less the squared mean, at least 0, as the JAX BatchNorm computes
it (tamgcn_tpu/ops/norm.py:66-92); the running stats update from the
group's batch with its unbiased variance. torch.nn.SyncBatchNorm is not
used: it refuses CPU tensors, and under gloo it calls collectives that
refuse CUDA tensors; one all-reduce runs the same code on both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of an (..., C) tensor; `dtype` None
    computes in the input's dtype, torch.bfloat16 in bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = comm.SOLO  # the ranks whose batch the statistics span

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group.size > 1:
            return self._forward_group(x)
        if (self.dtype or x.dtype) == torch.bfloat16:
            return self._forward_bf16(x)
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

    def _forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.bfloat16
        if self.training:
            xf = x.reshape(-1, self.num_features).float()
            mean = xf.mean(dim=0)
            var = torch.clamp_min((xf * xf).mean(dim=0) - mean * mean, 0.0)
            with torch.no_grad():
                n = xf.shape[0]
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        # eps rounded to bf16 and added as a scalar (computed in f32, rounded
        # once: the bf16 sum, with no host-to-device copy); the rsqrt of the
        # bf16 sum in f32, rounded once (torch's own bf16 rsqrt on the CPU is
        # not correctly rounded)
        mul = var.to(dt) + float(torch.tensor(self.eps, dtype=dt))
        mul = torch.rsqrt(mul.float()).to(dt) * self.weight.to(dt)
        return (x.to(dt) - mean.to(dt)) * mul + self.bias.to(dt)

    def _forward_group(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over `group`: the group's batch statistics."""
        dt = self.dtype or x.dtype
        xf = x.reshape(-1, self.num_features)
        xf = xf.to(torch.promote_types(xf.dtype, torch.float32))
        count = torch.full((1,), float(xf.shape[0]), dtype=xf.dtype, device=xf.device)
        sums = comm.all_reduce(torch.cat([xf.sum(dim=0), (xf * xf).sum(dim=0), count]),
                               self.group)
        c = self.num_features
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var * (n / torch.clamp_min(n - 1, 1)))
        if dt == torch.bfloat16:
            mul = var.to(dt) + float(torch.tensor(self.eps, dtype=dt))
            mul = torch.rsqrt(mul.float()).to(dt) * self.weight.to(dt)
            return (x.to(dt) - mean.to(dt)) * mul + self.bias.to(dt)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(dt)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}, momentum={self.momentum}"
