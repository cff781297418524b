"""Weights from the seed, made on the device in one draw.

Every tensor of the network (reference/model.py:spec) takes its slice of one
normal draw from a generator on the device, scaled by its kind: He-normal
fan-out convolutions (the network's init), and the parts the init leaves
degenerate moved off it, as a model in training has them: alpha 0.5 N
(0 would make the refinement vanish), the TAM offset conv 0.02 N (zero at
init), BatchNorm scales 1 + 0.1 N and shifts 0.05 N (the graph layer's
scale is 1e-6 at init), conv biases 0.02 N, the adjacency the graph's plus
0.02 N. Running statistics start at mean 0, variance 1; `calibrate` sets
them from one train-mode pass of the reference, so that evaluation sees
activations of order 1 through the ten blocks.
"""
from __future__ import annotations

import math

import torch

from .reference import model as ref


def make(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for the network of `cfg`."""
    spec = ref.spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    graph = torch.as_tensor(ref.adjacency(cfg), dtype=torch.float32, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        z = noise[at:at + n].view(shape)
        at += n
        base, _, arg = kind.partition(":")
        if base in ("conv", "conv4"):
            t = z * math.sqrt(2.0 / int(arg))
        elif base == "fc":
            t = z * math.sqrt(2.0 / cfg["num_class"])
        elif base == "offset":
            t = 0.02 * z
        elif base == "bias":
            t = 0.02 * z
        elif base == "bn_weight":
            t = 1.0 + 0.1 * z
        elif base == "bn_bias":
            t = 0.05 * z
        elif base == "alpha":
            t = 0.5 * z
        elif base == "pa":
            t = graph + 0.02 * z
        elif base == "mean":
            t = torch.zeros_like(z)
        elif base == "var":
            t = torch.ones_like(z)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out


def calibrate(cfg: dict, w: dict, x: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics, in place, to the batch
    statistics of one train-mode reference pass over x."""
    stats: dict = {}
    with torch.no_grad():
        ref.forward(cfg, w, x, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        w[f"{name}.running_mean"].copy_(mean)
        w[f"{name}.running_var"].copy_(var)

