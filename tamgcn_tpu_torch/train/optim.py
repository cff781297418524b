"""Optimiser and LR schedule of the reference's training recipe, in flat space.

Counterpart of tamgcn_tpu/train/optim.py (an optax chain that
train/packing.py applies to the single flat-parameter leaf):

  * SGD with Nesterov momentum 0.9 and coupled weight decay on every
    parameter, added to the gradient before the momentum buffer (torch
    SGD's own rule, optax `add_decayed_weights` then `sgd`; reference
    processor/recognition_rgb.py:21-28);
  * step LR decay: lr = base_lr * decay^(#boundaries passed)
    (reference recognition_rgb.py:43-46);
  * optional linear warm-up over the first warm_up_epoch epochs
    (reference tools/train_stgcn_group.py:186-191, config gcn.yaml:41);
  * Adam with coupled weight decay (reference recognition_rgb.py:29-33),
    optax's `scale_by_adam` with its step counter on the device.

The optimisers update flat buffers in place (train/packing.py): a handful
of elementwise passes over each buffer, with the lr read from a 0-d tensor
on the buffer's device, so that a step holds no host read and can be
captured in a CUDA graph. The schedule stays a host function, per
optimiser step (epoch = step // steps_per_epoch): the lr of step k, counted
from 0 as optax counts, is schedule(k), written into the lr tensor before
the step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

# the reference's recipe: SGD's momentum, Adam's betas and eps
MOMENTUM = 0.9
BETAS = (0.9, 0.999)
EPS = 1e-8


def make_lr_schedule(
    base_lr: float,
    decay_epochs: Sequence[int],
    decay_rate: float,
    steps_per_epoch: int,
    warm_up_epoch: int = 0,
) -> Callable[[int], float]:
    boundaries = sorted(decay_epochs)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warm_up_epoch:
            return base_lr * (epoch + 1) / warm_up_epoch
        return base_lr * decay_rate ** sum(epoch >= b for b in boundaries)

    return schedule


class FlatSGD:
    """SGD with momentum 0.9 (Nesterov by default) and coupled weight decay
    over flat buffers: optax's add_decayed_weights + sgd(momentum=0.9)
    chain, step by step:

        d = g + wd * p;  buf = d + 0.9 * buf;  u = d + 0.9 * buf (Nesterov)
        or buf (heavy ball);  p = p - lr * u * mask

    The momentum of a frozen element (mask 0) advances, as optax's does,
    since the mask multiplies the update after the optimiser."""

    state_names = ("momentum_buffer",)

    def __init__(self, flats: Sequence[torch.Tensor], *, nesterov: bool = True,
                 weight_decay: float = 1e-4):
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        self.state = {"momentum_buffer": [torch.zeros_like(f) for f in flats]}

    def hyperparameters(self) -> dict:
        return dict(momentum=MOMENTUM, nesterov=self.nesterov,
                    weight_decay=self.weight_decay)

    @torch.no_grad()
    def update(self, params, grads, lrs, masks) -> None:
        m = MOMENTUM
        for p, g, buf, lr, mask in zip(params, grads, self.state["momentum_buffer"],
                                       lrs, masks):
            d = torch.add(g, p, alpha=self.weight_decay)
            buf.mul_(m).add_(d)
            u = torch.add(d, buf, alpha=m) if self.nesterov else buf.clone()
            u.mul_(lr)
            if mask is not None:
                u.mul_(mask)
            p.sub_(u)


class FlatAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with coupled weight decay over flat
    buffers: optax's add_decayed_weights + adam chain, its step counter a
    0-d f64 tensor beside the moments:

        d = g + wd * p;  mu = 0.1 d + 0.9 mu;  nu = 0.001 d^2 + 0.999 nu;
        k += 1;  u = (mu / (1 - 0.9^k)) / (sqrt(nu / (1 - 0.999^k)) + eps);
        p = p - lr * u * mask"""

    state_names = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, flats: Sequence[torch.Tensor], *, weight_decay: float = 1e-4):
        self.weight_decay = weight_decay
        # the step counter in f64: 1 - 0.999^k loses 4 of f32's 7 digits
        self.state = {
            "step": [torch.zeros((), dtype=torch.float64, device=f.device) for f in flats],
            "exp_avg": [torch.zeros_like(f) for f in flats],
            "exp_avg_sq": [torch.zeros_like(f) for f in flats],
        }

    def hyperparameters(self) -> dict:
        return dict(betas=BETAS, eps=EPS, weight_decay=self.weight_decay)

    @torch.no_grad()
    def update(self, params, grads, lrs, masks) -> None:
        b1, b2 = BETAS
        for i, (p, g, lr, mask) in enumerate(zip(params, grads, lrs, masks)):
            mu, nu, k = (self.state[n][i] for n in ("exp_avg", "exp_avg_sq", "step"))
            d = torch.add(g, p, alpha=self.weight_decay)
            mu.mul_(b1).add_(d, alpha=1 - b1)
            nu.mul_(b2).addcmul_(d, d, value=1 - b2)
            k.add_(1)
            mu_hat = mu / (1 - torch.pow(b1, k))
            nu_hat = nu / (1 - torch.pow(b2, k))
            u = mu_hat.div_(nu_hat.sqrt_().add_(EPS))
            u.mul_(lr)
            if mask is not None:
                u.mul_(mask)
            p.sub_(u)


def make_optimizer(optimizer: str, flats: Sequence[torch.Tensor], *,
                   nesterov: bool = True, weight_decay: float = 1e-4):
    """FlatSGD or FlatAdam over the flat parameter buffers `flats`
    (`nesterov` is SGD's; Adam takes none, as in the reference)."""
    if optimizer == "SGD":
        return FlatSGD(flats, nesterov=nesterov, weight_decay=weight_decay)
    if optimizer == "Adam":
        return FlatAdam(flats, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")
