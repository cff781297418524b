"""Optimiser and LR schedule of the reference's training recipe.

Counterpart of tamgcn_tpu/train/optim.py (optax) with torch.optim:

  * SGD with Nesterov momentum 0.9 and coupled weight decay on every
    parameter, added to the gradient before the momentum buffer (torch
    SGD's own rule; reference processor/recognition_rgb.py:21-28);
  * step LR decay: lr = base_lr * decay^(#boundaries passed)
    (reference recognition_rgb.py:43-46);
  * optional linear warm-up over the first warm_up_epoch epochs
    (reference tools/train_stgcn_group.py:186-191, config gcn.yaml:41);
  * Adam with coupled weight decay (reference recognition_rgb.py:29-33).

The schedule is per optimiser step (epoch = step // steps_per_epoch): the
lr of step k, counted from 0 as optax counts, is schedule(k), and the
trainer sets it on the param groups before each step.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


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


def make_optimizer(
    optimizer: str,
    params,
    base_lr: float,
    *,
    nesterov: bool = True,
    weight_decay: float = 1e-4,
) -> torch.optim.Optimizer:
    """SGD (momentum 0.9) or Adam over `params`, both with the weight decay
    coupled into the gradient; the lr is set per step from the schedule."""
    if optimizer == "SGD":
        return torch.optim.SGD(params, lr=base_lr, momentum=0.9,
                               nesterov=nesterov, weight_decay=weight_decay)
    if optimizer == "Adam":
        return torch.optim.Adam(params, lr=base_lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
