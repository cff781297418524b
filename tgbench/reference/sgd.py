"""The training recipe of CTR-GCN's configurations: SGD with Nesterov
momentum 0.9 and weight decay added to the gradient of every parameter
(torch.optim.SGD's rule), the step learning rate with a linear warm-up over
the first epochs, and the mean cross-entropy."""
from __future__ import annotations

import torch
import torch.nn.functional as F

MOMENTUM = 0.9


def learning_rate(step: int, *, base_lr: float, steps_per_epoch: int, warm_up_epoch: int,
                  decay_epochs, decay_rate: float) -> float:
    epoch = step // steps_per_epoch
    if epoch < warm_up_epoch:
        return base_lr * (epoch + 1) / warm_up_epoch
    return base_lr * decay_rate ** sum(epoch >= b for b in decay_epochs)


def train_steps(forward, params: dict, batches, lrs, weight_decay: float):
    """Run len(batches) SGD steps from `params` (float tensors requiring no
    grad; not modified). Returns (losses, first gradients by name, params
    after the steps by name, the first step's logits). `forward(w, x)`
    gives the logits."""
    w = {k: v.clone() for k, v in params.items()}
    names = [k for k in w if not k.endswith(("running_mean", "running_var"))]
    momentum = {k: torch.zeros_like(w[k]) for k in names}
    losses, first, first_logits = [], None, None
    for (x, y), lr in zip(batches, lrs):
        leaves = {k: w[k].detach().requires_grad_(True) for k in names}
        logits = forward({**w, **leaves}, x)
        if first_logits is None:
            first_logits = logits.detach().clone()
        loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + weight_decay * w[k]
                momentum[k].mul_(MOMENTUM).add_(d)
                w[k] = w[k] - lr * (d + MOMENTUM * momentum[k])
        del grads, loss, leaves, logits
    return losses, first, w, first_logits
