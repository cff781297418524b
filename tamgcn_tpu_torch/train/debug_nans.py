"""--debug_nans: stop at the first non-finite value, naming where it arose.

The JAX trainer sets `jax_debug_nans`, which re-runs a jitted step op by op
when it produced a NaN and raises FloatingPointError at the first primitive
that made one (tamgcn_tpu/train/trainer.py:66-67). The port's counterpart:

  * with the flag on, each train, eval and fast-eval step also returns one
    0-d flag, `all_finite` of the loss, the logits, the packed gradient and
    the packed parameters and BatchNorm statistics (train/packing.py keeps
    them flat; the eval steps of a test phase check the model's parameters
    and buffers), computed inside the step, so the CUDA graph holds it; the
    trainer reads it on the host after every step. With the flag off no
    check runs and the steps are the ones without it;
  * on the first non-finite flag the trainer restores the state the step
    started from (a copy it keeps while the flag is on) and re-runs the step
    eagerly on the same batch with forward hooks on every module
    (`locate_non_finite`), then raises FloatingPointError naming the first
    module whose output is not finite, or else the first parameter whose
    gradient is not finite, or else what the optimiser's update made
    non-finite, with the step and the epoch.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor, whether every element of every tensor is finite
    (no host read: a CUDA graph can capture it)."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def checked(step, tensors: Sequence[torch.Tensor]):
    """An eval step ``step(*inputs, label) -> (loss, logits)`` that also
    returns all_finite of the loss, the logits and `tensors`."""
    tensors = list(tensors)

    def fn(*args):
        loss, logits = step(*args)
        return loss, logits, all_finite([loss, logits, *tensors])

    return fn


def _tensors(output):
    if isinstance(output, torch.Tensor):
        return [output]
    if isinstance(output, (tuple, list)):
        return [t for t in output if isinstance(t, torch.Tensor)]
    return []


def locate_non_finite(model: torch.nn.Module, inputs, label, train: bool) -> str | None:
    """Where a step on (inputs, label) first makes a non-finite value, run
    eagerly with a forward hook on every module: "the output of module X",
    "the loss", "the gradient of parameter Y (module X)", or None where the
    forward and backward stay finite."""
    first: list[str] = []

    def hook(name):
        def fn(module, args, output):
            if not first and any(not bool(torch.isfinite(t).all())
                                 for t in _tensors(output)):
                first.append(name)
        return fn

    handles = [m.register_forward_hook(hook(name or type(model).__name__))
               for name, m in model.named_modules()]
    try:
        with torch.enable_grad() if train else torch.inference_mode():
            logits = model(*inputs)
            loss = F.cross_entropy(logits, label)
            if first:
                return f"the output of module {first[0]}"
            if not bool(torch.isfinite(loss)):
                return "the loss"
            if not train:
                return None
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True,
                                        materialize_grads=True)
            for (name, _), g in zip(named, grads):
                if not bool(torch.isfinite(g).all()):
                    owner = name.rpartition(".")[0] or type(model).__name__
                    return f"the gradient of parameter {name} (module {owner})"
            return None
    finally:
        for h in handles:
            h.remove()


def non_finite_names(named_tensors) -> list[str]:
    """The names of the tensors that hold a non-finite value."""
    return [name for name, t in named_tensors if not bool(torch.isfinite(t).all())]
