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

On a grid of ranks (JAX sets jax_debug_nans whatever the mesh) the flag is
reduced over the world inside the step, so every rank sees one verdict;
every rank then restores its state and re-runs the step together (the
re-run's collectives need all ranks), and the ranks agree on where the
first non-finite value arose (the earliest, in the order the modules ran,
that any rank saw), so every rank raises naming the same module. A rank
that raised alone would leave the others waiting in a collective.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel import comm


def all_finite(tensors: Sequence[torch.Tensor], group: comm.Group = comm.SOLO) -> torch.Tensor:
    """A 0-d bool tensor, whether every element of every tensor is finite
    on every rank of `group` (no host read: a CUDA graph can capture it)."""
    finite = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    if group.size == 1:
        return finite
    bad = comm.all_reduce_((~finite).float().reshape(1), group)
    return bad[0] == 0


def checked(step, tensors: Sequence[torch.Tensor], group: comm.Group = comm.SOLO):
    """An eval step ``step(*inputs, label) -> (loss, logits)`` that also
    returns all_finite of the loss, the logits and `tensors` over `group`."""
    tensors = list(tensors)

    def fn(*args):
        loss, logits = step(*args)
        return loss, logits, all_finite([loss, logits, *tensors], group)

    return fn


def _tensors(output):
    if isinstance(output, torch.Tensor):
        return [output]
    if isinstance(output, (tuple, list)):
        return [t for t in output if isinstance(t, torch.Tensor)]
    return []


_NONE = 2 ** 62  # no rank saw a non-finite value


def _agreed(index: int, group: comm.Group) -> int:
    """The least of the ranks' indices."""
    return min(comm.all_gather_objects(index, group)) if group.size > 1 else index


def locate_non_finite(model: torch.nn.Module, inputs, label, train: bool,
                      group: comm.Group = comm.SOLO) -> str | None:
    """Where a step on (inputs, label) first makes a non-finite value, run
    eagerly with a forward hook on every module: "the output of module X",
    "the loss", "the gradient of parameter Y (module X)", or None where the
    forward and backward stay finite. Every rank of `group` runs it
    together and gets the same answer: the earliest that any rank saw."""
    order: list[str] = []  # the modules in the order their outputs arose
    first: list[int] = []  # the index in `order` of the first non-finite one

    def hook(name):
        def fn(module, args, output):
            order.append(name)
            if not first and any(not bool(torch.isfinite(t).all())
                                 for t in _tensors(output)):
                first.append(len(order) - 1)
        return fn

    handles = [m.register_forward_hook(hook(name or type(model).__name__))
               for name, m in model.named_modules()]
    try:
        with torch.enable_grad() if train else torch.inference_mode():
            logits = model(*inputs)
            loss = F.cross_entropy(logits, label)
            # the modules' outputs, then the loss (index len(order))
            seen = first[0] if first else len(order) if not bool(torch.isfinite(loss)) else _NONE
            seen = _agreed(seen, group)
            if seen < len(order):
                return f"the output of module {order[seen]}"
            if seen == len(order):
                return "the loss"
            if not train:
                return None
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True,
                                        materialize_grads=True)
            bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
            seen = _agreed(bad[0] if bad else _NONE, group)
            if seen < len(named):
                name = named[seen][0]
                owner = name.rpartition(".")[0] or type(model).__name__
                return f"the gradient of parameter {name} (module {owner})"
            return None
    finally:
        for h in handles:
            h.remove()


def non_finite_names(named_tensors, group: comm.Group = comm.SOLO) -> list[str]:
    """The names of the tensors that hold a non-finite value on any rank of
    `group`, in the order given."""
    names = [name for name, t in named_tensors if not bool(torch.isfinite(t).all())]
    if group.size == 1:
        return names
    seen = set().union(*comm.all_gather_objects(names, group))
    return [name for name, _ in named_tensors if name in seen]
