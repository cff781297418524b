"""Packed train state and the fused train step: flat buffers, flat optimiser.

Counterpart of tamgcn_tpu/train/packing.py. A CTR-GCN's training state is
~600 small tensors (284 parameters at the NW-UCLA config, their gradients,
their momentum, 92 BatchNorm statistics). A step that keeps that structure
pays a fixed host cost for each of them, and a per-parameter optimiser
chain launches several kernels per parameter. So, as the JAX package does:

  * `PackedTrainState` moves the model's parameters, their gradients, its
    buffers (the BatchNorm statistics) and the optimiser's state into one
    flat buffer each per dtype; every parameter, `.grad` and buffer of the
    model becomes a view into its buffer. Whatever writes a parameter in
    place (`load_state_dict`, the optimiser, a checkpoint restore) writes
    the flat buffer, and a CUDA graph captured on these addresses reads
    the new values (train/graphs.py);
  * `make_fused_train_step` runs the forward, the mean cross-entropy, the
    backward gathered into the flat gradient (one multi-tensor copy)
    and the optimiser (train/optim.py) as a few elementwise passes over the
    flat buffers, with the lr from a 0-d tensor: no host read, so the step
    can be captured whole;
  * the state holds a device step counter (`step`, 0-d int64) and the run
    seed: a model with a dropout site (ops/dropout.py) draws each step's
    masks from (seed, step) inside the step, which then advances the
    counter, as the JAX step folds `pstate.step` into its dropout rng and
    increments it (tamgcn_tpu/train/packing.py:187); a CUDA graph of the
    step reads the counter at each replay, so each replay draws fresh
    masks. A model without dropout runs the step without the counter;
  * `freeze_mask_for` is the flat 0/1 mask of the parameters named by path
    prefixes, which multiplies the optimiser's update, as JAX's `updates *
    freeze_mask` does: a frozen parameter gets no update and no weight
    decay, and its momentum still advances.

On a grid of ranks (`mesh`, parallel/mesh.py) the step is the one of the
global batch: each rank's loss is its rows' mean cross-entropy over the
data size, `reduce` (parallel/sharded.py:GradientSum) sums the flat
gradient over the grid after the backward and before the optimiser, the
reported loss and hits are the global batch's, and the dropout stream
keys each mask on the sample's global row.

The JAX package pads its flat buffer to a multiple of 1024 (a TPU vreg
layout); that padding is not ported. Here each slot starts 512-byte
aligned, as a tensor of its own would (the kernels' wrappers require 16).
Checkpoints keep the port's `.pt` format: `state_dict`s of the model and
the optimiser, each tensor in its own storage (train/checkpoint.py), never
the flat buffers.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..convert import flax_param_paths
from ..ops import dropout
from .optim import make_optimizer


# every slot starts on a multiple of 512 bytes, as the caching allocator
# aligns a tensor of its own: the kernels' vector loads need 16 bytes, and
# the library kernels pick their designs by alignment too
ALIGN_BYTES = 512


def _layout(tensors: Sequence[torch.Tensor]):
    """(dtypes, sizes, slots): one flat buffer per dtype in order of first
    appearance, `sizes` elements long; slot i = (buffer index, offset,
    numel) of tensors[i], its offset ALIGN_BYTES-aligned. The gaps between
    slots are zero and stay zero."""
    dtypes, sizes, slots = [], [], []
    for t in tensors:
        if t.dtype not in dtypes:
            dtypes.append(t.dtype)
            sizes.append(0)
        g = dtypes.index(t.dtype)
        align = max(1, ALIGN_BYTES // t.element_size())
        offset = -(-sizes[g] // align) * align
        slots.append((g, offset, t.numel()))
        sizes[g] = offset + t.numel()
    return dtypes, sizes, slots


class FlatGroup:
    """Tensors moved into one flat buffer per dtype (`flats`); each tensor's
    `.data` becomes a view of its slot, so the tensor objects the model
    holds stay the same and read and write the buffer."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.tensors = list(tensors)
        devices = {t.device for t in self.tensors}
        if len(devices) > 1:
            raise ValueError(f"cannot pack tensors on several devices: {devices}")
        device = devices.pop() if devices else torch.device("cpu")
        self.dtypes, sizes, self.slots = _layout(self.tensors)
        self.flats = [torch.zeros(n, dtype=dt, device=device)
                      for dt, n in zip(self.dtypes, sizes)]
        with torch.no_grad():
            for t, view in zip(self.tensors, self.views(self.flats)):
                view.copy_(t)
                t.data = view

    def views(self, flats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor's slot as a view into `flats` (this layout)."""
        return [flats[g][o:o + n].view(t.shape)
                for t, (g, o, n) in zip(self.tensors, self.slots)]

    def packed(self) -> bool:
        """Whether every tensor still views its slot (a `.to()` or
        `.double()` of the model gives its tensors new storage)."""
        return all(t.data_ptr() == v.data_ptr() and t.dtype == v.dtype
                   for t, v in zip(self.tensors, self.views(self.flats)))


def freeze_mask_for(model: torch.nn.Module, prefixes: Sequence[str]):
    """The flat 0/1 masks (one per parameter dtype, in the layout of
    `PackedTrainState`) that are 0 where a parameter's Flax path
    (convert.flax_param_paths: "l1/gcn1/conv3/kernel") starts with any of
    `prefixes`, as JAX's freeze_mask_for matches its "/"-joined paths (so
    "l1" also names l10); None without prefixes."""
    if not prefixes:
        return None
    paths = flax_param_paths(model)
    named = list(model.named_parameters())
    dtypes, sizes, slots = _layout([p for _, p in named])
    device = named[0][1].device
    masks = [torch.ones(n, dtype=dt, device=device) for dt, n in zip(dtypes, sizes)]
    for (name, _), (g, o, n) in zip(named, slots):
        if paths[name].startswith(tuple(prefixes)):
            masks[g][o:o + n] = 0
    return masks


class PackedTrainState:
    """The model's parameters, gradients and buffers and the optimiser's
    state (train/optim.py, `optimizer` "SGD" or "Adam") as flat buffers, one
    per dtype; the lr as a 0-d tensor per parameter dtype on their device.
    `freeze_prefixes` names the frozen parameters (freeze_mask_for). `step`
    counts the train steps taken on the device (the dropout stream's step,
    advanced by the step where the model `draws` masks); `seed` keys the
    stream."""

    def __init__(self, model: torch.nn.Module, optimizer: str = "SGD", *,
                 nesterov: bool = True, weight_decay: float = 1e-4,
                 freeze_prefixes: Sequence[str] = (), seed: int = 0, mesh=None):
        self.model = model
        self.mesh = mesh  # the grid of ranks, None for one process
        self.reduce = None  # the gradient sum over the grid (GradientSum)
        named = list(model.named_parameters())
        self.param_names = [n for n, _ in named]
        self.params = FlatGroup([p for _, p in named])
        self.grads = [torch.zeros_like(f) for f in self.params.flats]
        grad_views = self.params.views(self.grads)
        for p, g in zip(self.params.tensors, grad_views):
            p.grad = g
        self._grad_slots = [g.view(-1) for g in grad_views]
        self.stats = FlatGroup([b for _, b in model.named_buffers()])
        self.optimizer = make_optimizer(optimizer, self.params.flats,
                                        nesterov=nesterov, weight_decay=weight_decay)
        self.freeze_mask = freeze_mask_for(model, freeze_prefixes)
        self.lrs = [torch.zeros((), dtype=f.dtype, device=f.device)
                    for f in self.params.flats]
        self.lr = None
        self.seed = seed
        self.draws = dropout.draws(model)
        self.step = torch.zeros((), dtype=torch.int64, device=self.params.flats[0].device)

    def set_step(self, step: int) -> None:
        """Write the train step into the device counter (a resume)."""
        self.step.fill_(step)

    def dropout_stream(self, rows: int | None = None):
        """The dropout stream of the step the counter stands at, for a
        forward of `rows` samples (this rank's rows of the global batch)."""
        row0 = self.mesh.data_index * rows if self.mesh is not None and rows else 0
        return dropout.stream(self.seed, self.step, row0=row0, rows=rows)

    def set_lr(self, lr: float) -> None:
        """Write `lr` into the lr tensors (only where it changed: no launch
        on most steps); nothing reads it back."""
        if lr != self.lr:
            for t in self.lrs:
                t.fill_(lr)
            self.lr = lr

    def tensors(self) -> list[torch.Tensor]:
        """Every flat buffer a step writes: parameters, gradients, buffers,
        optimiser state, and the step counter where the model draws masks."""
        opt = [t for name in self.optimizer.state_names
               for t in self.optimizer.state[name]]
        step = [self.step] if self.draws else []
        return self.params.flats + self.grads + self.stats.flats + opt + step

    def check(self) -> None:
        """Raise where a parameter, gradient or buffer no longer views its
        flat buffer: the step would update the buffers and not the model."""
        grads = self.params.views(self.grads)
        if not (self.params.packed() and self.stats.packed() and all(
                p.grad is not None and p.grad.data_ptr() == g.data_ptr()
                for p, g in zip(self.params.tensors, grads))):
            raise RuntimeError(
                "the model's parameters, gradients or buffers no longer view the "
                "packed train state (moved or cast after packing); pack the model "
                "where it trains")

    def gather_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """The gradient of each parameter (in parameter order) into its slot
        of the flat gradient buffers: one multi-tensor copy of 1-D tensors
        (a gradient in another memory format, such as a convolution's in
        channels_last, is made contiguous first; with one such tensor in
        the list the multi-tensor copy would copy them all one by one)."""
        torch._foreach_copy_(self._grad_slots, [g.reshape(-1) for g in grads])

    def update(self) -> None:
        """The optimiser's step on the flat buffers, the freeze mask applied
        to its update."""
        masks = self.freeze_mask or [None] * len(self.params.flats)
        self.optimizer.update(self.params.flats, self.grads, self.lrs, masks)

    # -- checkpoints (the port's .pt format: a tensor per parameter) --------

    def optimizer_state_dict(self) -> dict:
        """torch.optim's state_dict layout: {"state": {i: {name: tensor}},
        "param_groups": [...]}, parameter i of model.named_parameters(), each
        tensor a CPU copy in its own storage."""
        state = {}
        for i, (g, o, n) in enumerate(self.params.slots):
            shape = self.params.tensors[i].shape
            entry = {}
            for name in self.optimizer.state_names:
                flat = self.optimizer.state[name][g]
                view = flat if flat.ndim == 0 else flat[o:o + n].view(shape)
                entry[name] = view.detach().to("cpu", copy=True)
            state[i] = entry
        group = dict(self.optimizer.hyperparameters(), lr=self.lr,
                     params=list(range(len(self.param_names))))
        return {"state": state, "param_groups": [group]}

    @torch.no_grad()
    def load_optimizer_state_dict(self, tree: dict) -> None:
        """Copy an optimizer_state_dict (or a torch.optim state_dict of the
        same parameters) into the flat buffers in place; a state the dict
        lacks (no step taken) is zero."""
        n_params = len(self.param_names)
        if len(tree["param_groups"][0]["params"]) != n_params:
            raise ValueError(f"optimizer state of {len(tree['param_groups'][0]['params'])} "
                             f"parameters for a model of {n_params}")
        for name in self.optimizer.state_names:
            for f in self.optimizer.state[name]:
                f.zero_()
        for i, (g, o, n) in enumerate(self.params.slots):
            for name, value in tree["state"].get(i, {}).items():
                if name not in self.optimizer.state_names:
                    raise KeyError(f"optimizer state {name!r} is not "
                                   f"{type(self.optimizer).__name__}'s")
                flat = self.optimizer.state[name][g]
                view = flat if flat.ndim == 0 else flat[o:o + n]
                view.copy_(torch.as_tensor(value).reshape(view.shape))


def make_fused_train_step(state: PackedTrainState, check_finite: bool = False) -> Callable:
    """``step(*inputs, label) -> (loss, hits)``: the model's forward (in the
    mode the model is in), the mean cross-entropy, the backward into the
    flat gradient, the optimiser's update of the flat state in place and
    the BatchNorm statistics updated in place; `hits` counts the argmax
    matches. The lr is `state`'s lr tensor (PackedTrainState.set_lr before
    the step). No host read: a CUDA graph can capture it (train/graphs.py).
    With `check_finite` (--debug_nans) it returns ``(loss, hits, finite)``,
    `finite` whether the loss, the logits, the flat gradient, parameters and
    statistics are all finite after the step on every rank of the grid
    (train/debug_nans.py)."""
    from ..parallel import comm
    from .debug_nans import all_finite

    model = state.model
    params = state.params.tensors
    data = state.mesh.data if state.mesh is not None else comm.SOLO
    world = state.mesh.world if state.mesh is not None else comm.SOLO

    def train_step(*args):
        *inputs, label = args
        with state.dropout_stream(rows=label.shape[0]):
            logits = model(*inputs)
        loss = F.cross_entropy(logits, label)
        # each rank's share of the global batch's mean
        grads = torch.autograd.grad(loss / data.size if data.size > 1 else loss, params,
                                    allow_unused=True, materialize_grads=True)
        state.gather_grads(grads)
        if state.reduce is not None:
            state.reduce(state.grads)
        state.update()
        if state.draws:
            state.step.add_(1)
        hits = (logits.detach().argmax(-1) == label).sum()
        if data.size > 1:
            both = comm.all_reduce_(torch.stack([loss.detach() / data.size,
                                                 hits.to(loss.dtype)]), data)
            loss, hits = both[0], both[1].round().long()
        if not check_finite:
            return loss.detach(), hits
        # one verdict on every rank of a grid
        return loss.detach(), hits, all_finite(
            [loss.detach(), logits.detach(), *state.grads, *state.params.flats,
             *state.stats.flats], world)

    return train_step
