"""Tensor parallelism, the model's parallel wiring and the step's gradient sum.

Counterpart of tamgcn_tpu/parallel/sharded.py (:41-67). `DEFAULT_TP_RULES`
are the JAX package's rules, matched against a parameter's Flax path
("/fc/kernel"; convert.flax_param_paths) with the Flax layout's spec; a
rule's "model" dim becomes the torch dim it splits (a Flax kernel is the
transposed torch weight):

  * `fc` (the classifier head) column-parallel: each rank holds its rows of
    the weight and the bias, and its logits are all-gathered;
  * the fusion model's `attention_transform_dense1` column-parallel (its
    hidden features all-gathered before the replicated BatchNorm) and
    `attention_transform_dense2` row-parallel (each rank multiplies its
    columns by its slice of the hidden features; the partial outputs are
    all-reduced and the replicated bias added).

A split layer becomes a `ShardedLinear` under the same name, so each rank's
parameters, and so its optimiser state and momentum, hold its shard only.
A dimension that the model size does not divide raises, as JAX's
device_put does. `full_state_dict` gathers the shards for a checkpoint,
`load_full_state` slices a full state dict into a sharded model.

`parallelize(model, mesh, graph_partition, sequence_parallel)` wires a model
to the grid, as the JAX trainer does with model_args and shardings
(trainer.py:152-156, 315-317, 486-507): BatchNorm statistics over the data
group (over the whole world for the BatchNorms that see time-sharded frames
under --sequence_parallel, where the model group holds the clip's other
frames), the ring's group in each ring op, the rules above where the model
size is > 1 (in every mode, as the JAX trainer applies them), the
time-sharded skeleton networks under --sequence_parallel
(parallel/sequence.py, which names what sees their frames in
`model.time_sharded`).

`GradientSum` is the step's reduction: one all-reduce of each flat gradient
buffer over the data group, the loss being each rank's sum over its rows
divided by the global batch; where the model group has more than one rank,
one more, over the model group, of the replicated parameters' gradients
(all but the split ones): where the parameter sees time-sharded frames
(`model.time_sharded`) each rank's share, used on its frames only, summed;
otherwise (every parameter outside --sequence_parallel, and under it the
head, the RGB trunk and the fusion's attention MLP, which see the whole
batch slice on every rank) the mean of the ranks' copies of one gradient. Those copies are equal in exact arithmetic, but not bit for bit
where the card's kernels sum in another order on each rank (cuDNN's
weight gradients, for one), and without the mean each rank's copy of the
parameters drifts from the others' step by step, as JAX's one replicated
array cannot.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from . import comm
from .mesh import MODEL_AXIS, Mesh

# (regex on the Flax path, spec in the Flax layout), first match wins
DEFAULT_TP_RULES: tuple = (
    (r".*/fc/kernel$", (None, MODEL_AXIS)),
    (r".*/fc/bias$", (MODEL_AXIS,)),
    (r".*/attention_transform_dense1/kernel$", (None, MODEL_AXIS)),
    (r".*/attention_transform_dense1/bias$", (MODEL_AXIS,)),
    (r".*/attention_transform_dense2/kernel$", (MODEL_AXIS, None)),
)


def param_shardings(model: nn.Module, rules=DEFAULT_TP_RULES) -> dict:
    """{port parameter name: the torch dim split over the model axis, or None
    (replicated)}: the first matching rule of the parameter's Flax path."""
    from ..convert import flax_param_paths

    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out = {}
    for name, path in flax_param_paths(model).items():
        out[name] = None
        for pat, spec in compiled:
            if pat.match("/" + path):
                dim = spec.index(MODEL_AXIS)
                out[name] = len(spec) - 1 - dim if len(spec) == 2 else dim
                break
    return out


class ShardedLinear(nn.Module):
    """A Linear split over a model group: `split` 0 (column-parallel: rows
    of the weight and of the bias; the output all-gathered) or 1
    (row-parallel: columns of the weight, the input sliced, the partial
    outputs all-reduced, the bias replicated)."""

    sharded = True

    def __init__(self, linear: nn.Linear, split: int, group: comm.Group):
        super().__init__()
        k = group.size
        for what, size in (("out", linear.out_features), ("in", linear.in_features)):
            if (what == "out") == (split == 0) and size % k:
                raise ValueError(f"{what}_features={size} of a layer split over "
                                 f"model_parallel={k} is not divisible by it")
        self.split, self.group = split, group
        with torch.no_grad():
            w = linear.weight.chunk(k, dim=split)[group.rank].clone()
            b = linear.bias.chunk(k)[group.rank].clone() if split == 0 else linear.bias.clone()
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.out_features, self.in_features = linear.out_features, linear.in_features

    def shard_dims(self) -> dict:
        """{tensor name: the dim split over the group, or None}."""
        return {"weight": self.split, "bias": 0 if self.split == 0 else None}

    def forward(self, x, dtype=None):
        w, b = self.weight, self.bias
        if dtype is not None:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        if self.split == 0:
            return comm.gather(F.linear(comm.copy_to(x, self.group), w) + b, self.group, -1)
        y = F.linear(comm.scatter(x, self.group, -1), w)
        return comm.reduce_from(y, self.group) + b

    def extra_repr(self) -> str:
        kind = "column" if self.split == 0 else "row"
        return (f"{self.in_features} -> {self.out_features}, {kind}-parallel over "
                f"{self.group.size} ranks")


def linear(layer, x, dtype=None):
    """x @ layer.weight^T + layer.bias, with a compute dtype as a Flax Dense
    with `dtype` (input, weight and bias cast, the product rounded, then the
    bias added), through the layer's own forward where it is sharded."""
    if getattr(layer, "sharded", False):
        return layer(x, dtype)
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def shard_tensor_parallel(model: nn.Module, group: comm.Group, rules=DEFAULT_TP_RULES):
    """Replace each Linear that the rules split by a ShardedLinear."""
    dims = param_shardings(model, rules)
    for name, dim in dims.items():
        owner, _, leaf = name.rpartition(".")
        if dim is None or leaf != "weight":
            continue
        layer = model.get_submodule(owner)
        if not isinstance(layer, nn.Linear):
            raise TypeError(f"{owner}: a tensor-parallel rule matches a "
                            f"{type(layer).__name__}, not a Linear")
        parent, _, attr = owner.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr,
                ShardedLinear(layer, dim, group))


def sharded_dims(model: nn.Module) -> dict:
    """{state-dict name: dim split over the model group} of a model's
    ShardedLinear tensors."""
    out = {}
    for owner, m in model.named_modules():
        if isinstance(m, ShardedLinear):
            for leaf, dim in m.shard_dims().items():
                if dim is not None:
                    out[f"{owner}.{leaf}"] = (dim, m.group)
    return out


def full_state_dict(model: nn.Module) -> dict:
    """The model's state dict with every shard gathered (what a checkpoint
    holds, so that one process loads it)."""
    state = model.state_dict()
    for name, (dim, group) in sharded_dims(model).items():
        state[name] = comm.all_gather(state[name], group, dim)
    return state


def shard_full_state(model: nn.Module, state: dict) -> dict:
    """A full state dict with the model's sharded tensors sliced to its
    shards."""
    state = dict(state)
    for name, (dim, group) in sharded_dims(model).items():
        if name in state:
            state[name] = state[name].chunk(group.size, dim=dim)[group.rank].clone()
    return state


def load_full_state(model: nn.Module, state: dict) -> None:
    model.load_state_dict(shard_full_state(model, state))


def _param_dims(model: nn.Module) -> list:
    dims = sharded_dims(model)
    return [dims.get(name) for name, _ in model.named_parameters()]


def full_optimizer_state(tree: dict, model: nn.Module) -> dict:
    """An optimizer_state_dict (train/packing.py) with the shards of the
    sharded parameters' states gathered."""
    for i, dim in enumerate(_param_dims(model)):
        if dim is not None:
            for key, t in tree["state"].get(i, {}).items():
                if t.ndim:
                    tree["state"][i][key] = comm.all_gather(t, dim[1], dim[0]).cpu()
    return tree


def shard_optimizer_state(tree: dict, model: nn.Module) -> dict:
    """A full optimizer state dict sliced to the sharded parameters' shards."""
    for i, dim in enumerate(_param_dims(model)):
        if dim is not None:
            for key, t in tree["state"].get(i, {}).items():
                if torch.as_tensor(t).ndim:
                    tree["state"][i][key] = torch.as_tensor(t).chunk(
                        dim[1].size, dim=dim[0])[dim[1].rank].clone()
    return tree


def parallelize(model: nn.Module, mesh: Mesh, graph_partition: str = "none",
                sequence_parallel: bool = False) -> nn.Module:
    """Wire `model` to the grid in place (module docstring); returns it."""
    from ..ops.norm import BatchNorm

    if sequence_parallel and graph_partition not in ("none", None):
        raise ValueError(
            "--sequence_parallel and --graph_partition are mutually exclusive: both "
            "shard over the mesh's 'model' axis (sp shards time, the ring shards "
            "joints). Drop one.")
    if graph_partition not in ("none", None):
        if not hasattr(model, "set_ring"):
            raise ValueError(f"graph_partition={graph_partition!r}: "
                             f"{type(model).__name__} has no joint ring")
        model.set_ring(mesh.model)
    if mesh.shape[MODEL_AXIS] > 1:
        shard_tensor_parallel(model, mesh.model)
    model.time_sharded = frozenset()
    if sequence_parallel:
        from .sequence import enable

        enable(model, mesh)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.world if name in model.time_sharded else mesh.data
    model.mesh = mesh
    model.sequence_parallel = bool(sequence_parallel)
    return model


class GradientSum:
    """The step's gradient reduction over the grid for a PackedTrainState
    (module docstring)."""

    def __init__(self, state, mesh: Mesh, sequence_parallel: bool):
        self.mesh = mesh
        self.data = mesh.data if mesh.data.size > 1 else None
        self.summed, self.averaged = [], []  # views of the replicated gradients
        if mesh.model.size > 1:
            split = set(sharded_dims(state.model))
            shares = getattr(state.model, "time_sharded", ()) if sequence_parallel else ()
            # runs of consecutive replicated parameters of one kind in each
            # flat buffer: (summed, group, start, end)
            runs = []
            for name, (g, o, n) in sorted(zip(state.param_names, state.params.slots),
                                          key=lambda item: item[1][:2]):
                if name in split:
                    continue
                summed = name in shares
                if runs and runs[-1][:2] == [summed, g] and runs[-1][3] == o:
                    runs[-1][3] = o + n
                else:
                    runs.append([summed, g, o, o + n])
            for summed, g, a, b in runs:
                (self.summed if summed else self.averaged).append(state.grads[g][a:b])

    def __call__(self, grads) -> None:
        if self.data is not None:
            for g in grads:
                comm.all_reduce_(g, self.data)
        for view in self.summed + self.averaged:
            comm.all_reduce_(view, self.mesh.model)
        for view in self.averaged:
            view.mul_(1.0 / self.mesh.model.size)
