"""Model weights and training checkpoints as `.pt` files; weights from
elsewhere as `.npz`.

Counterpart of tamgcn_tpu/train/checkpoint.py (orbax there):

  * `load_weights` (--weights) takes four forms (`read_weights`): a `.pt`
    state dict that the port saved with `torch.save`, or one of the port's
    training checkpoints, whose model state it holds; a state dict of the
    reference, keys the reference's tensor names, as a `.pt` written by
    `torch.save(model.state_dict())` or as a `.npz`
    (tools/export_torch_weights.py writes it), imported for the configured
    model by utils/torch_import.py; a `.npz` of the JAX package's
    variables, keys "/"-joined Flax paths under `params/` and
    `batch_stats/` (tools/export_flax_npz.py writes it from a JAX training
    checkpoint), mapped by convert.from_flax. A `.npz` that mixes the two
    key forms raises;
  * a directory stands for the checkpoint in it that the JAX trainer would
    take from its own checkpoint directory (tamgcn_tpu/train/trainer.py:
    189-214): the port's `best.pt`, else the latest `epoch{n}.pt`. A
    directory without them (an orbax checkpoint: the port never reads
    orbax; the bridge script turns one into the Flax `.npz`) raises;
  * training checkpoints live under `<work_dir>/checkpoints/`: `best.pt`
    holds `{model, step}`, `epoch{n}.pt` holds `{model, optimizer, step}`,
    a resume point (train/trainer.py:_save_checkpoint, resume); the
    optimizer entry has torch.optim's state_dict layout
    (train/packing.py:PackedTrainState.optimizer_state_dict);
  * every tensor is written as a CPU copy in its own storage: a training
    model's tensors are views of the packed state's flat buffers, and
    `torch.save` of a view would write its whole buffer;
  * `--ignore_weights` filtering and the partial load with a report of
    missing/unexpected tensors follow the reference (torchlight
    io.py:57-90); a load that would leave more than half of the target
    module's tensors (those --ignore_weights does not drop) at their init
    raises (`partial_update`): weights of another model, or of a form the
    port does not recognise, never run quietly as a mostly random model.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_weights(model: torch.nn.Module, path: str) -> None:
    torch.save(_cpu_state(model), path)


FLAX_COLLECTIONS = ("params", "batch_stats")


def _checkpoint_in(directory: str) -> str:
    """The checkpoint that --weights takes from a directory: `best.pt`, else
    the latest `epoch{n}.pt` (the JAX trainer's preference in its checkpoint
    directory). A directory without them raises."""
    best = os.path.join(directory, "best.pt")
    if os.path.exists(best):
        return best
    latest = latest_epoch(directory)
    if latest is not None:
        return os.path.join(directory, f"epoch{latest}.pt")
    raise ValueError(
        f"--weights {directory!r} is a directory without the port's best.pt or "
        "epoch{n}.pt (an orbax checkpoint of the JAX trainer?): the port does "
        f"not read orbax; convert it with `python tools/export_flax_npz.py {directory} "
        "-c CONFIG -o weights.npz` and pass the .npz")


def _read_pt(path: str) -> dict:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    if not isinstance(state, dict):
        raise ValueError(f"{path} holds a {type(state).__name__}, not a state dict")
    return state


def _npz_form(path: str, keys: list) -> str:
    flax = [k.split("/", 1)[0] in FLAX_COLLECTIONS and "/" in k for k in keys]
    if all(flax) and keys:
        return "flax npz"
    if not any(flax):
        return "reference npz"
    raise ValueError(
        f"{path} mixes Flax-path keys ({keys[flax.index(True)]!r}) with reference "
        f"torch names ({keys[flax.index(False)]!r})")


def read_weights(path: str) -> tuple[str, dict, str]:
    """(form, contents, file) of `path`, where `file` is `path` or, for a
    directory, the checkpoint in it that --weights takes. The form is
    "pt" (the port's state dict or training checkpoint), "reference pt" (a
    `.pt` of reference torch names, utils/torch_import.py:reference_named),
    "reference npz" (reference torch names) or "flax npz" ("/"-joined Flax
    paths); the contents the `.pt` forms' state dict (tensors) or the
    `.npz` forms' arrays (numpy, by key). Raises on another suffix and on a
    `.npz` that mixes the two key forms."""
    from ..utils.torch_import import reference_named

    if os.path.isdir(path):
        path = _checkpoint_in(path)
    if path.endswith(".pt"):
        state = _read_pt(path)
        return ("reference pt" if reference_named(state) else "pt"), state, path
    if not path.endswith(".npz"):
        raise ValueError(f"--weights {path!r}: expected a .pt or a .npz file")
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    return _npz_form(path, list(arrays)), arrays, path


def flax_tree(arrays) -> dict:
    """{"params": ..., "batch_stats": ...} nested dicts from "/"-joined keys."""
    tree: dict = {}
    for key, value in arrays.items():
        *parents, leaf = key.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(value)
    return tree


def port_state(form: str, contents: dict, model_name: str | None = None,
               model: torch.nn.Module | None = None) -> dict:
    """The port's state dict, on the CPU, from read_weights' (form,
    contents); the reference and Flax forms are mapped onto `model` (the
    port's module registered as `model_name`, which a reference state dict
    needs)."""
    if form == "pt":
        return contents
    if model is None:
        raise ValueError(f"weights in the {form} form are mapped onto a model; pass "
                         "the model")
    if form == "flax npz":
        from ..convert import from_flax

        return from_flax(flax_tree(contents), model)
    from ..utils.torch_import import import_state_dict

    arrays = {k: np.asarray(v) for k, v in contents.items()}
    return import_state_dict(model_name, arrays, model)


def load_weights(path: str, model_name: str | None = None,
                 model: torch.nn.Module | None = None) -> dict:
    """The port's state dict from `path` in any form of `read_weights`
    (port_state)."""
    form, contents, _ = read_weights(path)
    return port_state(form, contents, model_name, model)


def filter_ignore(state: dict, ignore_keys) -> dict:
    """Drop tensors whose name contains any ignore key
    (reference torchlight io.py:68-77 --ignore_weights)."""
    return {k: v for k, v in state.items()
            if not any(ig in k for ig in ignore_keys or ())}


# a load that leaves more than this share of the target module's tensors at
# init raises (partial_update)
MAX_UNLOADED = 0.5


def partial_update(model: torch.nn.Module, state: dict, log=print,
                   ignore_keys=()) -> None:
    """Load the tensors of `state` that `model` has and report the rest
    (reference torchlight io.py:81-89 partial-load fallback). Raises, naming
    the first tensors it would not load, where more than MAX_UNLOADED of
    the model's tensors would keep their init; tensors named by
    `ignore_keys` (--ignore_weights, dropped from `state` on purpose) are
    not counted."""
    kept = [k for k in model.state_dict() if not any(ig in k for ig in ignore_keys or ())]
    unloaded = [k for k in kept if k not in state]
    if len(unloaded) > MAX_UNLOADED * len(kept):
        raise ValueError(
            f"the weights would load {len(kept) - len(unloaded)} of the "
            f"{len(kept)} tensors of {type(model).__name__} and leave the rest at "
            f"init (first not loaded: {', '.join(unloaded[:5])}); are they "
            "weights of another model, or reference names the importer does "
            "not know?")
    missing, unexpected = model.load_state_dict(state, strict=False)
    for k in missing:
        log(f"checkpoint missing weight: {k} (kept initialised value)")
    for k in unexpected:
        log(f"checkpoint has unexpected weight: {k} (ignored)")


class Checkpoints:
    """The training checkpoints of one work dir: `<directory>/<name>.pt`."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, name: str, model: torch.nn.Module, step: int,
             optimizer: dict | None = None, state: dict | None = None) -> None:
        """`optimizer`: an optimizer state_dict (CPU tensors), for a resume
        point; `state`: the model's state dict to write in place of its own
        (a tensor-parallel model's, its shards gathered)."""
        state = model.state_dict() if state is None else state
        tree = {"model": {k: v.detach().to("cpu", copy=True) for k, v in state.items()},
                "step": int(step)}
        if optimizer is not None:
            tree["optimizer"] = optimizer
        # write beside the target and rename: a crash never leaves half a file
        tmp = f"{self.path(name)}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(name))

    def load(self, name: str) -> dict:
        return torch.load(self.path(name), map_location="cpu", weights_only=True)

    def latest_epoch(self) -> int | None:
        return latest_epoch(self.directory)


def latest_epoch(directory: str) -> int | None:
    """The largest n of the `epoch{n}.pt` files in `directory`, or None."""
    epochs = [int(m.group(1)) for entry in os.listdir(directory)
              if (m := re.fullmatch(r"epoch(\d+)\.pt", entry))]
    return max(epochs, default=None)
