"""Model weights and training checkpoints as `.pt` files; weights from
elsewhere as `.npz`.

Counterpart of tamgcn_tpu/train/checkpoint.py (orbax there):

  * `load_weights` (--weights) takes three forms (`weights_form`): a `.pt`
    state dict that the port saved with `torch.save`, or one of the port's
    training checkpoints, whose model state it holds; a `.npz` of a
    reference torch state dict (tools/export_torch_weights.py writes it),
    keys the reference's tensor names, imported for the configured model
    by utils/torch_import.py; a `.npz` of the JAX package's variables, keys
    "/"-joined Flax paths under `params/` and `batch_stats/`
    (tools/export_flax_npz.py writes it from a JAX training checkpoint),
    mapped by convert.from_flax. A `.npz` that mixes the two key forms
    raises, and so does a directory (an orbax checkpoint: the port never
    reads orbax; the bridge script turns one into the Flax `.npz`);
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
    io.py:57-90).
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


def weights_form(path: str) -> str:
    """Which form `path` holds: "pt" (the port's state dict or training
    checkpoint), "reference npz" (reference torch names) or "flax npz"
    ("/"-joined Flax paths). Raises on a directory, another suffix and a
    `.npz` that mixes the two key forms."""
    if os.path.isdir(path):
        raise ValueError(
            f"--weights {path!r} is a directory (an orbax checkpoint of the JAX "
            "trainer?): the port does not read orbax; convert it with "
            "`python tools/export_flax_npz.py {path} -c CONFIG -o weights.npz` "
            "and pass the .npz")
    if path.endswith(".pt"):
        return "pt"
    if not path.endswith(".npz"):
        raise ValueError(f"--weights {path!r}: expected a .pt or a .npz file")
    with np.load(path) as arrays:
        keys = list(arrays.files)
    flax = [k.split("/", 1)[0] in FLAX_COLLECTIONS and "/" in k for k in keys]
    if all(flax) and keys:
        return "flax npz"
    if not any(flax):
        return "reference npz"
    raise ValueError(
        f"{path} mixes Flax-path keys ({keys[flax.index(True)]!r}) with reference "
        f"torch names ({keys[flax.index(False)]!r})")


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


def load_weights(path: str, model_name: str | None = None,
                 model: torch.nn.Module | None = None) -> dict:
    """The port's state dict from `path`, on the CPU, in any form of
    `weights_form`; the `.npz` forms are mapped onto `model` (the port's
    module registered as `model_name`, which a reference `.npz` needs)."""
    form = weights_form(path)
    if form != "pt":
        if model is None:
            raise ValueError(f"{path}: a .npz is mapped onto a model; pass the model")
        with np.load(path) as f:
            arrays = {k: f[k] for k in f.files}
        if form == "flax npz":
            from ..convert import from_flax

            return from_flax(flax_tree(arrays), model)
        from ..utils.torch_import import import_state_dict

        return import_state_dict(model_name, arrays, model)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    if not isinstance(state, dict):
        raise ValueError(f"{path} holds a {type(state).__name__}, not a state dict")
    return state


def filter_ignore(state: dict, ignore_keys) -> dict:
    """Drop tensors whose name contains any ignore key
    (reference torchlight io.py:68-77 --ignore_weights)."""
    return {k: v for k, v in state.items()
            if not any(ig in k for ig in ignore_keys or ())}


def partial_update(model: torch.nn.Module, state: dict, log=print) -> None:
    """Load the tensors of `state` that `model` has and report the rest
    (reference torchlight io.py:81-89 partial-load fallback)."""
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
             optimizer: dict | None = None) -> None:
        """`optimizer`: an optimizer state_dict (CPU tensors), for a resume
        point."""
        tree = {"model": _cpu_state(model), "step": int(step)}
        if optimizer is not None:
            tree["optimizer"] = optimizer
        # write beside the target and rename: a crash never leaves half a file
        tmp = f"{self.path(name)}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(name))

    def load(self, name: str) -> dict:
        return torch.load(self.path(name), map_location="cpu", weights_only=True)

    def latest_epoch(self) -> int | None:
        """The largest n of the `epoch{n}.pt` files, or None."""
        epochs = [int(m.group(1)) for entry in os.listdir(self.directory)
                  if (m := re.fullmatch(r"epoch(\d+)\.pt", entry))]
        return max(epochs, default=None)
