"""Model weights and training checkpoints as `.pt` files.

Counterpart of tamgcn_tpu/train/checkpoint.py (orbax there):

  * a weight file is a state dict that the port saved with `torch.save`
    (for example after `convert.from_flax`), or one of the port's training
    checkpoints, whose model state it holds;
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

import torch


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_weights(model: torch.nn.Module, path: str) -> None:
    torch.save(_cpu_state(model), path)


def load_weights(path: str) -> dict:
    """The state dict in a `.pt` file (a saved state dict, or the model
    state of a training checkpoint), on the CPU."""
    if not path.endswith(".pt"):
        raise NotImplementedError(
            f"--weights {path!r}: the port loads the .pt state dicts and "
            "training checkpoints it saves; orbax checkpoints and reference "
            ".npz exports come with the slice of the weight importers"
        )
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
