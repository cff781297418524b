"""Model weights as `.pt` state dicts.

Counterpart of tamgcn_tpu/train/checkpoint.py for the test phase: a weight
file is a state dict that the port saved with `torch.save` (for example
after `convert.from_flax`). `--ignore_weights` filtering and the partial
load with a report of missing/unexpected tensors follow the reference
(torchlight io.py:57-90). Checkpoints with optimizer state for resuming
training come with the training slice.
"""
from __future__ import annotations

import torch


def save_weights(model: torch.nn.Module, path: str) -> None:
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_weights(path: str) -> dict:
    """The state dict in a `.pt` file, on the CPU."""
    if not path.endswith(".pt"):
        raise NotImplementedError(
            f"--weights {path!r}: the port loads the .pt state dicts it saves; "
            "orbax checkpoints and reference .npz exports come with the "
            "training slice"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
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
