"""Faults planted under a run's timed path, to show that the check can fail.
Used by the tests and by tools/readings.py; a benchmark run plants none.

  * state_unchanged: the train step returns its state as it found it;
  * half_batch: half of each batch is left out, and the mean (training) or
    the answers (evaluation) come from the other half;
  * answer_altered: the first answer of each batch is altered where it is
    produced (its logits reversed).
"""
from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _reverse_first(logits):
    logits = logits.clone()
    logits[0] = logits[0].flip(-1)
    return logits


def plant(fault: str, target) -> None:
    """Plant `fault` in a trainer whose steps are built (before their first
    call)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "answer_altered":
        target.model.register_forward_hook(lambda mod, inp, out: _reverse_first(out))
        return
    steps = target.steps
    for name, step in list(steps.items()):
        if fault == "state_unchanged" and name == "train":
            tensors = target.state.tensors()

            def unchanged(*args, step=step, tensors=tensors):
                saved = [t.clone() for t in tensors]
                out = step(*args)
                for t, s in zip(tensors, saved):
                    t.copy_(s)
                return out

            steps[name] = unchanged
        elif fault == "half_batch":
            def half(*args, step=step, name=name):
                *inputs, label = args
                h = label.shape[0] // 2
                out = step(*[a[:h] for a in inputs], label[:h])
                if name == "train":
                    return out
                loss, logits = out[0], out[1]
                return (loss, torch.cat([logits, logits])[:label.shape[0]], *out[2:])

            steps[name] = half
