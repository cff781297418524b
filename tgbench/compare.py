"""The comparisons that decide `correct`.

Training (the first three steps of set-up, through the window's own call
and feed, against the reference's three SGD steps from the same weights on
the batches it assembles itself):
  * logit_gap_1: the first step's logits, as logit_gap below;
  * loss_gap: the largest |program - reference| / |reference| of the three
    steps' losses;
  * grad_gap: the first gradient as the optimiser gets it, by leaf:
    | |g_program| - |g_reference| | over the larger of |g_reference| and the
    median leaf's |g_reference|, the worst leaf;
  * change_gap: the parameters' change over the three steps, by leaf, the
    same measure; leaves whose first reference gradient is under a
    thousandth of the median leaf's are left out (they move by round-off
    alone: a bias before a training-mode BatchNorm has a gradient of 0).

Answers (evaluation scores), each compared with the
reference's logits of the same clip:
  * logit_gap: max |program - reference| over the largest |reference|.

The reference runs in float32 with TF32 off (`reference_numerics`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's first gradient


@contextlib.contextmanager
def reference_numerics():
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def loss_gap(program, reference) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """{leaf: gap of norms} over the leaves in `keep`: | |program| -
    |reference| | over the larger of |reference| and the median leaf's."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: _norm(reference[k]) for k in names}
    median = float(np.median(list(ref.values())))
    out = {}
    for k in names:
        gap = abs(_norm(program[k]) - ref[k]) / max(ref[k], median)
        out[k] = gap if np.isfinite(gap) else float("inf")
    return out


def worst(gaps: dict) -> tuple[float, str]:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median(gaps: dict) -> float:
    return float(np.median(list(gaps.values())))


def moved_leaves(first_grad: dict) -> set:
    norms = {k: _norm(v) for k, v in first_grad.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= EXCLUDE_BELOW * median}


def logit_gap(program: np.ndarray, reference: np.ndarray) -> float:
    program = np.asarray(program, np.float64)
    if program.shape != reference.shape or not np.isfinite(program).all():
        return float("inf")
    return float(np.abs(program - reference).max() / np.abs(reference).max())
