"""Interpretability: gradient-based body-part importance and edge importance.

Counterpart of tamgcn_tpu/interpret.py, the analysis stage of reference
tools/train_stgcn_group.py:265-356: |d score_true / d input| summed over
(C, T, M) per joint, averaged into 5 body-part groups, normalised to max 1
per class; and models/stgcn.py:227-252 (edge importance per joint,
tamgcn_tpu_torch.models.edge_importance_per_joint). The input gradient is
one `torch.autograd.grad` per batch through the model in eval mode, on the
model's device.
"""
from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np
import torch

# NW-UCLA 20-joint body-part groups (reference tools/train_stgcn_group.py:272-278)
NUCLA_TARGET_JOINTS: dict[str, list[int]] = {
    "head": [2, 3],
    "l_hand": [4, 5, 6, 7],
    "r_hand": [8, 9, 10, 11],
    "l_leg": [12, 13, 14, 15],
    "r_leg": [16, 17, 18, 19],
}

# NW-UCLA 10 action names (reference tools/train_stgcn_group.py:45-56)
LABEL_NAMES_10 = [
    "Pick up with one hand", "Pick up with two hands", "Drop trash",
    "Walk around", "Sit down", "Stand up", "Donning", "Doffing",
    "Throw", "Carry",
]


def make_input_grad_fn(model: torch.nn.Module):
    """fn(data, label) -> |d score_true / d data| summed over (C, T, M):
    (B, V), for data (B, C, T, V, M) and label (B,) tensors on the model's
    device. The model is put in eval mode (its BatchNorm statistics are
    not touched)."""

    def joint_grads(data, label):
        model.eval()
        x = data.detach().requires_grad_(True)
        with torch.enable_grad():
            out = model(x)
            score = out.gather(1, label[:, None]).sum()
            (g,) = torch.autograd.grad(score, x)
        return g.abs().sum(dim=(1, 2, 4))

    return joint_grads


def gradient_body_part_importance(
    model: torch.nn.Module,
    loader,
    num_class: int,
    target_joints: Mapping[str, Sequence[int]] = NUCLA_TARGET_JOINTS,
    samples_per_class: int = 200,
) -> dict[int, dict[str, float]]:
    """Per-class body-part importance, normalised to max 1 per class
    (reference tools/train_stgcn_group.py:283-349), over the batches of
    `loader` (data first, label second to last) until every class has
    `samples_per_class` samples. The data are cast to the dtype of the
    model's parameters (float32, or float64 for a `.double()` model)."""
    joint_grads = make_input_grad_fn(model)
    param = next(model.parameters())
    class_grads: dict[int, dict[str, list[float]]] = {
        g: {p: [] for p in target_joints} for g in range(num_class)
    }
    counts = {g: 0 for g in range(num_class)}
    for batch in loader:
        if all(c >= samples_per_class for c in counts.values()):
            break
        data, label = batch[0], np.asarray(batch[-2])
        grads = joint_grads(torch.as_tensor(data).to(param.device, param.dtype),
                            torch.as_tensor(label, dtype=torch.int64).to(param.device))
        grads = grads.detach().cpu().numpy()
        for i, g in enumerate(label):
            g = int(g)
            if counts[g] >= samples_per_class:
                continue
            for part, joints in target_joints.items():
                class_grads[g][part].append(
                    float(np.mean([grads[i, j] for j in joints]))
                )
            counts[g] += 1

    final: dict[int, dict[str, float]] = {}
    for g in range(num_class):
        avg = {
            p: (float(np.mean(v)) if v else 0.0)
            for p, v in class_grads[g].items()
        }
        max_val = max(avg.values()) or 1.0
        final[g] = {p: v / max_val for p, v in avg.items()}
    return final


def save_weights_json(weights: dict, path: str) -> None:
    """{class: {part: weight}} as JSON with string keys (the layout the
    reference's ST-ROI weighting generator reads)."""
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in weights.items()}, f, indent=2)
