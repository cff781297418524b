"""Score-level ensembling of model outputs.

A copy of tamgcn_tpu/ensemble.py (numpy only). Capability parity with
reference ensemble/ensemble_resnet_ctrgcn.py
(weighted fusion `resnet + alpha * ctrgcn` of per-sample score pickles,
:11-64) and the evaluation side of ensemble/ensemble_ctrgcn_resnet_eval.py
(softmax-normalised fusion :399-408, alpha sweep :422-438, per-class
reports :217-295). Consumes the score pickles the trainer exports
(test_result*.pkl: {sample_name: score_vector}).
"""
from __future__ import annotations

import pickle
from typing import Mapping, Sequence

import numpy as np

from .data.transforms import confusion_matrix, top_k_by_category


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    z = x - x.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def load_scores(path: str) -> dict[str, np.ndarray]:
    """Load a trainer-exported score pickle {sample_name: scores}."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):
        return {str(k): np.asarray(v) for k, v in obj.items()}
    return {str(i): np.asarray(v) for i, v in enumerate(obj)}


def align_scores(
    score_maps: Sequence[Mapping[str, np.ndarray]],
    labels: Mapping[str, int],
) -> tuple[list[str], list[np.ndarray], np.ndarray]:
    """Intersect sample keys across models; returns (names, per-model score
    matrices, label vector). Mirrors the filename-keyed alignment of
    reference ensemble_ctrgcn_resnet_eval.py:147-214."""
    keys = set(labels)
    for m in score_maps:
        keys &= set(m)
    names = sorted(keys)
    if not names:
        raise ValueError("no common samples between score files and labels")
    mats = [np.stack([np.asarray(m[k]) for k in names]) for m in score_maps]
    y = np.asarray([labels[k] for k in names])
    return names, mats, y


def fuse(
    scores_a: np.ndarray,
    scores_b: np.ndarray,
    alpha: float = 1.0,
    normalize: bool = True,
) -> np.ndarray:
    """fused = a + alpha * b, optionally on softmax-normalised scores
    (reference ensemble_resnet_ctrgcn.py:52 / eval :399-408)."""
    if normalize:
        scores_a, scores_b = softmax(scores_a), softmax(scores_b)
    return scores_a + alpha * scores_b


def top1(scores: np.ndarray, y: np.ndarray) -> float:
    return float((scores.argmax(axis=1) == y).mean())


def alpha_sweep(
    scores_a: np.ndarray,
    scores_b: np.ndarray,
    y: np.ndarray,
    alphas: Sequence[float] = tuple(np.arange(0.1, 3.01, 0.1)),
    normalize: bool = True,
) -> tuple[float, float, dict[float, float]]:
    """Sweep alpha; returns (best_alpha, best_top1, {alpha: top1})
    (reference ensemble_ctrgcn_resnet_eval.py:422-438)."""
    results = {
        float(a): top1(fuse(scores_a, scores_b, a, normalize), y) for a in alphas
    }
    best_alpha = max(results, key=results.get)
    return best_alpha, results[best_alpha], results


def per_class_report(scores: np.ndarray, y: np.ndarray) -> dict:
    """Per-class accuracy + confusion matrix (reference eval :217-295)."""
    return {
        "top1": top1(scores, y),
        "per_class_top1": top_k_by_category(y, scores, 1),
        "confusion": confusion_matrix(y, scores),
    }


def nucla_val_labels() -> dict[str, int]:
    """{file_name: 0-based label} for the NW-UCLA val split."""
    from .data.splits import load_nucla_split

    return {d["file_name"]: int(d["label"]) - 1 for d in load_nucla_split("val")}
