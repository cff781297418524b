"""Shared figure helpers (headless matplotlib).

A copy of tamgcn_tpu/viz.py. matplotlib is imported where a figure is
drawn; without it that call raises an ImportError naming it. Counterpart
of the reference ensemble script's rendered artifacts (reference
ensemble/ensemble_ctrgcn_resnet_eval.py:252-296 plot_confusion_matrix): a
side-by-side counts + row-normalised confusion heatmap saved as PNG, on
bare matplotlib (no seaborn).
"""
from __future__ import annotations

import numpy as np

# NW-UCLA short class names (reference eval :263-267)
NUCLA_SHORT_NAMES = [
    "Pick 1H", "Pick 2H", "Drop", "Walk", "Sit",
    "Stand", "Donning", "Doffing", "Throw", "Carry",
]


def pyplot():
    """matplotlib.pyplot on the headless Agg backend; raises ImportError
    naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figures need matplotlib, which is not installed "
                          "(pip install matplotlib)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _heatmap(ax, m, names, fmt, cmap, vmin=None, vmax=None):
    im = ax.imshow(m, cmap=cmap, vmin=vmin, vmax=vmax)
    n = m.shape[0]
    ax.set_xticks(range(n), names, rotation=45, ha="right")
    ax.set_yticks(range(n), names)
    thresh = (np.nanmax(m) + (vmin or 0)) / 2.0
    for i in range(n):
        for j in range(n):
            ax.text(
                j, i, format(m[i, j], fmt),
                ha="center", va="center", fontsize=8,
                color="white" if m[i, j] > thresh else "black",
            )
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    return im


def plot_confusion_matrix(
    scores: np.ndarray,
    labels: np.ndarray,
    title: str,
    output_path: str,
    class_names: list[str] | None = None,
) -> str:
    """Render counts + row-normalised confusion heatmaps for argmax(scores).

    Returns output_path. Matches the artifact set of the reference online
    ensemble script (confusion_matrix_*.png).
    """
    plt = pyplot()
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    preds = scores.argmax(axis=1)
    acc = float((preds == labels).mean())
    n_class = scores.shape[1]
    names = class_names or (
        NUCLA_SHORT_NAMES if n_class == len(NUCLA_SHORT_NAMES)
        else [str(i) for i in range(n_class)]
    )

    cm = np.zeros((n_class, n_class), np.int64)
    np.add.at(cm, (labels, preds), 1)
    cm_norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)

    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    _heatmap(axes[0], cm, names, "d", "Blues")
    axes[0].set_title(f"{title}\nCounts — Acc: {acc:.2%}")
    _heatmap(axes[1], cm_norm, names, ".2f", "Oranges", vmin=0.0, vmax=1.0)
    axes[1].set_title(f"{title}\nRow-normalised — Acc: {acc:.2%}")
    fig.tight_layout()
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path
