"""Offline score-level ensemble evaluation: counterpart of tools/ensemble_eval.py.

    python -m tamgcn_tpu_torch.tools.ensemble_eval --scores_a resnet.pkl \\
        --scores_b ctrgcn.pkl [--alpha 1.0 | --sweep] [--no-normalize] [--labels L.pkl]

Fuses two score pickles of the trainer (`test_result*.pkl`, {sample name:
scores}) as `a + alpha * b` on softmax-normalised scores (reference
ensemble/ensemble_resnet_ctrgcn.py), with an alpha sweep and per-class
reports (ensemble/ensemble_ctrgcn_resnet_eval.py:399-474). The labels come
from --labels ({name: label}) or the NW-UCLA val split. Numpy only: it
runs anywhere.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..ensemble import (align_scores, alpha_sweep, fuse, load_scores, nucla_val_labels,
                        per_class_report, top1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="score-level ensemble eval")
    p.add_argument("--scores_a", required=True, help="first model score pkl")
    p.add_argument("--scores_b", required=True, help="second model score pkl")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--sweep", action="store_true", help="sweep alpha 0.1..3.0")
    p.add_argument("--no-normalize", dest="normalize", action="store_false")
    p.add_argument("--labels", default=None,
                   help="optional label pkl {name: label}; default NW-UCLA val")
    arg = p.parse_args(argv)

    if arg.labels:
        with open(arg.labels, "rb") as f:
            labels = {str(k): int(v) for k, v in pickle.load(f).items()}
    else:
        labels = nucla_val_labels()

    names, (ma, mb), y = align_scores([load_scores(arg.scores_a),
                                       load_scores(arg.scores_b)], labels)
    print(f"{len(names)} common samples")
    print(f"model A top-1: {top1(ma, y):.2%}")
    print(f"model B top-1: {top1(mb, y):.2%}")
    if arg.sweep:
        best_alpha, best, results = alpha_sweep(ma, mb, y, normalize=arg.normalize)
        for al in sorted(results):
            print(f"  alpha={al:.1f}: {results[al]:.2%}")
        print(f"best: alpha={best_alpha:.1f} top-1={best:.2%}")
        alpha = best_alpha
    else:
        alpha = arg.alpha
    rep = per_class_report(fuse(ma, mb, alpha, arg.normalize), y)
    print(f"fused (alpha={alpha:.2f}) top-1: {rep['top1']:.2%}")
    print("per-class:", [f"{v:.2%}" for v in rep["per_class_top1"]])
    print("confusion:\n", np.asarray(rep["confusion"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
