"""Online ensemble eval, two checkpoints to a fused report and figures:
counterpart of tools/ensemble_online_eval.py.

    python -m tamgcn_tpu_torch.tools.ensemble_online_eval \\
        --config_a configs/nucla/gcn.yaml    --weights_a work/gcn/checkpoints \\
        --config_b configs/nucla/resnet.yaml --weights_b work/resnet/checkpoints \\
        [--processor_b recognition_rgb_only] [--alpha 1.0] [--out_dir DIR] \\
        [--no-normalize] [--extra_a "FLAGS"] [--extra_b "FLAGS"]

Each side runs the port's trainer (`python -m tamgcn_tpu_torch <processor>
-c CONFIG --phase test --weights W`, its model registry, feeder, weight
forms and eval step; on the card unless `--use_gpu false` is among the
side's extra flags, given as one quoted string, e.g. --extra_a "--use_gpu
false --model_args base_channel=8"), so anything the port trains it
ensembles. It prints
per-model and fused accuracy with the reference script's alpha sweep and
per-class breakdown, and saves counts and row-normalised confusion
matrices for each model, the requested alpha and the best alpha
(viz.plot_confusion_matrix, which needs matplotlib).
"""
from __future__ import annotations

import argparse
import os
import shlex

import numpy as np

from ..ensemble import align_scores, fuse, per_class_report, top1
from ..viz import plot_confusion_matrix

# the reference script's fixed sweep grid (eval :428)
SWEEP_ALPHAS = (0.1, 0.2, 0.3, 0.5, 0.7, 1.0, 1.5, 2.0, 3.0)


def _eval_side(tag: str, config: str, weights: str, processor: str, out_dir: str,
               extra: list[str]):
    """Filename-keyed scores and labels of one model through the port's
    trainer."""
    from ..__main__ import _registry
    from ..train.config import base_parser, load_config

    registry = _registry()
    if processor not in registry:
        raise KeyError(f"unknown processor {processor!r}; have {sorted(registry)}")
    argv = ["-c", config, "--phase", "test", "--weights", weights,
            "--work_dir", os.path.join(out_dir, f"eval_{tag}"), "--print_log", "false",
            *(word for text in extra for word in shlex.split(text))]
    trainer = registry[processor](load_config(argv, parser=base_parser()))
    trainer.test_epoch()
    names = getattr(trainer.test_feeder, "sample_name", None)
    if names is None:
        names = [str(i) for i in range(len(trainer.result_scores))]
    scores = {str(n): s for n, s in zip(names, trainer.result_scores)}
    labels = {str(n): int(l) for n, l in zip(names, trainer.result_labels)}
    return scores, labels


def _report(title: str, scores: np.ndarray, y: np.ndarray):
    rep = per_class_report(scores, y)
    correct = int((scores.argmax(1) == y).sum())
    print(f"\n{title}: {rep['top1']:.2%} ({correct}/{len(y)})")
    for i, v in enumerate(rep["per_class_top1"]):
        print(f"  class {i}: {v:.2%}")
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config_a", required=True, help="model A config yaml")
    p.add_argument("--weights_a", required=True, help="model A weights (any form)")
    p.add_argument("--config_b", required=True, help="model B config yaml")
    p.add_argument("--weights_b", required=True, help="model B weights (any form)")
    p.add_argument("--processor_a", default="recognition")
    p.add_argument("--processor_b", default="recognition")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="fused = norm(A) + alpha * norm(B)")
    p.add_argument("--out_dir", default="./work_dir/ensemble")
    p.add_argument("--no-normalize", dest="normalize", action="store_false")
    p.add_argument("--extra_a", nargs="*", default=[],
                   help="extra trainer flags for side A, quoted")
    p.add_argument("--extra_b", nargs="*", default=[],
                   help="extra trainer flags for side B, quoted")
    arg = p.parse_args(argv)

    os.makedirs(arg.out_dir, exist_ok=True)
    print("=" * 60)
    print("  ONLINE ENSEMBLE EVAL")
    print(f"  A: {arg.config_a} @ {arg.weights_a} ({arg.processor_a})")
    print(f"  B: {arg.config_b} @ {arg.weights_b} ({arg.processor_b})")
    print(f"  alpha={arg.alpha}  out={arg.out_dir}")
    print("=" * 60)

    sa, la = _eval_side("a", arg.config_a, arg.weights_a, arg.processor_a,
                        arg.out_dir, arg.extra_a)
    sb, _ = _eval_side("b", arg.config_b, arg.weights_b, arg.processor_b,
                       arg.out_dir, arg.extra_b)
    # filename-keyed join (reference :358-380); labels from side A's feeder
    names, (ma, mb), y = align_scores([sa, sb], la)
    print(f"\ncommon samples: {len(names)}")

    _report("model A", ma, y)
    _report("model B", mb, y)
    plot_confusion_matrix(ma, y, "Model A",
                          os.path.join(arg.out_dir, "confusion_matrix_model_a.png"))
    plot_confusion_matrix(mb, y, "Model B",
                          os.path.join(arg.out_dir, "confusion_matrix_model_b.png"))

    fused = fuse(ma, mb, arg.alpha, arg.normalize)
    rep_f = _report(f"fused (alpha={arg.alpha})", fused, y)
    plot_confusion_matrix(
        fused, y, f"Ensemble (A + {arg.alpha} x B)",
        os.path.join(arg.out_dir, f"confusion_matrix_alpha_{arg.alpha}.png"))

    print(f"\n  {'alpha':<8}{'top-1':<10}")
    best_alpha, best_acc = arg.alpha, rep_f["top1"]
    for al in SWEEP_ALPHAS:
        acc = top1(fuse(ma, mb, al, arg.normalize), y)
        star = " *" if acc > best_acc else ""
        print(f"  {al:<8.1f}{acc:<10.2%}{star}")
        if acc > best_acc:
            best_alpha, best_acc = al, acc
    print(f"\nbest: alpha={best_alpha} top-1={best_acc:.2%}")
    if best_alpha != arg.alpha:
        plot_confusion_matrix(
            fuse(ma, mb, best_alpha, arg.normalize), y,
            f"Ensemble (A + {best_alpha} x B) - BEST",
            os.path.join(arg.out_dir, f"confusion_matrix_alpha_{best_alpha}_best.png"))
    print(f"figures saved to {arg.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
