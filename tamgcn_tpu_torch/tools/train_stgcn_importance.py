"""ST-GCN training and gradient-based body-part importance extraction.

Counterpart of tools/train_stgcn_importance.py (reference
tools/train_stgcn_group.py): trains ST-GCN on NW-UCLA (10 labels; 5 groups
with --group_map), then computes per-class body-part importance from input
gradients (tamgcn_tpu_torch/interpret.py) and writes
`<work_dir>/{label,group}_weights.json`, the input of the reference's ST-ROI
weighting generator, and `edge_importance_per_joint.json`.

    python -m tamgcn_tpu_torch.tools.train_stgcn_importance \\
        --data_path data/nucla/all_sqe [--group_map groups.json] [--num_epoch 80]

It runs on the card unless `--use_gpu false` asks for the CPU, and takes
the trainer's other flags.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..interpret import LABEL_NAMES_10, gradient_body_part_importance, save_weights_json
from ..models import edge_importance_per_joint
from ..train.config import base_parser, load_config
from ..train.trainer import RecognitionTrainer


class GroupTrainer(RecognitionTrainer):
    """The recognition trainer with the 10 NW-UCLA labels optionally mapped
    onto coarse groups ({label: group}) in the train and the test feeder."""

    def __init__(self, arg, group_map=None):
        self.group_map = group_map
        super().__init__(arg)

    def _relabel(self, feeder):
        if self.group_map:
            feeder.label = np.asarray([self.group_map[int(l)] for l in feeder.label],
                                      feeder.label.dtype)

    def _load_data(self):
        super()._load_data()
        if hasattr(self, "train_feeder"):
            self._relabel(self.train_feeder)

    def _ensure_test_loader(self):
        if "test" in self.loaders:
            return
        super()._ensure_test_loader()
        self._relabel(self.test_feeder)


def parse_args(argv=None):
    parser = base_parser(add_help=True)
    parser.add_argument("--data_path", default="data/nucla/all_sqe")
    parser.add_argument("--group_map", default=None,
                        help="JSON {label(0-9): group} for 5-group mode")
    parser.add_argument("--samples_per_class", type=int, default=200)
    parser.set_defaults(
        model="stgcn",
        feeder="nucla_gcn",
        work_dir="./work_dir/nucla/stgcn_importance",
        base_lr=0.1,
        step=[50, 65],
        warm_up_epoch=5,
        num_epoch=80,
        batch_size=16,
        test_batch_size=64,
        eval_interval=1,
    )
    arg = load_config(argv, parser=parser)
    arg.model_args = dict(arg.model_args) or {}
    arg.model_args.setdefault("num_class", 10)
    arg.model_args.setdefault("num_point", 20)
    arg.model_args.setdefault("num_person", 1)
    arg.model_args.setdefault("graph", "ucla")
    arg.model_args.setdefault("edge_importance_weighting", True)
    arg.train_feeder_args = dict(arg.train_feeder_args)
    arg.train_feeder_args.setdefault("data_path", arg.data_path)
    arg.train_feeder_args.setdefault("repeat", 5)
    arg.test_feeder_args = dict(arg.test_feeder_args)
    arg.test_feeder_args.setdefault("data_path", arg.data_path)
    return arg


def main(argv=None) -> int:
    arg = parse_args(argv)
    group_map = None
    if arg.group_map:
        with open(arg.group_map) as f:
            group_map = {int(k): int(v) for k, v in json.load(f).items()}
        arg.model_args["num_class"] = len(set(group_map.values()))

    trainer = GroupTrainer(arg, group_map)
    trainer.start()

    trainer.print_log("Extracting class-specific importance (gradient analysis)")
    loader = trainer.loaders.get("train") or trainer.loaders["test"]
    weights = gradient_body_part_importance(
        trainer.model,
        loader,
        num_class=arg.model_args["num_class"],
        samples_per_class=arg.samples_per_class,
    )
    names = LABEL_NAMES_10 if not group_map else None
    for g, parts in weights.items():
        label = names[g] if names else f"group {g}"
        trainer.print_log(f"{label}: " + ", ".join(
            f"{p}={v:.3f}" for p, v in parts.items()
        ))
    out = os.path.join(
        arg.work_dir, "group_weights.json" if group_map else "label_weights.json"
    )
    save_weights_json(weights, out)
    trainer.print_log(f"saved importance weights: {out}")

    # edge-importance-based per-joint scores (reference models/stgcn.py:227-252)
    masks = [p for name, p in trainer.model.named_parameters()
             if name.startswith("edge_importance_")]
    if masks:
        scores = edge_importance_per_joint(masks)
        with open(os.path.join(arg.work_dir, "edge_importance_per_joint.json"), "w") as f:
            json.dump([float(s) for s in scores], f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
