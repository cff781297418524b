"""bf16 mixed precision against float32 in training: counterpart of
tools/bench_bf16_convergence.py.

    python -m tamgcn_tpu_torch.tools.bf16_convergence [--family gcn|rgb] [--epochs 12] \\
        [--samples 256] [--batch 32] [--seed 1] [--device cuda|cpu] [--base_channel 64] \\
        [--out F.json]

--family gcn (the default) trains configs/nucla/smoke.yaml (synthetic
NW-UCLA skeletons, CTR-GCN; --base_channel its width); --family rgb trains
configs/nucla/smoke_resnet.yaml (ResNet-50 on synthetic class-prototype
images of the config's 64 x 64, the JAX tool's :36-38). The family is
trained twice through the port's entry point, `python -m tamgcn_tpu_torch
recognition`, from one seed on the same synthetic data with the same
hyperparameters, once in float32 and once with `--model_args
dtype=bfloat16`, and the per-epoch loss trajectories and the best and final
val top-1 are compared. Prints one JSON line: both runs' train and test
losses and top-1 per epoch, best and final top-1, their deltas, the
unit-op kernel launches each run made on the card
(train/graphs.py:launches_run, the trainer's CUDA graphs' replays included;
the gcn family's bf16 run goes through the bf16 forms of K1-K3 and its
float32 run through the float32 ones; the rgb family runs none), and
whether |best top-1 (f32) - best top-1 (bf16)| <= --tol; exits 1 where it
is not. Runs on the card unless `--device cpu` is given; without CUDA and
without that flag it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..train.graphs import launches_run
from . import log

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "nucla")
# family -> the smoke config trained in both dtypes
FAMILIES = {"gcn": os.path.join(CONFIGS, "smoke.yaml"),
            "rgb": os.path.join(CONFIGS, "smoke_resnet.yaml")}
COUNTERS = ("launches", "launches_bf16", "bwd_dx3_launches", "bwd_dx3_launches_bf16",
            "bwd_param_launches", "bwd_param_launches_bf16")


def run_one(dtype: str, args, work_root: str) -> dict:
    """One training run of the smoke config in `dtype`; its progress rows
    and the unit-op kernels' launches."""
    from ..__main__ import main

    work_dir = os.path.join(work_root, dtype)
    width = [f"base_channel={args.base_channel}"] if args.family == "gcn" else []
    argv = [
        "recognition", "-c", FAMILIES[args.family], "--work_dir", work_dir,
        "--num_epoch", str(args.epochs), "--eval_interval", "1",
        "--save_interval", str(args.epochs + 1), "--seed", str(args.seed),
        "--batch_size", str(args.batch), "--test_batch_size", str(args.batch),
        "--train_feeder_args", f"num_samples={args.samples}",
        "--test_feeder_args", f"num_samples={max(64, args.samples // 4)}",
        "--use_gpu", "true" if args.device == "cuda" else "false",
        "--print_log", "false",
        "--model_args", *width, f"dtype={dtype}",
    ]
    before = launches_run()
    rc = main(argv)
    if rc:
        raise SystemExit(f"the {dtype} run failed: main returned {rc}")
    after = launches_run()
    launches = {k: after[f"ctr_gc.{k}"] - before[f"ctr_gc.{k}"] for k in COUNTERS}
    # columns: train loss, test loss, top-1, top-5 (train/session.py)
    rows = np.atleast_2d(np.loadtxt(os.path.join(work_dir, "progress_info.csv"),
                                    delimiter=","))
    out = {
        "train_loss": [float(v) for v in rows[:, 0]],
        "test_loss": [float(v) for v in rows[:, 1]],
        "top1": [float(v) for v in rows[:, 2]],
        "best_top1": float(rows[:, 2].max()),
        "final_top1": float(rows[-1, 2]),
        "launches": launches,
    }
    log(f"{dtype}: train loss {out['train_loss']}, top-1 {out['top1']}, "
        f"launches {launches}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card)")
    ap.add_argument("--family", choices=sorted(FAMILIES), default="gcn",
                    help="gcn (CTR-GCN on synthetic skeletons) or rgb (ResNet-50 on "
                         "synthetic images)")
    ap.add_argument("--base_channel", type=int, default=64,
                    help="the CTR-GCN's width (64, the config's, by default)")
    ap.add_argument("--tol", type=float, default=0.03,
                    help="allowed |best_top1(f32) - best_top1(bf16)|")
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    with tempfile.TemporaryDirectory(prefix="bf16_convergence_") as work_root:
        f32 = run_one("float32", args, work_root)
        bf16 = run_one("bfloat16", args, work_root)
    best_delta = abs(f32["best_top1"] - bf16["best_top1"])
    record = {
        "metric": f"bf16_convergence_best_top1_delta_{args.family}",
        "value": best_delta,
        "unit": "top1_fraction",
        "config": {"family": args.family, "epochs": args.epochs, "samples": args.samples, "batch": args.batch,
                   "seed": args.seed, "device": args.device,
                   "base_channel": args.base_channel},
        "f32": f32,
        "bf16": bf16,
        "best_top1_delta": best_delta,
        "final_top1_delta": abs(f32["final_top1"] - bf16["final_top1"]),
        "final_train_loss_delta": abs(f32["train_loss"][-1] - bf16["train_loss"][-1]),
        "within_tol": bool(best_delta <= args.tol),
    }
    if args.device == "cuda":
        record["card"] = torch.cuda.get_device_name(0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0 if record["within_tol"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
