"""Experiment tools of the port, counterparts of the JAX package's tools/.

    python -m tamgcn_tpu_torch.tools.exp_ms_tcn    # T1 against cuDNN
    python -m tamgcn_tpu_torch.tools.exp_stage2    # T2's forms against K1
    python -m tamgcn_tpu_torch.tools.exp_stage2b   # T2 repeats, f32 and bf16

    python -m tamgcn_tpu_torch.tools.bf16_convergence [--family rgb]  # bf16 against f32
    python -m tamgcn_tpu_torch.tools.visualize_fusion --weights W  # CTR-GCN intensity figure
    python -m tamgcn_tpu_torch.tools.ensemble_online_eval --config_a A --weights_a WA \
        --config_b B --weights_b WB  # two models' scores fused, with figures
    python -m tamgcn_tpu_torch.tools.train_stgcn_importance --data_path DIR
        # ST-GCN training, then per-class body-part importance (the trainer's
        # flags; --use_gpu false for the CPU)

They run on the card unless `--device cpu` is given (ensemble_online_eval:
`--use_gpu false` among a side's --extra flags); without CUDA and without
that flag they raise. `python -m tamgcn_tpu_torch.tools.ensemble_eval
--scores_a A.pkl --scores_b B.pkl` fuses two score pickles (numpy only).
Beside them, for the card only:

    python -m tamgcn_tpu_torch.tools.f32_ab --other CSRC_DIR  # f32 K1-K3 against other sources
    python -m tamgcn_tpu_torch.tools.k3_ab                    # K3 with each phase skipped
    python -m tamgcn_tpu_torch.tools.design_ab                # whole-V K1/K2 against joint-tiled
"""
from __future__ import annotations

import argparse
import sys

import torch


def log(*a):
    """The tools' log lines go to stderr, as the JAX tools'."""
    print(*a, file=sys.stderr, flush=True)


def tool_args(argv, description: str, chain: int, iters: int):
    """The tools' common flags: --device, --chain, --iters."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the card; cpu runs the plain versions)")
    ap.add_argument("--chain", type=int, default=chain,
                    help="applications per timed chain")
    ap.add_argument("--iters", type=int, default=iters, help="timed chains")
    return ap.parse_args(argv)


def tool_device(name: str) -> torch.device:
    """The device of a tool run; the card unless `cpu` is asked for."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run the "
                               "plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda", 0)
    return torch.device("cpu")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
