"""Experiment tools of the port, counterparts of the JAX package's tools/.

    python -m tamgcn_tpu_torch.tools.exp_ms_tcn    # T1 against cuDNN
    python -m tamgcn_tpu_torch.tools.exp_stage2    # T2's forms against K1
    python -m tamgcn_tpu_torch.tools.exp_stage2b   # T2 repeats, f32 and bf16

They run on the card unless `--device cpu` is given; without CUDA and
without that flag they raise.
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
