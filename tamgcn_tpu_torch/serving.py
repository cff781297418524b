"""The serving entry point: the flagship CTR-GCN's eval forward and its input.

Counterpart of `entry()` in `__graft_entry__.py`: a callable and example
arguments that a harness can call, time or `torch.export.export`
(tools/export_serving.py writes such an artifact). The multi-chip dry run
beside it there comes with the parallel slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device: str | torch.device | None = None):
    """(fn, example_args): the NW-UCLA CTR-GCN (models/ctrgcn.py:
    create_ctrgcn_nucla, seed 0) in eval mode and a batch of 8 clips (T =
    52, V = 20, one person) from a seeded normal, on the card unless `device`
    asks for the CPU; ``fn(*example_args)`` are the logits (8, 10), through
    K1 on the card. Without CUDA and without device="cpu" it raises."""
    from .models import create_ctrgcn_nucla

    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the plain "
                           "versions on the CPU")
    model = create_ctrgcn_nucla().to(device).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 3, 52, 20, 1).astype(np.float32))
    return model, (x.to(device),)
