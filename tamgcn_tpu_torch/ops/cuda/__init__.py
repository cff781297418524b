"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

Modules here import no CUDA toolchain at import time: a kernel is built by
`build` at its first launch.

Each wrapper module counts its kernels' launches in module-level ints whose
names hold "launches"; `launch_counts` reads them all.
"""
from __future__ import annotations

import importlib

WRAPPERS = ("ctr_gc", "gcn_tcn_block", "ms_tcn", "stage2")


def launch_counts() -> dict[str, int]:
    """{"<module>.<counter>": count} of every launch counter of the wrappers,
    e.g. "ctr_gc.launches" (K1) or "gcn_tcn_block.launches" (K5)."""
    out = {}
    for name in WRAPPERS:
        module = importlib.import_module(f"{__name__}.{name}")
        for attr, value in vars(module).items():
            if "launches" in attr and isinstance(value, int):
                out[f"{name}.{attr}"] = value
    return out
