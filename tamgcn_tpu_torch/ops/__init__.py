"""Compute ops: plain PyTorch versions and hand-written CUDA kernels."""
from .aggregation import (  # noqa: F401
    UnitCtrGc,
    conv3_matmul,
    ctr_gc_aggregate,
    ctr_gc_dynamic_adjacency,
    stgcn_aggregate,
    unit_ctr_gc,
    unit_ctr_gc_dx3_plain,
    unit_ctr_gc_param_grads_plain,
    unit_ctr_gc_plain,
)
