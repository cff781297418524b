"""Compute ops: plain PyTorch versions and hand-written CUDA kernels.

Importing this package registers the port's custom ops (namespace
`tamgcn`): `tamgcn::unit_ctr_gc` (the unit op's forward, K1) and
`tamgcn::gcn_tcn_block` (the whole eval block, K5), which a serving
artifact of tools/export_serving.py calls. A process that loads such an
artifact imports this package and nothing else of the port.
"""
from .aggregation import (  # noqa: F401
    UnitCtrGc,
    conv3_matmul,
    ctr_gc_aggregate,
    ctr_gc_dynamic_adjacency,
    stgcn_aggregate,
    unit_ctr_gc,
    unit_ctr_gc_dx3_plain,
    unit_ctr_gc_op,
    unit_ctr_gc_param_grads_plain,
    unit_ctr_gc_plain,
)
from .gcn_tcn_block import gcn_tcn_block_op  # noqa: F401
