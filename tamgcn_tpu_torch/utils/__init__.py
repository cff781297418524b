"""Timing and roofline helpers of the port (counterparts of tamgcn_tpu/utils).

`tamgcn_tpu/utils/cache.py` has no counterpart: it configures XLA's
persistent compile cache, and the port compiles nothing but its CUDA
sources, which ops/cuda/build.py keeps in a hash-keyed `_build/`.
"""
from .roofline import bound  # noqa: F401
from .timing import hard_sync, time_chained  # noqa: F401
