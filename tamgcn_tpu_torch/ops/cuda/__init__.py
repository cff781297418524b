"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

Modules here import no CUDA toolchain at import time: a kernel is built by
`build` at its first launch.
"""
