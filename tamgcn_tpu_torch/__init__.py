"""tamgcn_tpu_torch: TAM/CTR-GCN in PyTorch with hand-written CUDA kernels
for Hopper (sm_90a).

The port of tamgcn_tpu (JAX/Pallas on a TPU), which stays beside it as the
reference. It imports torch, numpy, yaml and the standard library, never
JAX or tamgcn_tpu. Entry point: `python -m tamgcn_tpu_torch recognition
-c CONFIG [--phase test --weights w.pt]` (the train phase by default).
"""
