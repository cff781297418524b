#!/usr/bin/env python3
"""On-card smoke test of tamgcn_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be available; prints the CUDA version and the card's
     name and power limit (nvidia-smi);
  2. build: compiles every CUDA source of the port (one nvcc each, all
     started together) and prints the seconds;
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes of the main paths (K1 at the test batch 64, K2 and K3 at
     the training batch 16, plus V=25 and ragged shapes), f32 with TF32 off,
     and times both with CUDA events. K1 and K2 are held within rtol 1e-5
     and atol 1e-5*max|plain|; K3's outputs are sums of up to N*T*V*V terms
     taken in another order, so each is held within rtol 1e-4 and atol
     1e-4*max|plain| (dalpha, one sum over all N*S*V*V*C terms, within rtol
     1e-3); two K3 launches must agree bit for bit;
  4. test main path: `python -m tamgcn_tpu_torch recognition --phase test`
     run in-process through `__main__.main` at full NW-UCLA width
     (base_channel 64, 10 blocks, T=52, V=20, batch 64, 256 synthetic val
     samples) on weights of the port's seeded init with alpha, the TAM offset
     conv and the gcn1 BN scale perturbed; checks that K1 was launched 10
     times per batch and that the logits of one batch match the same model
     on the CPU through the plain path; times the eval forward with the
     kernel and with the plain unit op, and lists its device time by kernel
     name (torch.profiler);
  5. train main path: `python -m tamgcn_tpu_torch recognition --phase
     train` in-process at full width on configs/nucla/smoke.yaml (batch 16,
     2 epochs of 128 synthetic samples, eval after each), then `--resume`
     for a third epoch; checks K1 = K2 = K3 = 10 launches per train step
     (and K1 10 per eval batch), finite losses, the checkpoints and
     progress_info.csv; takes 3 SGD steps from the perturbed weights on the
     same batches on the card (f32) and on the CPU (plain path, f64) and
     holds the card's losses and every tensor of its state to the f64 run
     within 10x the f32 error of two references (CPU f32, card f32 with the
     plain unit op) plus a floor, per tensor a share of its own change, for
     the flips of relu and max-pool decisions, after every step; the same
     check with each of K3's six outputs zeroed in turn must fail
     (check_trajectory); times the train step at batch
     16 and 64, with the plain unit op beside it at 16, and lists its device
     time by kernel name;
  6. fast eval: holds K5, the whole eval-mode GCN+TCN block, against its
     plain version at the ten blocks' shapes at batch 64 plus V=25 and a
     ragged shape (Cin != C), f32 with TF32 off, within rtol 1e-5 and atol
     1e-4*max|plain| (four products in a row, each summing up to 3*C terms in
     another order), and times it, its plain version and the folded path
     with K1 and cuBLAS products (use_kernel=False); runs `--phase test
     --fast_eval true` through `__main__.main` at full width (as phase 4)
     and checks that K5 was launched 10 times per batch and K1-K3 never,
     and the logits of one batch against the unfused model on the CPU;
     times the forward at batch 64 three ways (fast eval with K5, fast eval
     with use_kernel=False, the unfused model) and lists their device time
     by kernel name;
  7. fused-conv3 training and CTRGC: holds K6, the x3 gradient carried
     through conv3's VJP, against its plain version at the l5-l10 shapes at
     batch 16 plus V=25 and a ragged shape (odd T, Cin != 4k), f32 with TF32
     off: dx within rtol 1e-5 and atol 1e-4*max|plain| (two products in a
     row), dw3 and db3 (sums over N*T*V rows) within rtol 1e-4 and atol
     1e-4*max|plain|; two K6 launches must agree bit for bit; times K6, its
     plain version and the unfused composition (K2, two torch.matmul
     products and a sum). Runs `--phase train` for one epoch with
     TAMGCN_FUSE_CONV3=1 (set around the call and restored after) and checks
     K1 = 10 per step and eval batch, K2 = 4, K6 = 6 and K3 = 10 per step,
     finite losses and the checkpoint; runs check_trajectory with the switch
     on, whose planted faults then zero each of K6's outputs; times the train
     step with the switch on at batch 16 and 64 beside the default step,
     with device time by kernel name. Then the standalone CTRGC module,
     forward and backward on the card (K1 and K2 at S = 1, K4's path) against
     the same module with the plain single-subset op, and ctr_gc_fused
     without b4 against its plain version, at (N=16, T=52, V=20, Cin=64,
     C=128) and V=25, and times K4's work (K1 and K2 at S = 1) against its
     plain version.
  8. experiment kernels T1 and T2: holds T1, the eval multi-scale TCN, against
     its plain version at the ten fast-eval blocks' branch shapes at batch 64
     plus V=25 and a ragged shape (N=3, odd T at stride 2, bc=5), f32 with
     TF32 off, within rtol 1e-5 and atol 1e-4*max|plain| (each output sums
     up to 5*bc terms in another order than cuDNN's), two launches bitwise
     equal, and times it beside its plain version and the engine's cuDNN
     composition; runs T1 on the ten folded blocks of the phase-4 model with
     prefixes from its K5 blocks (ms_tcn_operands); holds T2 in every form
     (tile, win, floor, flat with and without the subset sum, f32; tile on
     bf16 operands) against its plain version at the tools' shape (N=64,
     T=13, V=20, C=256, S=3), V=25 and a ragged shape, f32 within rtol 1e-5
     and atol 1e-5*max|plain|, bf16 within one rounding of the output (rtol
     2^-7), two launches bitwise equal, timed beside its plain version and one
     torch.einsum call; then runs the three port tools (exp_ms_tcn,
     exp_stage2, exp_stage2b) in-process and checks each one's launches.
The launch checks of phases 4-7 also require K6 = 0 (phases 4-6: the switch
is off by default) and T1 = T2 = 0. The last lines are the card line, the
kernels JSON and the result JSON. The kernels JSON gives, for each kernel,
its times and bound summed over the launches of one eval forward at batch 64
(K1), of one train step at batch 16 (K2, K3; K6 with the switch on, with the
unfused composition's time under "unfused_k2_cublas_ms"), of one CTRGC
forward and backward (K4), of one fast-eval forward at batch 64 (K5, with
the folded path's time under "folded_k1_cublas_ms"; T1 at the ten blocks'
branch shapes, with the engine composition's time as "library_ms") or of one
tile-form call at the tools' shape (T2, with one einsum's time as
"library_ms"), and each shape's row under "shapes".
"""
from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1
N_SAMPLES = 256
BATCH = 64
TRAIN_BATCH = 16
TRAIN_SAMPLES = 128  # configs/nucla/smoke.yaml: 8 steps per epoch
EVAL_SAMPLES = 64  # configs/nucla/smoke.yaml test split: 4 batches of 16
LOGIT_RTOL = 1e-4  # |gpu - cpu| <= LOGIT_RTOL * max|cpu|: sum order differs
TRAJ_STEPS = 3
TRAJ_TIMES = 10
TRAJ_LOSS_FLOOR = 1e-2
TRAJ_TENSOR_FLOOR = 2e-2
# K3's outputs; a planted fault zeroes each in turn, and the trajectory
# check must fail for every one
K3_OUTPUTS = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
K6_OUTPUTS = ("dx", "dw3", "db3")
# K6 shapes (N, T, V, Cin, C, R) at the training batch, with the launches per
# train step with TAMGCN_FUSE_CONV3=1 (the blocks with C >= 128)
K6_MAIN_PATH = [
    ("l5", (TRAIN_BATCH, 52, 20, 64, 128, 8), 1),
    ("l6-l7", (TRAIN_BATCH, 26, 20, 128, 128, 16), 2),
    ("l8", (TRAIN_BATCH, 26, 20, 128, 256, 16), 1),
    ("l9-l10", (TRAIN_BATCH, 13, 20, 256, 256, 32), 2),
]
K6_EXTRA = [
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 128, 16)),
    ("V=25 R=32", (TRAIN_BATCH, 13, 25, 256, 256, 32)),
    ("ragged", (3, 7, 20, 30, 40, 10)),  # odd T, Cin != 4k, partial tile
]
# the standalone CTRGC module (N, T, V, Cin, C): its first shape is K4's main
# path, one forward and backward
CTRGC_SHAPES = [
    ("l5 widths", (TRAIN_BATCH, 52, 20, 64, 128)),
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 128)),
]
# T1 shapes (N, T, V, bc, stride): exp_ms_tcn's six shapes (bc = C/4), the
# ten fast-eval blocks' branch halves at N=64 and an NTU-shaped block, each
# launched as often in one run of the tool; and a ragged one the tool lacks
T1_TOOL_SHAPES = [
    ("l1-l4", (64, 52, 20, 16, 1)),
    ("l5", (64, 52, 20, 32, 2)),
    ("l6-l7", (64, 26, 20, 32, 1)),
    ("l8", (64, 26, 20, 64, 2)),
    ("l9-l10", (64, 13, 20, 64, 1)),
    ("V=25", (32, 64, 25, 16, 1)),
]
T1_EXTRA = [
    ("ragged", (3, 7, 20, 5, 2)),  # odd T at stride 2, bc not a multiple of 4
]
# T2 shapes (N, T, V, C, S): the stage-2 tools' shape, V=25, a ragged one;
# and the cases (form, subset sum, operand type) held at each
T2_SHAPES = [
    ("tool shape", (64, 13, 20, 256, 3)),
    ("V=25", (64, 13, 25, 256, 3)),
    ("ragged", (3, 5, 7, 10, 3)),
]
T2_CASES = [("tile", False, "float32"), ("tile", False, "bfloat16"),
            ("win", False, "float32"), ("floor", False, "float32"),
            ("flat", False, "float32"), ("flat", True, "float32")]

# unit op shapes (N, T, V, C, R), with the launches per eval forward at N=64
K1_MAIN_PATH = [
    ("l1", (64, 52, 20, 64, 8), 1),
    ("l2-l4", (64, 52, 20, 64, 8), 3),
    ("l5", (64, 52, 20, 128, 8), 1),
    ("l6-l7", (64, 26, 20, 128, 16), 2),
    ("l8", (64, 26, 20, 256, 16), 1),
    ("l9-l10", (64, 13, 20, 256, 32), 2),
]
K1_EXTRA = [
    ("V=25", (64, 26, 25, 128, 16)),
    ("ragged", (3, 7, 20, 80, 10)),  # odd T, partial channel tile, R < 16
]
# K5 shapes (N, T, V, Cin, C, R), with the launches per fast-eval forward at
# N=64; P = 3C/4 and BC = C/4, a folded down conv where Cin != C
K5_MAIN_PATH = [
    ("l1", (64, 52, 20, 3, 64, 8), 1),
    ("l2-l4", (64, 52, 20, 64, 64, 8), 3),
    ("l5", (64, 52, 20, 64, 128, 8), 1),
    ("l6-l7", (64, 26, 20, 128, 128, 16), 2),
    ("l8", (64, 26, 20, 128, 256, 16), 1),
    ("l9-l10", (64, 13, 20, 256, 256, 32), 2),
]
K5_EXTRA = [
    ("V=25", (64, 26, 25, 128, 128, 16)),
    ("ragged", (3, 7, 20, 80, 64, 10)),  # odd T, Cin != C, partial tile
]
# the same blocks at the training batch, with the launches per train step
BWD_MAIN_PATH = [(name, (TRAIN_BATCH,) + shape[1:], count)
                 for name, shape, count in K1_MAIN_PATH]
BWD_EXTRA = [
    ("V=25", (TRAIN_BATCH, 26, 25, 128, 16)),
    ("V=25 R=32", (TRAIN_BATCH, 13, 25, 256, 32)),  # K3's smaller channel tile
    ("ragged", (3, 7, 20, 80, 10)),
    ("N=1", (1, 13, 20, 256, 32)),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_inputs(shape, seed: int, device):
    """(x1s, x2s, x3s, w4s, b4s, alpha, As, g): the unit op's inputs with a
    random non-symmetric A and alpha != 0, and a gradient g of its output."""
    import torch

    N, T, V, C, R = shape
    S = 3
    g = torch.Generator().manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(device)

    return (
        randn(N, S, V, R), randn(N, S, V, R), randn(N, T, V, S * C),
        randn(S, R, C, scale=0.1), randn(S, C, scale=0.1),
        (torch.rand(1, generator=g) + 0.5).to(device),
        torch.rand((S, V, V), generator=g).to(device),
        randn(N, T, V, C),
    )


# The k*_bound functions return (ms, 'bytes'|'operations'): the larger of
# the f32 values each input read once and each output written once over HBM,
# and the FMAs (2 ops) over the f32 peak, at the published H100 SXM peaks
# (tamgcn_tpu_torch/utils/roofline.py).


def k1_bound(shape):
    from tamgcn_tpu_torch.utils.roofline import unit_ctr_gc_sol

    return unit_ctr_gc_sol(*shape)


def k2_bound(shape):
    from tamgcn_tpu_torch.utils.roofline import bound

    N, T, V, C, R = shape
    S = 3
    elems = (N * T * V * C + N * T * V * S * C + 2 * N * S * V * R + S * R * C
             + S * C + 1 + S * V * V)
    return bound(elems, 2 * N * S * (V * V * R * C + T * V * V * C))


def k3_bound(shape):
    from tamgcn_tpu_torch.utils.roofline import bound

    N, T, V, C, R = shape
    S = 3
    # g, x3s, x1s, x2s in, dx1s, dx2s out; w4s, b4s, alpha in; dw4s, db4s,
    # dalpha, dAs out (the bytes of the JAX cost estimate, ctr_gc.py:1360)
    elems = (N * T * V * C + N * T * V * S * C + 4 * N * S * V * R
             + 2 * (S * R * C + S * C + 1) + S * V * V)
    # FMAs: dm = sum_t g x3, then D^T dm (dw4) and dm w4^T (dx1, dx2). dalpha
    # reuses P = D^T dm as sum w4*P + b4*sum(dm), so it needs no third
    # V*V*R*C product; the JAX estimate counts one (6 instead of 4)
    return bound(elems, 2 * N * S * T * V * V * C + 4 * N * S * V * V * R * C)


def k6_bound(shape):
    from tamgcn_tpu_torch.utils.roofline import bound

    N, T, V, Cin, C, R = shape
    S = 3
    # x1s, x2s, g, x, w3, w4s, b4s, alpha, As in; dx, dw3, db3 out
    elems = (2 * N * S * V * R + N * T * V * C + 2 * N * T * V * Cin
             + 2 * Cin * S * C + S * R * C + 2 * S * C + 1 + S * V * V)
    # FMAs of M and the aggregation (as K2), of dx = dx3s w3^T and dw3 =
    # x^T dx3s (the JAX cost estimate, ctr_gc.py:1475), and db3's adds
    flops = (2 * N * S * (V * V * R * C + T * V * V * C)
             + 4 * N * T * V * S * C * Cin + N * T * V * S * C)
    return bound(elems, flops)


def k4_bound(shape):
    """K4's work on one CTRGC forward and backward: the single-subset forward
    and its x3 gradient (x1, x2, x3, g, w4, b4, alpha, A in; out, dx3 out)."""
    from tamgcn_tpu_torch.utils.roofline import bound

    N, T, V, Cin, C = shape
    R = 8 if Cin in (3, 9) else Cin // 8
    elems = 2 * N * V * R + 4 * N * T * V * C + R * C + C + 1 + V * V
    return bound(elems, 4 * N * (V * V * R * C + T * V * V * C))


def block_inputs(shape, seed: int, device):
    """K5's inputs as keywords: alpha != 0, b4 != 0, a random non-symmetric A,
    a BN affine gy far from (1, 0), and a down conv where Cin != C."""
    import torch

    N, T, V, Cin, C, R = shape
    S, P, BC = 3, 3 * C // 4, C // 4
    g = torch.Generator().manual_seed(seed)

    def w(*s, fan=4):
        return torch.randn(s, generator=g) / fan ** 0.5

    args = dict(
        x=torch.randn((N, T, V, Cin), generator=g),
        x1s=torch.randn((N, S, V, R), generator=g),
        x2s=torch.randn((N, S, V, R), generator=g),
        w3=w(Cin, S * C, fan=Cin), b3=w(S * C), w4s=w(S, R, C, fan=R), b4s=w(S, C),
        alpha=torch.tensor([0.7]), As=torch.rand((S, V, V), generator=g),
        gy=torch.stack([1.0 + 0.5 * torch.randn(C, generator=g),
                        0.3 * torch.randn(C, generator=g)]),
        wo=w(C, C, fan=C), bo=w(C), wp=w(C, P, fan=C), bp=w(P),
        wpw=w(C, BC, fan=C), bpw=w(BC),
        wd=None if Cin == C else w(Cin, C, fan=Cin), bd=None if Cin == C else w(C),
    )
    return {k: None if a is None else a.to(device) for k, a in args.items()}


def k5_bound(shape):
    """x read and prefix, pw written once, every weight read once; the FMAs of
    the aggregation and of the five products as the JAX cost estimate counts
    them (gcn_tcn_block.py:263-266)."""
    from tamgcn_tpu_torch.utils.roofline import bound

    N, T, V, Cin, C, R = shape
    S, P, BC = 3, 3 * C // 4, C // 4
    down = Cin != C
    elems = (N * T * V * (Cin + P + BC) + 2 * N * S * V * R + Cin * S * C + S * C
             + S * R * C + S * C + 1 + S * V * V + 2 * C + C * C + C + C * P + P
             + C * BC + BC + (Cin * C + C if down else 0))
    flops_agg = 2 * N * S * (V * V * R * C + T * V * V * C)
    flops_mm = 2 * N * T * V * (Cin * S * C + C * C + C * P + C * BC
                                + (Cin * C if down else 0))
    return bound(elems, flops_agg + flops_mm)


def _within(got, want, rtol, atol_frac):
    """(ok, max |got - want|, max |want|)."""
    import torch

    err = (got - want).abs()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and not bool(
        (err > rtol * want.abs() + atol_frac * scale).any())
    return ok, err.max().item(), scale


def check_kernels(device):
    """K1, K2 and K3 against their plain versions at every shape; returns
    {'K1': rows, 'K2': rows, 'K3': rows}."""
    import torch

    from tamgcn_tpu_torch.ops import aggregation as agg
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    def k1(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)

    def k1_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return agg.unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)

    def k2(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)

    def k2_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return agg.unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)

    def k3(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)

    def k3_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, g):
        return agg.unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)

    plan = [
        ("K1", k1, k1_plain, k1_bound, K1_MAIN_PATH, K1_EXTRA),
        ("K2", k2, k2_plain, k2_bound, BWD_MAIN_PATH, BWD_EXTRA),
        ("K3", k3, k3_plain, k3_bound, BWD_MAIN_PATH, BWD_EXTRA),
    ]
    out = {}
    for kname, fn, plain, bound_fn, main_path, extra in plan:
        rows = []
        shapes = [(n, s, c) for n, s, c in main_path] + [(n, s, 0) for n, s in extra]
        for i, (name, shape, count) in enumerate(shapes):
            args = unit_inputs(shape, seed=100 + i, device=device)
            with torch.no_grad():
                got = fn(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                if kname == "K3":
                    again = fn(*args)
                    torch.cuda.synchronize()
                    for part, a, b in zip(K3_OUTPUTS, got, again):
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"K3 {name} {shape}: two launches differ in {part}")
                    errs = [(part,) + _within(a, b, *((1e-3, 0.0) if part == "dalpha"
                                                      else (1e-4, 1e-4)))
                            for part, a, b in zip(K3_OUTPUTS, got, want)]
                else:
                    rtol = 1e-5
                    errs = [("out",) + _within(got, want, rtol, rtol)]
                for part, ok, max_err, scale in errs:
                    if not ok:
                        raise AssertionError(
                            f"{kname} {name} {shape} {part}: max |kernel - plain| "
                            f"{max_err:.3e} (max|plain| {scale:.3e}) beyond the "
                            "stated tolerance")
                ms = cuda_ms(lambda: fn(*args))
                plain_ms = cuda_ms(lambda: plain(*args))
            bound_ms, bound_by = bound_fn(shape)
            # the worst output relative to its own scale
            worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
            rows.append(dict(name=name, shape=dict(zip("NTVCR", shape)),
                             launches_per_step=count, max_abs_err=worst[2],
                             max_abs_plain=worst[3], worst_output=worst[0],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"{kname} {name:9s} N,T,V,C,R={shape}: max_abs_err "
                  f"{worst[2]:.3e} in {worst[0]} (max|plain| {worst[3]:.3e}) "
                  f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                  f"bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
        out[kname] = rows
    return out


def check_k5(device):
    """K5 against its plain version at every shape, and the times of K5, the
    plain version and the folded path with K1 and cuBLAS products (the
    engine's use_kernel=False); returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc
    from tamgcn_tpu_torch.ops.cuda.gcn_tcn_block import gcn_tcn_block_fwd
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_plain

    rows = []
    shapes = [(n, s, c) for n, s, c in K5_MAIN_PATH] + [(n, s, 0) for n, s in K5_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        args = block_inputs(shape, seed=300 + i, device=device)
        with torch.no_grad():
            got = gcn_tcn_block_fwd(**args)
            want = gcn_tcn_block_plain(**args)
            torch.cuda.synchronize()
            errs = [(part,) + _within(a, b, 1e-5, 1e-4)
                    for part, a, b in zip(("prefix", "pw"), got, want)]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"K5 {name} {shape} {part}: max |kernel - plain| {max_err:.3e} "
                        f"(max|plain| {scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: gcn_tcn_block_fwd(**args))
            plain_ms = cuda_ms(lambda: gcn_tcn_block_plain(**args))
            folded_ms = cuda_ms(lambda: gcn_tcn_block_plain(**args, aggregate=unit_ctr_gc))
        bound_ms, bound_by = k5_bound(shape)
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, folded_k1_cublas_ms=folded_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K5 {name:9s} N,T,V,Cin,C,R={shape}: max_abs_err {worst[2]:.3e} in "
              f"{worst[0]} (max|plain| {worst[3]:.3e}) kernel {ms * 1e3:.1f} us, "
              f"plain {plain_ms * 1e3:.1f} us, folded K1+cuBLAS {folded_ms * 1e3:.1f} "
              f"us, bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def make_weights(path: str, seed: int) -> None:
    """The port's seeded init with what hides the kernels moved off its
    degenerate values (alpha=0 makes M = A and zeroes dx1, dx2, dw4 and db4,
    the 1e-6 gcn1.bn scale scales the aggregation away, the offset conv
    starts at zero) and calibrated BatchNorm running stats."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.norm import BatchNorm
    from tamgcn_tpu_torch.train.checkpoint import save_weights

    model = get_model("ctrgcn", generator=torch.Generator().manual_seed(SEED),
                      **nucla_model_args())
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("gcn1.alpha"):
                t.copy_(0.5 * noise)
            elif "offset_conv.weight" in name:
                t.add_(0.02 * noise)
            elif name.endswith("gcn1.bn.weight"):
                t.copy_(1.0 + 0.1 * noise)
    # running stats from one train-mode pass over a batch of train samples
    # (momentum 1), so that eval activations stay O(1) through the ten
    # blocks instead of growing by orders of magnitude, which would make the
    # CPU/GPU comparison of the logits a test of conditioning
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    feeder = SyntheticSkeletonFeeder(num_samples=BATCH, split="train", seed=SEED)
    x = torch.from_numpy(np.stack([feeder[i][0] for i in range(BATCH)]))
    with torch.no_grad():
        model.train()(x)
    for bn in bns:
        bn.momentum = 0.1
    save_weights(model, path)


def nucla_model_args() -> dict:
    return dict(num_class=10, num_point=20, num_person=1, graph="ucla",
                graph_args={"labeling_mode": "spatial"}, base_channel=64)


def reset_launches():
    from tamgcn_tpu_torch.ops.cuda import ctr_gc, gcn_tcn_block, ms_tcn, stage2

    ctr_gc.launches = ctr_gc.bwd_dx3_launches = ctr_gc.bwd_param_launches = 0
    ctr_gc.bwd_conv3_launches = 0
    gcn_tcn_block.launches = ms_tcn.launches = stage2.launches = 0


def read_launches() -> dict:
    from tamgcn_tpu_torch.ops.cuda import ctr_gc, gcn_tcn_block, ms_tcn, stage2

    return {"K1": ctr_gc.launches, "K2": ctr_gc.bwd_dx3_launches,
            "K3": ctr_gc.bwd_param_launches, "K5": gcn_tcn_block.launches,
            "K6": ctr_gc.bwd_conv3_launches, "T1": ms_tcn.launches,
            "T2": stage2.launches}


def fuse_conv3(on: bool = True):
    """TAMGCN_FUSE_CONV3 set to 1 (or 0) in os.environ, restored after."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"TAMGCN_FUSE_CONV3": "1" if on else "0"})


def plain_unit_op():
    """The unit op's plain version on the card in place of K1-K3, with the
    switch off so that no block takes the conv3-fused op: the model's math
    without its kernels."""
    from unittest import mock

    from tamgcn_tpu_torch.ops import aggregation

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(aggregation, "unit_ctr_gc",
                                          aggregation.unit_ctr_gc_plain))
    stack.enter_context(fuse_conv3(False))
    return stack


def run_cli(argv):
    """The user's entry point, in-process; returns (seconds, launches)."""
    import torch

    from tamgcn_tpu_torch.__main__ import main

    reset_launches()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    return seconds, launches


def run_test_path(work_dir: str, weights: str, *extra):
    return run_cli([
        "recognition", "-c", os.path.join(REPO, "configs/nucla/smoke.yaml"),
        "--phase", "test", "--weights", weights, "--work_dir", work_dir,
        "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
        "--save_result", "true", "--test_batch_size", str(BATCH),
        "--test_feeder_args", f"num_samples={N_SAMPLES}",
        "--model_args", "base_channel=64", *extra,
    ])


def check_logits(work_dir: str, weights: str):
    """Logits of the first batch from the run's score pickle against the same
    model on the CPU (plain path). Returns the max relative error."""
    import numpy as np
    import torch

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    with open(os.path.join(work_dir, "test_result.pkl"), "rb") as f:
        scores = pickle.load(f)
    feeder = SyntheticSkeletonFeeder(num_samples=N_SAMPLES, split="val", seed=SEED)
    if len(scores) != N_SAMPLES:
        raise AssertionError(f"{len(scores)} scores for {N_SAMPLES} samples")
    gpu = np.stack([scores[feeder.sample_name[i]] for i in range(BATCH)])
    x = np.stack([feeder[i][0] for i in range(BATCH)])
    model = get_model("ctrgcn", generator=torch.Generator().manual_seed(SEED),
                      **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    with torch.inference_mode():
        cpu = model.eval()(torch.from_numpy(x)).numpy()
    if gpu.shape != (BATCH, 10) or not np.isfinite(gpu).all():
        raise AssertionError(f"bad logits: shape {gpu.shape}")
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > LOGIT_RTOL:
        raise AssertionError(
            f"GPU logits differ from the CPU plain path: max|d|/max|cpu| "
            f"{rel:.3e} > {LOGIT_RTOL}"
        )
    return rel, x


# the first kernel each wrapper launches, by its counter's name
KERNEL_SYMBOLS = {"K1": "unit_ctr_gc_fwd_kernel", "K2": "unit_ctr_gc_bwd_dx3_kernel",
                  "K3": "unit_ctr_gc_bwd_param_kernel", "K5": "block_agg_kernel",
                  "K6": "unit_ctr_gc_bwd_conv3_kernel", "T1": "ms_tcn_kernel",
                  "T2": "stage2_kernel"}


def profile_device(fn, reps: int = 5):
    """Device time by kernel name over `reps` calls of fn (torch.profiler):
    (busy_ms, n_kernels, top 10 (name, ms, launches)), all per call. The
    trace must hold every launch of the port's kernels that the wrappers
    counted while it ran; a partial trace is taken once more, then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attempts = 2
    for attempt in range(1, attempts + 1):
        before = read_launches()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in read_launches().items() if n > before[k]}
        averages = prof.key_averages()
        traced = {k: sum(e.count for e in averages if KERNEL_SYMBOLS[k] in e.key)
                  for k in launched}
        if traced == launched:
            break
        print(f"torch.profiler traced {traced} of the launches {launched} "
              f"(attempt {attempt} of {attempts})", flush=True)
    else:
        raise AssertionError("torch.profiler missed launches of the port's kernels")
    events = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
              for e in averages if e.self_device_time_total > 0]
    if not events:
        raise AssertionError("the profiler saw no device time")
    events.sort(key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in events)
    n_kernels = sum(count for _, _, count in events)
    return busy_ms, n_kernels, events


def graph_ms(fn) -> float:
    """Device time per call of fn with no host time between its launches:
    20 calls captured in one CUDA graph, replayed 5 times between two CUDA
    events. fn launches on the current stream."""
    import torch

    reps, replays = 20, 5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # library plans and workspaces, before the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def check_above_bound(what: str, device_ms: float, bound_ms: float):
    """A device time below the speed of light is a broken measurement."""
    if device_ms < bound_ms:
        raise AssertionError(f"{what}: device time {device_ms * 1e3:.2f} us below its "
                             f"bound {bound_ms * 1e3:.2f} us")


def print_profile(what, wall_ms, busy_ms, n_kernels, events):
    print(f"{what} device time (torch.profiler): {busy_ms:.3f} ms busy of "
          f"{wall_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle) in "
          f"{n_kernels} kernel launches; top kernels, ms and launches per call:",
          flush=True)
    for name, ms, count in events[:10]:
        print(f"  {ms:8.4f} ms {count:4d}x  {name[:100]}", flush=True)


def time_eval(weights: str, x, device):
    """Steady-state eval forward of one batch of 64: with the kernel and
    with the plain version of the unit op swapped in (CUDA events, in turns
    kernel, plain, kernel), and the device time by kernel name."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: model(xb))
        with plain_unit_op():
            plain_ms = cuda_ms(lambda: model(xb))
        kernel_ms_2 = cuda_ms(lambda: model(xb))
        busy_ms, n_kernels, events = profile_device(lambda: model(xb))
    return min(kernel_ms, kernel_ms_2), plain_ms, busy_ms, n_kernels, events


def time_fast_eval(weights: str, x, device):
    """Steady-state forward of one batch of 64 three ways (CUDA events, in
    turns fast, folded, unfused, then again in reverse): fast eval with K5,
    fast eval with use_kernel=False (K1 and cuBLAS products), the unfused
    model; and the device time by kernel name of each. Returns {way: (ms,
    busy_ms, n_kernels, events)}."""
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    out = {}
    with torch.inference_mode():
        ways = {"fast eval, K5": make_fast_eval(model),
                "fast eval, use_kernel=False": make_fast_eval(model, use_kernel=False),
                "unfused model": model}
        ms = {way: [] for way in ways}
        for order in (list(ways), list(ways)[::-1]):
            for way in order:
                ms[way].append(cuda_ms(lambda: ways[way](xb)))
        for way, fn in ways.items():
            out[way] = (min(ms[way]),) + profile_device(lambda: fn(xb))
    return out


def train_argv(work_dir: str) -> list:
    return [
        "recognition", "-c", os.path.join(REPO, "configs/nucla/smoke.yaml"),
        "--phase", "train", "--work_dir", work_dir, "--use_gpu", "true",
        "--device", "0", "--seed", str(SEED), "--model_args", "base_channel=64",
        "--batch_size", str(TRAIN_BATCH), "--test_batch_size", str(TRAIN_BATCH),
        "--train_feeder_args", f"num_samples={TRAIN_SAMPLES}",
        "--test_feeder_args", f"num_samples={EVAL_SAMPLES}",
        "--eval_interval", "1", "--save_interval", "1",
    ]


def check_train_files(work_dir: str, total: int, epochs: int, label: str):
    """The checkpoints of epochs 1..total, and the last `epochs` rows of
    progress_info.csv (train loss, test loss, top1, top5) finite; returns
    those rows."""
    import numpy as np

    for n in range(1, total + 1):
        if not os.path.isfile(os.path.join(work_dir, "checkpoints", f"epoch{n}.pt")):
            raise AssertionError(f"checkpoints/epoch{n}.pt missing ({label})")
    with open(os.path.join(work_dir, "progress_info.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    # one row per eval of the run
    progress = np.asarray(rows, dtype=np.float64)[total - epochs:]
    if len(progress) != epochs or not np.isfinite(progress).all():
        raise AssertionError(f"progress_info.csv ({label}): {rows}")
    return progress


def run_train_path(work_dir: str):
    """--phase train for 2 epochs, then --resume for a third; checks the
    launch counts, the losses and the files. Returns a summary dict."""
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    argv = train_argv(work_dir)
    summary = {}
    ckpt = os.path.join(work_dir, "checkpoints")
    for label, epochs, extra in (("train", 2, []),
                                 ("resume", 1, ["--resume", "true"])):
        total = 2 + (label == "resume")
        seconds, launches = run_cli(argv + ["--num_epoch", str(total), *extra])
        want = {"K1": 10 * epochs * (steps + evals), "K2": 10 * epochs * steps,
                "K3": 10 * epochs * steps, "K5": 0, "K6": 0, "T1": 0, "T2": 0}
        if launches != want:
            raise AssertionError(
                f"--phase train ({label}): launches {launches}, expected {want} "
                f"(10 per train step of {steps} a epoch, K1 also 10 per eval "
                f"batch of {evals})")
        progress = check_train_files(work_dir, total, epochs, label)
        if label == "train" and (progress[:, 2].max() > 0) != os.path.isfile(
                os.path.join(ckpt, "best.pt")):
            raise AssertionError("best.pt does not follow the best top-1")
        summary[label] = dict(seconds=seconds, launches=launches,
                              progress=progress.tolist())
        print(f"train path ({label}): {epochs} epoch(s) of {steps} steps at "
              f"batch {TRAIN_BATCH} in {seconds:.2f} s (incl. model build, data "
              f"and eval), launches {launches}; progress (train loss, test "
              f"loss, top1, top5) {progress.tolist()}", flush=True)
    return summary


def train_batches(n: int, batch: int):
    import numpy as np

    from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder

    feeder = SyntheticSkeletonFeeder(num_samples=n * batch, split="train", seed=SEED)
    out = []
    for b in range(n):
        items = [feeder[i] for i in range(b * batch, (b + 1) * batch)]
        out.append((np.stack([it[0] for it in items]),
                    np.asarray([it[1] for it in items], np.int64)))
    return out


def train_model(weights: str, device, dtype=None):
    import torch

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.train.checkpoint import load_weights
    from tamgcn_tpu_torch.train.optim import make_optimizer

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device, dtype or torch.float32).train()
    opt = make_optimizer("SGD", model.parameters(), 0.05, weight_decay=1e-4)
    return model, opt


def train_step(model, opt, x, y):
    import torch.nn.functional as F

    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    return loss


def trajectory(weights: str, batches, where, dtype):
    """SGD steps from `weights`, one on each of `batches`: (losses, [state
    before the first step, after each step], each {name: f64 CPU tensor})."""
    import torch

    def state():
        return {k: v.detach().cpu().double().clone()
                for k, v in model.state_dict().items()}

    model, opt = train_model(weights, where, dtype)
    losses, states = [], [state()]
    for x, y in batches:
        losses.append(train_step(model, opt, torch.from_numpy(x).to(where, dtype),
                                 torch.from_numpy(y).to(where)).item())
        states.append(state())
    return losses, states


def trajectory_limits(ref, refs):
    """The tolerance of a trajectory against `ref` (f64), from the f32
    trajectories `refs`: per step, TRAJ_TIMES x the largest |f32 - f64| of
    `refs` + TRAJ_LOSS_FLOOR x |loss|; per tensor after each step, TRAJ_TIMES
    x the largest max|f32 - f64| of `refs` + TRAJ_TENSOR_FLOOR x the tensor's
    own change (max abs) from its start over the f64 run."""
    (ref_l, ref_s) = ref
    loss = [TRAJ_TIMES * max(abs(r[0][i] - want) for r in refs)
            + TRAJ_LOSS_FLOOR * abs(want) for i, want in enumerate(ref_l)]
    tensor = [{k: TRAJ_TIMES * max((r[1][i][k] - want).abs().max().item()
                                   for r in refs)
               + TRAJ_TENSOR_FLOOR * (want - ref_s[0][k]).abs().max().item()
               for k, want in ref_s[i].items()}
              for i in range(1, len(ref_s))]
    return loss, tensor


def trajectory_ratios(run, ref, limits):
    """{what: |run - ref| / limit} for the loss of every step and every
    tensor after every step (inf where the run is not finite)."""
    import torch

    out = {}
    for i, (got, want, lim) in enumerate(zip(run[0], ref[0], limits[0])):
        out[f"loss of step {i}"] = (abs(got - want) / lim if math.isfinite(got)
                                    else math.inf)
    for i, lims in enumerate(limits[1], start=1):
        for k, lim in lims.items():
            got, want = run[1][i][k], ref[1][i][k]
            err = (got - want).abs().max().item()
            out[f"{k} after step {i}"] = (
                math.inf if not torch.isfinite(got).all()
                else 0.0 if err == 0 else err / lim if lim else math.inf)
    return out


# the planted faults of check_trajectory: the kernel, its wrapper and outputs
FAULTS = {"K3": ("unit_ctr_gc_bwd_param", K3_OUTPUTS),
          "K6": ("unit_ctr_gc_bwd_conv3", K6_OUTPUTS)}


def check_trajectory(weights: str, device, faulted: str = "K3", references=None):
    """TRAJ_STEPS SGD steps from the same weights on the same batches: on the
    card with its kernels (f32), and as references on the CPU in f64 and, for
    the size of f32 rounding, on the CPU in f32 and on the card in f32 with
    the plain unit op. Relu and max-pool decisions at near-ties flip under
    rounding-size changes, each flip moving some gradients: one step's
    gradients in f32 leave the f64 ones by percent, and through ten blocks
    of train-mode BatchNorm the trajectory is chaotic. So the card is held
    to the f64 run, after every step, within trajectory_limits. The same
    check is then run on the card with each output of the kernel `faulted`
    (K3, or K6 with TAMGCN_FUSE_CONV3=1) zeroed in turn, and must fail each
    time. `references` (what an earlier call returned) skips the reference
    runs: they compute the model's math whichever conv3 path the card takes
    (tests/test_torch_conv3.py holds the two within 1e-10 in f64). Returns
    the worst (err / limit), its name and the references."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    if references is None:
        batches = train_batches(TRAJ_STEPS, TRAIN_BATCH)
        ref = trajectory(weights, batches, "cpu", torch.float64)
        refs = [trajectory(weights, batches, "cpu", torch.float32)]
        with plain_unit_op():
            refs.append(trajectory(weights, batches, device, torch.float32))
        references = batches, ref, refs, trajectory_limits(ref, refs)
    batches, ref, refs, limits = references
    card = trajectory(weights, batches, device, torch.float32)
    ratios = trajectory_ratios(card, ref, limits)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])
    print(f"card vs CPU, {TRAJ_STEPS} SGD steps at batch {TRAIN_BATCH}: losses "
          f"card {card[0]}, cpu f32 {refs[0][0]}, card f32 plain unit op "
          f"{refs[1][0]}, cpu f64 {ref[0]}; tolerance after every step: |card "
          f"- f64| <= {TRAJ_TIMES} x max(|cpu f32 - f64|, |card plain - f64|) "
          f"+ {TRAJ_LOSS_FLOOR} x |loss| for the loss, + {TRAJ_TENSOR_FLOOR} "
          f"x the tensor's own change over the f64 run for each tensor; worst "
          f"of {len(ratios)}: " + ", ".join(f"{k} {v:.3f}" for k, v in worst[:5])
          + f"; median {sorted(ratios.values())[len(ratios) // 2]:.3f} of its "
          "limit", flush=True)
    if worst[0][1] > 1:
        raise AssertionError("the card's training trajectory left the CPU's")

    wrapper, outputs = FAULTS[faulted]
    real = getattr(ctr_gc, wrapper)
    for part in outputs:
        def faulty(*args, part=part):
            return tuple(t.zero_() if name == part else t
                         for name, t in zip(outputs, real(*args)))

        with mock.patch.object(ctr_gc, wrapper, faulty):
            f_ratios = trajectory_ratios(
                trajectory(weights, batches, device, torch.float32), ref, limits)
        beyond = sorted((k for k, v in f_ratios.items() if v > 1),
                        key=lambda k: -f_ratios[k])
        print(f"planted fault, {faulted}'s {part} zeroed: {len(beyond)} of "
              f"{len(f_ratios)} beyond their limit, worst "
              + ", ".join(f"{k} {f_ratios[k]:.3f}" for k in beyond[:5]), flush=True)
        if not beyond:
            raise AssertionError(
                f"the trajectory check passed with {faulted}'s {part} zeroed")
    return worst[0][1], worst[0][0], references


def time_train(weights: str, device):
    """Steady-state train step (forward, backward, SGD step) at batch 16
    (kernels, plain unit op, kernels) and 64 (kernels), CUDA events; the
    device time by kernel name at both. Returns a dict of ms."""
    import torch

    out = {}
    for batch in (TRAIN_BATCH, 64):
        model, opt = train_model(weights, device)
        (x, y), = train_batches(1, batch)
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

        def step():
            train_step(model, opt, x, y)

        out[f"kernel_ms_{batch}"] = cuda_ms(step, iters=10)
        if batch == TRAIN_BATCH:
            with plain_unit_op():
                out["plain_ms_16"] = cuda_ms(step, iters=10)
            out["kernel_ms_16"] = min(out["kernel_ms_16"], cuda_ms(step, iters=10))
        busy, n_kernels, events = profile_device(step)
        out.update({f"busy_ms_{batch}": busy, f"n_kernels_{batch}": n_kernels,
                    f"events_{batch}": events})
    return out


def conv3_inputs(shape, seed: int, device):
    """K6's inputs (x1s, x2s, g, x, w3, w4s, b4s, alpha, As): the unit op's
    of unit_inputs, conv3's input x and its weight w3 (Cin, S*C), a
    transposed view of a contiguous (S*C, Cin) tensor as in the model."""
    import torch

    N, T, V, Cin, C, R = shape
    x1s, x2s, _, w4s, b4s, alpha, As, g = unit_inputs((N, T, V, C, R), seed, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((N, T, V, Cin), generator=gen).to(device)
    w3 = (torch.randn((3 * C, Cin), generator=gen) / Cin ** 0.5).to(device).t()
    return x1s, x2s, g, x, w3, w4s, b4s, alpha, As


def check_k6(device):
    """K6 against its plain version at every shape, two launches bitwise
    equal, and the times of K6, its plain version and the unfused
    composition it replaces (K2, dx3s @ w3^T and x^T dx3s by torch.matmul,
    the sum for db3); returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_bwd_conv3_plain as plain
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    k6 = ctr_gc.unit_ctr_gc_bwd_conv3

    def unfused(x1s, x2s, g, x, w3, w4s, b4s, alpha, As):
        dx3s = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        flat = dx3s.reshape(-1, dx3s.shape[-1])
        return (torch.matmul(dx3s, w3.t()),
                torch.matmul(x.reshape(-1, x.shape[-1]).t(), flat), flat.sum(dim=0))

    rows = []
    shapes = [(n, s, c) for n, s, c in K6_MAIN_PATH] + [(n, s, 0) for n, s in K6_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        args = conv3_inputs(shape, seed=500 + i, device=device)
        with torch.no_grad():
            got = k6(*args)
            again = k6(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            for part, a, b in zip(K6_OUTPUTS, got, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"K6 {name} {shape}: two launches differ in {part}")
            errs = [(part,) + _within(a, b, rtol, 1e-4)
                    for part, a, b, rtol in zip(K6_OUTPUTS, got, want, (1e-5, 1e-4, 1e-4))]
            for part, ok, max_err, scale in errs:
                if not ok:
                    raise AssertionError(
                        f"K6 {name} {shape} {part}: max |kernel - plain| {max_err:.3e} "
                        f"(max|plain| {scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: k6(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            unfused_ms = cuda_ms(lambda: unfused(*args))
            # device time alone: the composition's four short kernels can
            # wait on the host between launches
            device_ms = graph_ms(lambda: k6(*args))
            unfused_device_ms = graph_ms(lambda: unfused(*args))
        bound_ms, bound_by = k6_bound(shape)
        check_above_bound(f"K6 {name}", device_ms, bound_ms)
        worst = max(errs, key=lambda e: e[2] / max(e[3], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C", "R"), shape)),
                         launches_per_step=count, max_abs_err=worst[2],
                         max_abs_plain=worst[3], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, unfused_k2_cublas_ms=unfused_ms,
                         device_ms=device_ms,
                         unfused_k2_cublas_device_ms=unfused_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K6 {name:9s} N,T,V,Cin,C,R={shape}: max_abs_err {worst[2]:.3e} in "
              f"{worst[0]} (max|plain| {worst[3]:.3e}) kernel {ms * 1e3:.1f} us "
              f"(device {device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, unfused "
              f"K2+cuBLAS {unfused_ms * 1e3:.1f} us (device {unfused_device_ms * 1e3:.1f}), "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def run_fused_train_path(work_dir: str):
    """--phase train for one epoch with TAMGCN_FUSE_CONV3=1: K6 at the six
    blocks with C >= 128, K2 at the other four; checks the launch counts, the
    losses and the checkpoint. Returns a summary dict."""
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    evals = math.ceil(EVAL_SAMPLES / TRAIN_BATCH)
    with fuse_conv3():
        seconds, launches = run_cli(train_argv(work_dir) + ["--num_epoch", "1"])
    want = {"K1": 10 * (steps + evals), "K2": 4 * steps, "K3": 10 * steps,
            "K5": 0, "K6": 6 * steps, "T1": 0, "T2": 0}
    if launches != want:
        raise AssertionError(
            f"--phase train with TAMGCN_FUSE_CONV3=1: launches {launches}, "
            f"expected {want} (per train step of {steps} K1 10, K2 4, K6 6, K3 "
            f"10; K1 also 10 per eval batch of {evals})")
    progress = check_train_files(work_dir, 1, 1, "fused conv3")
    print(f"train path (TAMGCN_FUSE_CONV3=1): 1 epoch of {steps} steps at batch "
          f"{TRAIN_BATCH} in {seconds:.2f} s (incl. model build, data and eval), "
          f"launches {launches}; progress (train loss, test loss, top1, top5) "
          f"{progress.tolist()}", flush=True)
    return dict(seconds=seconds, launches=launches, progress=progress.tolist())


def time_train_fused(weights: str, device):
    """Steady-state train step at batch 16 and 64 with TAMGCN_FUSE_CONV3=1
    beside the default step, CUDA events in turns default, fused, fused,
    default; the fused step's device time by kernel name. Returns {batch:
    dict}."""
    import torch

    out = {}
    for batch in (TRAIN_BATCH, 64):
        model, opt = train_model(weights, device)
        (x, y), = train_batches(1, batch)
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

        def step():
            train_step(model, opt, x, y)

        ms = {False: [], True: []}
        for fused in (False, True, True, False):
            with fuse_conv3(fused):
                ms[fused].append(cuda_ms(step, iters=10))
        with fuse_conv3():
            busy, n_kernels, events = profile_device(step)
        out[batch] = dict(default_ms=min(ms[False]), fused_ms=min(ms[True]),
                          busy_ms=busy, n_kernels=n_kernels, events=events)
    return out


def check_ctrgc(device):
    """The standalone CTRGC module, forward and backward on the card (K1 and
    K2 at S = 1), against the same module with the plain single-subset op;
    ctr_gc_fused without b4 against ctr_gc_fused_plain; and K4's work on the
    module's operands (K1 and K2 at S = 1) against its plain version, timed.
    Outputs within rtol 1e-5 and atol 1e-5*max, gradients within rtol 1e-4
    and atol 1e-4*max (alpha's, one sum over every term, within rtol 1e-3).
    Returns (rows, launches of the first module's forward and backward)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.models import CTRGC, ctrgcn
    from tamgcn_tpu_torch.ops import aggregation as agg
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    def check(what, got, want, rtol, atol_frac):
        ok, max_err, scale = _within(got, want, rtol, atol_frac)
        if not ok:
            raise AssertionError(f"CTRGC {what}: max |route - plain| {max_err:.3e} "
                                 f"(max|plain| {scale:.3e}) beyond the stated tolerance")
        return max_err, scale

    def fwd_bwd(fn, leaves, g):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*leaves)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    rows, main_launches = [], None
    for i, (name, (N, T, V, Cin, C)) in enumerate(CTRGC_SHAPES):
        gen = torch.Generator().manual_seed(600 + i)
        module = CTRGC(Cin, C, generator=gen)
        with torch.no_grad():
            module.conv4_bias.normal_(0.0, 0.1, generator=gen)
        module.to(device)
        x = torch.randn((N, T, V, Cin), generator=gen).to(device)
        A = torch.rand((V, V), generator=gen).to(device)
        alpha = torch.tensor([0.7], device=device)
        g = torch.randn((N, T, V, C), generator=gen).to(device)

        def run():
            module.zero_grad(set_to_none=True)
            out = fwd_bwd(module, (x, A, alpha), g)
            return out + [p.grad for p in module.parameters()]

        reset_launches()
        got = run()
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != {"K1": 1, "K2": 1, "K3": 0, "K5": 0, "K6": 0, "T1": 0, "T2": 0}:
            raise AssertionError(f"CTRGC {name}: launches {launches}, expected K1 "
                                 "and K2 once each")
        if main_launches is None:
            main_launches = launches["K1"] + launches["K2"]
        with mock.patch.object(ctrgcn, "ctr_gc_fused", agg.ctr_gc_fused_plain):
            want = run()
        names = ["out", "x", "A", "alpha"] + [k for k, _ in module.named_parameters()]
        for what, a, b in zip(names, got, want):
            check(f"{name} {what}", a, b, *((1e-5, 1e-5) if what == "out" else
                                            (1e-3, 0.0) if what == "alpha" else (1e-4, 1e-4)))
        # the op without b4, on the module's operands
        with torch.no_grad():
            x1, x2 = module.conv1(x).mean(dim=1), module.conv2(x).mean(dim=1)
            x3, w4, b4 = module.conv3(x), module.conv4_kernel[0, 0], module.conv4_bias
        ops = (x1, x2, x3, w4, alpha, A)
        for what, a, b in zip(("out", "x1", "x2", "x3", "w4", "alpha", "A"),
                              fwd_bwd(lambda *t: agg.ctr_gc_fused(*t[:4], None, *t[4:]), ops, g),
                              fwd_bwd(lambda *t: agg.ctr_gc_fused_plain(*t[:4], None, *t[4:]),
                                      ops, g)):
            check(f"{name} without b4 {what}", a, b, *((1e-5, 1e-5) if what == "out" else
                                                       (1e-3, 0.0) if what == "alpha"
                                                       else (1e-4, 1e-4)))
        # K4's work: the forward and the x3 gradient at S = 1
        unit = (x1[:, None], x2[:, None], x3, w4[None], b4[None], alpha, A[None])

        def k4():
            return (ctr_gc.unit_ctr_gc_fwd(*unit),
                    ctr_gc.unit_ctr_gc_bwd_dx3(*unit[:2], g, *unit[3:]))

        def k4_plain():
            m = agg.ctr_gc_dynamic_adjacency(x1, x2, w4, b4, alpha, A)
            return agg.ctr_gc_aggregate(m, x3), torch.einsum("nuvc,ntuc->ntvc", m, g)

        with torch.no_grad():
            errs = [(part,) + check(f"{name} K4 {part}", a, b, 1e-5, 1e-5)
                    for part, a, b in zip(("out", "dx3"), k4(), k4_plain())]
            ms = cuda_ms(k4)
            plain_ms = cuda_ms(k4_plain)
        route_ms = cuda_ms(run)
        bound_ms, bound_by = k4_bound((N, T, V, Cin, C))
        worst = max(errs, key=lambda e: e[1] / max(e[2], 1e-30))
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "Cin", "C"),
                                                   (N, T, V, Cin, C))),
                         launches_per_step=int(i == 0), max_abs_err=worst[1],
                         max_abs_plain=worst[2], worst_output=worst[0], ms=ms,
                         plain_ms=plain_ms, module_fwd_bwd_ms=route_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K4 (CTRGC) {name:9s} N,T,V,Cin,C={(N, T, V, Cin, C)}: module forward and "
              f"backward (K1, K2 at S=1) {route_ms:.3f} ms, launches {launches}; K4's work "
              f"(forward + x3 gradient) {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us ({bound_by}), max_abs_err {worst[1]:.3e} in "
              f"{worst[0]} (max|plain| {worst[2]:.3e})", flush=True)
    return rows, main_launches


def t1_inputs(shape, seed: int, device):
    """T1's operands (prefix, w, b, mp_affine) for (N, T, V, bc, stride)."""
    import torch

    N, T, V, bc, _ = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((N, T, V, 3 * bc), generator=g).to(device),
            (torch.randn((2, 5, bc, bc), generator=g) / (5 * bc) ** 0.5).to(device),
            (0.1 * torch.randn((2, bc), generator=g)).to(device),
            torch.stack([1.0 + 0.5 * torch.randn(bc, generator=g),
                         0.3 * torch.randn(bc, generator=g)]).to(device))


def engine_branches(w, b, mp_affine):
    """The fast-eval engine's composition on T1's operands, as
    models/ctrgcn_infer.py:_apply_block runs it from the folded block: two
    F.conv2d on (out, in, k, 1) kernels, F.max_pool2d, the affine and
    torch.cat. The kernels are laid out once, outside the returned call."""
    import torch
    import torch.nn.functional as F

    bc = w.shape[-1]
    kerns = [w[i].permute(2, 1, 0)[..., None].contiguous() for i in range(2)]

    def run(prefix, stride):
        outs = [F.conv2d(prefix[..., i * bc:(i + 1) * bc].permute(0, 3, 1, 2), kerns[i],
                         b[i], stride=(stride, 1), padding=(2 * (i + 1), 0),
                         dilation=(i + 1, 1)).permute(0, 2, 3, 1) for i in range(2)]
        mp = F.max_pool2d(prefix[..., 2 * bc:].permute(0, 3, 1, 2), kernel_size=(3, 1),
                          stride=(stride, 1), padding=(1, 0))
        outs.append(mp.permute(0, 2, 3, 1) * mp_affine[0] + mp_affine[1])
        return torch.cat(outs, dim=-1)

    return run


def check_t1(device):
    """T1 against its plain version at every shape (rtol 1e-5 + atol
    1e-4*max|plain|: each output sums up to 5*bc terms in another order than
    cuDNN's), two launches bitwise equal, and the times of T1, its plain
    version and the engine's composition; returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.cuda.ms_tcn import ms_tcn_fwd
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_plain
    from tamgcn_tpu_torch.utils.roofline import ms_tcn_sol

    rows = []
    from tamgcn_tpu_torch.tools.exp_ms_tcn import SHAPES

    if [(n, t, v, 4 * bc, s) for n, t, v, bc, s in dict(T1_TOOL_SHAPES).values()] \
            != list(SHAPES):
        raise AssertionError(f"T1_TOOL_SHAPES are not exp_ms_tcn's {SHAPES}")
    # weight 1 at each tool shape: the summary is one call at each
    shapes = [(n, s, 1) for n, s in T1_TOOL_SHAPES] + [(n, s, 0) for n, s in T1_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        prefix, w, b, mp = t1_inputs(shape, seed=800 + i, device=device)
        stride = shape[-1]
        library = engine_branches(w, b, mp)
        with torch.no_grad():
            got = ms_tcn_fwd(prefix, w, b, mp, stride)
            again = ms_tcn_fwd(prefix, w, b, mp, stride)
            want = ms_tcn_plain(prefix, w, b, mp, stride)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"T1 {name} {shape}: two launches differ")
            ok, max_err, scale = _within(got, want, 1e-5, 1e-4)
            if not ok:
                raise AssertionError(
                    f"T1 {name} {shape}: max |kernel - plain| {max_err:.3e} (max|plain| "
                    f"{scale:.3e}) beyond the stated tolerance")
            ms = cuda_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride))
            plain_ms = cuda_ms(lambda: ms_tcn_plain(prefix, w, b, mp, stride))
            library_ms = cuda_ms(lambda: library(prefix, stride))
            # device time alone: short launches wait on the host, and the
            # composition is five to seven of them
            device_ms = graph_ms(lambda: ms_tcn_fwd(prefix, w, b, mp, stride))
            library_device_ms = graph_ms(lambda: library(prefix, stride))
        bound_ms, bound_by = ms_tcn_sol(*shape)
        check_above_bound(f"T1 {name}", device_ms, bound_ms)
        rows.append(dict(name=name, shape=dict(zip(("N", "T", "V", "bc", "stride"), shape)),
                         launches_per_step=count, max_abs_err=max_err, max_abs_plain=scale,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         device_ms=device_ms, library_device_ms=library_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"T1 {name:9s} N,T,V,bc,s={shape}: max_abs_err {max_err:.3e} (max|plain| "
              f"{scale:.3e}) kernel {ms * 1e3:.1f} us (device {device_ms * 1e3:.1f}), "
              f"plain {plain_ms * 1e3:.1f} us, engine composition (cuDNN) "
              f"{library_ms * 1e3:.1f} us (device {library_device_ms * 1e3:.1f}), bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def check_t1_real_weights(weights: str, x, device):
    """T1 on the ten folded blocks of the full-width model: operands from
    ms_tcn_operands, prefixes from the model's own K5 blocks in a fast-eval
    forward of the phase-4 batch, each against the plain version on the same
    operands (the tolerance of check_t1). Returns the worst (err, scale)."""
    from unittest import mock

    import torch

    from tamgcn_tpu_torch.models import ctrgcn_infer, get_model
    from tamgcn_tpu_torch.ops.cuda.ms_tcn import ms_tcn_fwd
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_operands, ms_tcn_plain
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    prefixes = []
    real_k5 = ctrgcn_infer.gcn_tcn_block_fused

    def recording(*args):
        prefix, pw = real_k5(*args)
        prefixes.append(prefix)
        return prefix, pw

    with torch.inference_mode():
        folded = ctrgcn_infer.fold_model(model)
        with mock.patch.object(ctrgcn_infer, "gcn_tcn_block_fused", recording):
            ctrgcn_infer.make_fast_eval_fn(model)(folded, torch.from_numpy(x).to(device))
        if len(prefixes) != len(folded["blocks"]):
            raise AssertionError(f"{len(prefixes)} K5 prefixes for "
                                 f"{len(folded['blocks'])} blocks")
        errs = []
        for i, (fb, prefix) in enumerate(zip(folded["blocks"], prefixes)):
            ops = ms_tcn_operands(fb)
            got, want = ms_tcn_fwd(prefix, *ops), ms_tcn_plain(prefix, *ops)
            ok, max_err, scale = _within(got, want, 1e-5, 1e-4)
            if not ok:
                raise AssertionError(
                    f"T1 on block l{i + 1}'s folded weights: max |kernel - plain| "
                    f"{max_err:.3e} (max|plain| {scale:.3e}) beyond the stated tolerance")
            errs.append((max_err, scale))
    worst = max(errs, key=lambda e: e[0] / max(e[1], 1e-30))
    print(f"T1 on the ten folded blocks of the full-width model (K5 prefixes of one "
          f"batch of {BATCH}): worst max_abs_err {worst[0]:.3e} (max|plain| "
          f"{worst[1]:.3e})", flush=True)
    return worst


def t2_inputs(shape, form: str, dtype, seed: int, device):
    """T2's operands for (N, T, V, C, S) in a form's layout: M (V, V, S*C)
    (flattened to (V, V*S*C) for the flat form) and x3 (N, T, V, S*C)
    (flattened to (N, T, V*S*C))."""
    import torch

    N, T, V, C, S = shape
    g = torch.Generator().manual_seed(seed)
    m = (0.05 * torch.randn((V, V, S * C), generator=g)).to(device, dtype)
    x3 = torch.randn((N, T, V, S * C), generator=g).to(device, dtype)
    if form == "flat":
        return m.reshape(V, -1), x3.reshape(N, T, -1)
    return m, x3


def t2_library(m, x3, form: str, S: int, subset_sum: bool):
    """One torch.einsum call computing the form's function (for the diagonal
    forms on the M they expand to, expanded here, outside the timed call)."""
    import torch

    from tamgcn_tpu_torch.ops.stage2 import diag_to_vu, stage2_dims

    mv, xv, N, T, V, L = stage2_dims(m, x3, form, S, subset_sum)
    if form == "floor":
        return lambda: torch.einsum("jul,ntul->ntul", mv, xv)
    m_vu = mv if form == "tile" else diag_to_vu(mv)
    if subset_sum:
        m5, x5 = m_vu.reshape(V, V, S, L // S), xv.reshape(N, T, V, S, L // S)
        return lambda: torch.einsum("vusc,ntvsc->ntuc", m5, x5)
    return lambda: torch.einsum("vul,ntvl->ntul", m_vu, xv)


def check_t2(device):
    """T2 in every form against its plain version at every shape, f32 within
    rtol 1e-5 + atol 1e-5*max|plain| (sums of V terms, S*V with the subset
    sum, in another order); the tile form also on bf16 operands, within one
    rounding of the output (rtol 2^-7, a bf16 ulp, + atol 1e-5*max|plain|);
    two launches bitwise equal; times of T2, its plain version and one
    einsum call. Returns the rows."""
    import torch

    from tamgcn_tpu_torch.ops.cuda import stage2 as t2
    from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain
    from tamgcn_tpu_torch.tools.exp_stage2 import PROBES
    from tamgcn_tpu_torch.utils.roofline import stage2_sol

    # the summary's weights: the probes one exp_stage2 run times at the tool
    # shape in f32 (each launched as often), by (form, subset sum)
    weights = {("flat", True): 1, ("flat", False): 1}
    for _, form in PROBES:
        weights[form, False] = weights.get((form, False), 0) + 1
    rows = []
    k = 0
    for name, shape in T2_SHAPES:
        for form, subset_sum, dtype_name in T2_CASES:
            dtype = getattr(torch, dtype_name)
            k += 1
            N, T, V, C, S = shape
            m, x3 = t2_inputs(shape, form, dtype, seed=900 + k, device=device)
            library = t2_library(m, x3, form, S, subset_sum)
            with torch.no_grad():
                before = t2.launches
                got = stage2_aggregate(m, x3, form, S, subset_sum)
                again = stage2_aggregate(m, x3, form, S, subset_sum)
                if t2.launches != before + 2:
                    raise AssertionError(f"T2 {form}: the dispatcher did not launch T2")
                want = stage2_plain(m, x3, form, S, subset_sum)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"T2 {name} {form}: two launches differ")
                rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
                ok, max_err, scale = _within(got.float(), want.float(), rtol, 1e-5)
                if not ok:
                    raise AssertionError(
                        f"T2 {name} {shape} {form} subset_sum={subset_sum} {dtype}: max "
                        f"|kernel - plain| {max_err:.3e} (max|plain| {scale:.3e}) beyond "
                        "the stated tolerance")
                ms = cuda_ms(lambda: stage2_aggregate(m, x3, form, S, subset_sum))
                plain_ms = cuda_ms(lambda: stage2_plain(m, x3, form, S, subset_sum))
                library_ms = cuda_ms(library)
                device_ms = graph_ms(lambda: stage2_aggregate(m, x3, form, S, subset_sum))
                library_device_ms = graph_ms(library)
            bound_ms, bound_by = stage2_sol(N, T, V, S * C, S if subset_sum else 1,
                                            itemsize=x3.element_size())
            case = f"{form}{' ss' if subset_sum else ''} {str(dtype)[6:]}"
            check_above_bound(f"T2 {name} {case}", device_ms, bound_ms)
            weight = weights.get((form, subset_sum), 0) \
                if name == "tool shape" and dtype == torch.float32 else 0
            rows.append(dict(name=f"{name} {case}", shape=dict(zip("NTVCS", shape)),
                             form=form, subset_sum=subset_sum, dtype=str(dtype),
                             launches_per_step=weight, max_abs_err=max_err,
                             max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, device_ms=device_ms,
                             library_device_ms=library_device_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"T2 {name:10s} N,T,V,C,S={shape} {case:16s}: max_abs_err {max_err:.3e} "
                  f"(max|plain| {scale:.3e}) kernel {ms * 1e3:.1f} us (device "
                  f"{device_ms * 1e3:.1f}), plain {plain_ms * 1e3:.1f} us, einsum "
                  f"{library_ms * 1e3:.1f} us (device {library_device_ms * 1e3:.1f}), bound "
                  f"{bound_ms * 1e3:.1f} us ({bound_by})", flush=True)
    return rows


def run_tools():
    """The three port tools in-process on the card, each with the counts set
    to 0 just before it and read just after; checks each tool's launches.
    Returns {tool: (seconds, launches)}."""
    from tamgcn_tpu_torch.tools import exp_ms_tcn, exp_stage2, exp_stage2b

    def timed(chain, iters, warmup=2):
        return (warmup + iters) * chain  # launches of one time_chained

    expected = {
        "exp_ms_tcn": {"T1": len(exp_ms_tcn.SHAPES) * (1 + timed(60, 10))},
        "exp_stage2": {"K1": len(exp_stage2.PRODUCTION) * timed(30, 5),
                       "T2": (len(exp_stage2.PROBES) + 2) * timed(30, 5) + 1},
        "exp_stage2b": {"K1": exp_stage2b.REPS * timed(30, 10),
                        "T2": exp_stage2b.REPS * (len(exp_stage2b.CANDIDATES) - 1)
                        * timed(30, 10)},
    }
    out = {}
    for tool, mod in (("exp_ms_tcn", exp_ms_tcn), ("exp_stage2", exp_stage2),
                      ("exp_stage2b", exp_stage2b)):
        reset_launches()
        t0 = time.perf_counter()
        mod.main([])
        seconds = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(launches, 0) | expected[tool]
        if launches != want:
            raise AssertionError(f"{tool}: launches {launches}, expected {want}")
        out[tool] = (seconds, launches)
        print(f"tool {tool}: {seconds:.2f} s, launches {launches}", flush=True)
    return out


def kernel_summary(rows, per):
    """Sum of each timing over the launches of one forward / step."""
    used = [r for r in rows if r["launches_per_step"]]

    def total(key):
        return sum(r[key] * r["launches_per_step"] for r in used)

    bound_ms = total("bound_ms")
    ops_ms = sum(r["bound_ms"] * r["launches_per_step"] for r in used
                 if r["bound_by"] == "operations")
    return dict(ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bound_ms / 2 else "bytes",
                per=per)


_START = time.perf_counter()


def phase(name: str):
    print(f"== phase {name} at {time.perf_counter() - _START:.1f} s", flush=True)


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tamgcn_tpu_torch.ops.cuda import build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}",
          flush=True)

    # ---- 3. kernels against their plain versions ----
    phase("3. kernels")
    rows = check_kernels(device)
    print("library_ms: none for K1, K2, K3 (no single PyTorch call computes "
          "the unit op or its gradients)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        weights = os.path.join(work_dir, "weights.pt")
        make_weights(weights, seed=7)

        # ---- 4. test main path ----
        phase("4. test main path")
        test_dir = os.path.join(work_dir, "test")
        seconds, launches = run_test_path(test_dir, weights)
        batches = math.ceil(N_SAMPLES / BATCH)
        if launches != {"K1": 10 * batches, "K2": 0, "K3": 0, "K5": 0, "K6": 0,
                        "T1": 0, "T2": 0}:
            raise AssertionError(
                f"the test phase launched {launches}, expected K1 10 x "
                f"{batches} batches and no backward kernel")
        test_launches = launches["K1"]
        rel, x = check_logits(test_dir, weights)
        kernel_ms, plain_ms, busy_ms, n_kernels, events = time_eval(weights, x, device)
        print(f"test path: {batches} batches of {BATCH} in {seconds:.2f} s (incl. "
              f"model build and data), K1 launches {test_launches}, logits vs "
              f"CPU plain path max rel err {rel:.3e}", flush=True)
        print(f"eval forward, batch {BATCH}: {kernel_ms:.3f} ms/batch "
              f"({BATCH / kernel_ms * 1e3:.1f} samples/s) with K1; {plain_ms:.3f} "
              f"ms/batch with the plain unit op", flush=True)
        print_profile("eval forward", kernel_ms, busy_ms, n_kernels, events)

        # ---- 5. train main path ----
        phase("5. train main path")
        train = run_train_path(os.path.join(work_dir, "train"))
        *_, references = check_trajectory(weights, device)
        t = time_train(weights, device)

        # ---- 6. fast eval ----
        phase("6. fast eval")
        k5_rows = check_k5(device)
        print("library_ms: none for K5 (no single PyTorch call computes the "
              "block)", flush=True)
        fast_dir = os.path.join(work_dir, "fast_eval")
        seconds, launches = run_test_path(fast_dir, weights, "--fast_eval", "true")
        if launches != {"K1": 0, "K2": 0, "K3": 0, "K5": 10 * batches, "K6": 0,
                        "T1": 0, "T2": 0}:
            raise AssertionError(
                f"the fast-eval test phase launched {launches}, expected K5 10 x "
                f"{batches} batches and no other kernel")
        fast_launches = launches["K5"]
        fast_rel, _ = check_logits(fast_dir, weights)
        print(f"fast-eval test path: {batches} batches of {BATCH} in {seconds:.2f} s "
              f"(incl. model build, folding and data), K5 launches {fast_launches}, "
              f"logits vs the unfused CPU model max rel err {fast_rel:.3e}", flush=True)
        fast = time_fast_eval(weights, x, device)
        for way, (ms, busy, n_kernels, events) in fast.items():
            print(f"forward, batch {BATCH}, {way}: {ms:.3f} ms/batch "
                  f"({BATCH / ms * 1e3:.1f} samples/s)", flush=True)
            print_profile(f"forward ({way})", ms, busy, n_kernels, events)

        # ---- 7. fused-conv3 training and CTRGC ----
        phase("7. fused-conv3 training and CTRGC")
        k6_rows = check_k6(device)
        print("library_ms: none for K6 (no single PyTorch call computes it); "
              "the unfused composition's time is under unfused_k2_cublas_ms",
              flush=True)
        fused_train = run_fused_train_path(os.path.join(work_dir, "train_fused"))
        with fuse_conv3():
            check_trajectory(weights, device, faulted="K6", references=references)
        tf = time_train_fused(weights, device)
        k4_rows, k4_launches = check_ctrgc(device)
        print("library_ms: none for K4 (no single PyTorch call computes it)",
              flush=True)

        # ---- 8. experiment kernels T1 and T2 ----
        phase("8. experiment kernels T1 and T2")
        t1_rows = check_t1(device)
        check_t1_real_weights(weights, x, device)
        t2_rows = check_t2(device)
        tools = run_tools()
        phase("end")
    print(f"train step (forward, backward, SGD), batch {TRAIN_BATCH}: "
          f"{t['kernel_ms_16']:.3f} ms ({TRAIN_BATCH / t['kernel_ms_16'] * 1e3:.1f} "
          f"samples/s) with K1-K3; {t['plain_ms_16']:.3f} ms with the plain unit "
          f"op; batch 64: {t['kernel_ms_64']:.3f} ms "
          f"({64 / t['kernel_ms_64'] * 1e3:.1f} samples/s)", flush=True)
    for batch in (64, TRAIN_BATCH):
        events = t[f"events_{batch}"]
        print_profile(f"train step, batch {batch},", t[f"kernel_ms_{batch}"],
                      t[f"busy_ms_{batch}"], t[f"n_kernels_{batch}"], events)
    for kname, prefix in (("K1", "unit_ctr_gc_fwd_kernel"),
                          ("K2", "unit_ctr_gc_bwd_dx3_kernel"),
                          ("K3", "unit_ctr_gc_bwd_param")):
        ms = sum(e[1] for e in t["events_16"] if prefix in e[0])
        print(f"  {kname}: {ms:.4f} ms per train step at batch {TRAIN_BATCH}, "
              f"{100 * ms / t['busy_ms_16']:.1f}% of the device time", flush=True)
    for batch, r in tf.items():
        print(f"train step, batch {batch}: {r['fused_ms']:.3f} ms with "
              f"TAMGCN_FUSE_CONV3=1, {r['default_ms']:.3f} ms default (in turns)",
              flush=True)
        print_profile(f"train step with TAMGCN_FUSE_CONV3=1, batch {batch},",
                      r["fused_ms"], r["busy_ms"], r["n_kernels"], r["events"])
        for kname, prefix in (("K1", "unit_ctr_gc_fwd_kernel"),
                              ("K2", "unit_ctr_gc_bwd_dx3_kernel"),
                              ("K3", "unit_ctr_gc_bwd_param"),
                              ("K6", "unit_ctr_gc_bwd_conv3")):
            ms = sum(e[1] for e in r["events"] if prefix in e[0])
            print(f"  {kname}: {ms:.4f} ms per train step at batch {batch}, "
                  f"{100 * ms / r['busy_ms']:.1f}% of the device time", flush=True)

    sources = {"K1": ("unit_ctr_gc_fwd", "unit_ctr_gc_fwd.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:367",
                      test_launches, "eval forward, batch 64"),
               "K2": ("unit_ctr_gc_bwd_dx3", "unit_ctr_gc_bwd_dx3.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:494",
                      train["train"]["launches"]["K2"], "train step, batch 16"),
               "K3": ("unit_ctr_gc_bwd_param", "unit_ctr_gc_bwd_param.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:717",
                      train["train"]["launches"]["K3"], "train step, batch 16"),
               "K4": ("ctr_gc_fused", "unit_ctr_gc_fwd.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:83", k4_launches,
                      "CTRGC forward and backward, N=16, T=52, V=20, Cin=64, "
                      "C=128 (K1 and K2 at S=1)"),
               "K5": ("gcn_tcn_block", "gcn_tcn_block.cu",
                      "tamgcn_tpu/ops/pallas/gcn_tcn_block.py:52",
                      fast_launches, "fast-eval forward, batch 64"),
               "K6": ("unit_ctr_gc_bwd_conv3", "unit_ctr_gc_bwd_conv3.cu",
                      "tamgcn_tpu/ops/pallas/ctr_gc.py:510",
                      fused_train["launches"]["K6"],
                      "train step, batch 16, TAMGCN_FUSE_CONV3=1"),
               "T1": ("ms_tcn", "ms_tcn.cu", "tools/exp_ms_tcn.py:44",
                      tools["exp_ms_tcn"][1]["T1"],
                      "one call at each of exp_ms_tcn's six shapes; one run of "
                      "the tool launches T1 equally often at each (no model path "
                      "runs T1)"),
               "T2": ("stage2_aggregate", "stage2_aggregate.cu",
                      "tools/exp_stage2.py:134", tools["exp_stage2"][1]["T2"],
                      "one call of each of exp_stage2's twelve T2 probes at "
                      "N=64, T=13, V=20, C=256, S=3, f32 (7 tile, win, 2 floor, "
                      "flat with and without the subset sum); one run of the "
                      "tool launches each probe equally often")}
    rows.update(K4=k4_rows, K5=k5_rows, K6=k6_rows, T1=t1_rows, T2=t2_rows)
    kernels = {}
    for kname, (name, source, replaces, count, per) in sources.items():
        kernels[kname] = {
            "name": name,
            "route": "cuda",
            "source": f"tamgcn_tpu_torch/csrc/{source}",
            "replaces": replaces,
            # launches on the main path's run (test phase for K1, the first
            # two train epochs for K2 and K3, the fused-conv3 epoch for K6,
            # the first CTRGC forward and backward for K4, the exp_ms_tcn
            # run for T1, the exp_stage2 run for T2)
            "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows[kname]),
            "library_ms": None,
            **kernel_summary(rows[kname], per),
            "shapes": rows[kname],
        }
    kernels["K4"]["sources"] = [f"tamgcn_tpu_torch/csrc/{f}" for f in (
        "unit_ctr_gc_fwd.cu", "unit_ctr_gc_bwd_dx3.cu")]
    kernels["K5"]["folded_k1_cublas_ms"] = sum(
        r["folded_k1_cublas_ms"] * r["launches_per_step"] for r in k5_rows)
    for key in ("unfused_k2_cublas_ms", "unfused_k2_cublas_device_ms", "device_ms"):
        kernels["K6"][key] = sum(r[key] * r["launches_per_step"] for r in k6_rows)
    # T1's library call: the engine's cuDNN composition; T2's: one einsum
    for kname in ("T1", "T2"):
        for key in ("library_ms", "device_ms", "library_device_ms"):
            kernels[kname][key] = sum(r[key] * r["launches_per_step"] for r in rows[kname])
    kernels["T2"]["replaces_also"] = [
        "tools/exp_stage2.py:64", "tools/exp_stage2.py:100", "tools/exp_stage2.py:174",
        "tools/exp_stage2b.py:37"]
    kernels = list(kernels.values())
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
