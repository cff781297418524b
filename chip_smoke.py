#!/usr/bin/env python3
"""On-card smoke test of tamgcn_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be available; prints the CUDA version and the card's
     name and power limit (nvidia-smi);
  2. build: compiles every CUDA source of the port (one nvcc each, all
     started together) and prints the seconds;
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes of the main path (plus V=25 and ragged shapes), f32 with
     TF32 off, within rtol 1e-5 and atol 1e-5*max|plain|, and times both with
     CUDA events;
  4. main path: `python -m tamgcn_tpu_torch recognition --phase test` run
     in-process through `__main__.main` at full NW-UCLA width (base_channel
     64, 10 blocks, T=52, V=20, batch 64, 256 synthetic val samples) on
     weights of the port's seeded init with alpha, the TAM offset conv and the
     gcn1 BN scale perturbed; checks that every kernel was launched (K1: 10
     launches per batch) and that the logits of one batch match the same
     model on the CPU through the plain path; times the eval forward with
     the kernel and with the plain unit op, and lists its device time by
     kernel name (torch.profiler).
The last lines are the card line, the kernels JSON and the result JSON.
The kernels JSON gives, for each kernel, its times and bound summed over the
launches of one eval forward at batch 64, and each shape's row under
"shapes".
"""
from __future__ import annotations

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
LOGIT_RTOL = 1e-4  # |gpu - cpu| <= LOGIT_RTOL * max|cpu|: sum order differs
# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# unit op shapes (N, T, V, C, R), with the launches per forward at N=64
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


def k1_inputs(shape, seed: int, device):
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
    )


def k1_bound(shape):
    """(ms, 'bytes'|'operations'): each input read once and the output
    written once over HBM, or the f32 FMAs (2 ops) over the f32 peak."""
    N, T, V, C, R = shape
    S = 3
    elems = (2 * N * S * V * R + N * T * V * S * C + S * R * C + S * C + 1
             + S * V * V + N * T * V * C)
    bytes_ms = 4 * elems / HBM_BYTES_PER_S * 1e3
    flops = 2 * N * S * (V * V * R * C + T * V * V * C)
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_k1(device):
    import torch

    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_plain
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    rows = []
    shapes = [(name, shape, count) for name, shape, count in K1_MAIN_PATH]
    shapes += [(name, shape, 0) for name, shape in K1_EXTRA]
    for i, (name, shape, count) in enumerate(shapes):
        args = k1_inputs(shape, seed=100 + i, device=device)
        with torch.no_grad():
            got = ctr_gc.unit_ctr_gc_fwd(*args)
            want = unit_ctr_gc_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            scale = want.abs().max().item()
            bad = err > 1e-5 * want.abs() + 1e-5 * scale
            max_err = err.max().item()
            if bad.any() or not torch.isfinite(got).all():
                raise AssertionError(
                    f"K1 {name} {shape}: max |kernel - plain| {max_err:.3e} "
                    f"(max|plain| {scale:.3e}), {int(bad.sum())} elements "
                    "beyond rtol 1e-5 + 1e-5*max|plain|"
                )
            ms = cuda_ms(lambda: ctr_gc.unit_ctr_gc_fwd(*args))
            plain_ms = cuda_ms(lambda: unit_ctr_gc_plain(*args))
        bound_ms, bound_by = k1_bound(shape)
        rows.append(dict(name=name, shape=dict(zip("NTVCR", shape)),
                         launches_per_forward=count, max_abs_err=max_err,
                         max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K1 {name:7s} N,T,V,C,R={shape}: max_abs_err {max_err:.3e} "
              f"(max|plain| {scale:.3e}) kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
              f"({bound_by})", flush=True)
    return rows


def make_weights(path: str, seed: int) -> None:
    """The port's seeded init with what hides the kernel moved off its
    degenerate values (alpha=0 makes M = A, the 1e-6 gcn1.bn scale scales
    the aggregation away, the offset conv starts at zero) and calibrated
    BatchNorm running stats."""
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


def run_main_path(work_dir: str, weights: str):
    """The user's entry point, in-process; returns (seconds, launches)."""
    import torch

    from tamgcn_tpu_torch.__main__ import main
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    argv = [
        "recognition", "-c", os.path.join(REPO, "configs/nucla/smoke.yaml"),
        "--phase", "test", "--weights", weights, "--work_dir", work_dir,
        "--use_gpu", "true", "--device", "0", "--seed", str(SEED),
        "--save_result", "true", "--test_batch_size", str(BATCH),
        "--test_feeder_args", f"num_samples={N_SAMPLES}",
        "--model_args", "base_channel=64",
    ]
    ctr_gc.launches = 0
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"K1": ctr_gc.launches}
    if rc != 0:
        raise AssertionError(f"main returned {rc}")
    return seconds, launches


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


def time_eval(weights: str, x, device):
    """Steady-state eval forward of one batch of 64: with the kernel and
    with the plain version of the unit op swapped in (CUDA events, in turns
    kernel, plain, kernel), and the device time by kernel name over a few
    forwards with the kernel (torch.profiler). Returns (kernel_ms, plain_ms,
    busy_ms, n_kernels, top) with the last three per forward."""
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tamgcn_tpu_torch.models import ctrgcn, get_model
    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_plain
    from tamgcn_tpu_torch.train.checkpoint import load_weights

    model = get_model("ctrgcn", **nucla_model_args())
    model.load_state_dict(load_weights(weights))
    model.to(device).eval()
    xb = torch.from_numpy(x).to(device)
    reps = 5
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: model(xb))
        with mock.patch.object(ctrgcn, "unit_ctr_gc", unit_ctr_gc_plain):
            plain_ms = cuda_ms(lambda: model(xb))
        kernel_ms_2 = cuda_ms(lambda: model(xb))
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                model(xb)
            torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    if not events:
        raise AssertionError("the profiler saw no device time in the eval forward")
    events.sort(key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in events)
    n_kernels = sum(count for _, _, count in events)
    return min(kernel_ms, kernel_ms_2), plain_ms, busy_ms, n_kernels, events[:10]


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
    k1_rows = check_k1(device)
    print("K1 library_ms: none (no single PyTorch call computes the unit op)",
          flush=True)

    # ---- 4. main path ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        weights = os.path.join(work_dir, "weights.pt")
        make_weights(weights, seed=7)
        seconds, launches = run_main_path(work_dir, weights)
        batches = math.ceil(N_SAMPLES / BATCH)
        if launches["K1"] != 10 * batches:
            raise AssertionError(
                f"K1 launched {launches['K1']} times on the main path, "
                f"expected 10 x {batches} batches"
            )
        rel, x = check_logits(work_dir, weights)
        kernel_ms, plain_ms, busy_ms, n_kernels, top = time_eval(weights, x, device)
    print(f"main path: {batches} batches of {BATCH} in {seconds:.2f} s (incl. "
          f"model build and data), K1 launches {launches['K1']}, logits vs "
          f"CPU plain path max rel err {rel:.3e}", flush=True)
    print(f"eval forward, batch {BATCH}: {kernel_ms:.3f} ms/batch "
          f"({BATCH / kernel_ms * 1e3:.1f} samples/s) with K1; {plain_ms:.3f} "
          f"ms/batch with the plain unit op", flush=True)
    print(f"eval forward device time (torch.profiler): {busy_ms:.3f} ms busy "
          f"of {kernel_ms:.3f} ms ({100 * (1 - busy_ms / kernel_ms):.1f}% idle) "
          f"in {n_kernels} kernel launches; top kernels, ms and launches per "
          "forward:", flush=True)
    for name, ms, count in top:
        print(f"  {ms:8.4f} ms {count:4d}x  {name[:100]}", flush=True)

    per_fwd = [r for r in k1_rows if r["launches_per_forward"]]

    def forward_sum(key):
        return sum(r[key] * r["launches_per_forward"] for r in per_fwd)

    bound_ms = forward_sum("bound_ms")
    ops_ms = sum(r["bound_ms"] * r["launches_per_forward"] for r in per_fwd
                 if r["bound_by"] == "operations")
    kernels = [{
        "name": "unit_ctr_gc_fwd",
        "route": "cuda",
        "source": "tamgcn_tpu_torch/csrc/unit_ctr_gc_fwd.cu",
        "replaces": "tamgcn_tpu/ops/pallas/ctr_gc.py:367",
        "launches": launches["K1"],
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        # times and bound: one eval forward at N=64 (its 10 launches)
        "ms": forward_sum("ms"),
        "plain_ms": forward_sum("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bound_ms / 2 else "bytes",
        "library_ms": None,
        "shapes": k1_rows,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
