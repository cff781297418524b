"""K3 (csrc/unit_ctr_gc_bwd_param.cu) against K3 built from another source
with the same C interface, such as an earlier commit's, on one card:

    git show <commit>:tamgcn_tpu_torch/csrc/unit_ctr_gc_bwd_param.cu > work_dir/k3_other.cu
    python -m tamgcn_tpu_torch.tools.k3_ab --other work_dir/k3_other.cu
    python -m tamgcn_tpu_torch.tools.k3_ab --ablate

At the blocks of the NW-UCLA CTR-GCN's train step at batch 16 (full width),
the device time of each by utils/timing.py:graph_ms (a CUDA graph of 20
back-to-back calls), taken in turns this, other, other, this; both are
held to the plain version (rtol 1e-4, atol 1e-4*max|plain|; dalpha rtol
1e-3). With --ablate, this checkout's K3 is built again with each of its
phases skipped in turn (ABLATIONS; the outputs are then wrong and not
checked) and timed the same way, also at configs/scene256.yaml's deepest
block: the time a phase's removal saves is its share. Prints a line per
shape (and per train step) to stderr, and one JSON line with every number
to stdout. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops.aggregation import unit_ctr_gc_param_grads_plain
from ..ops.cuda import build, ctr_gc
from ..utils.roofline import unit_ctr_gc_param_sol
from ..utils.timing import graph_ms
from . import device_name, log

# (block, (N, T, V, C, R), launches per train step) at batch 16
SHAPES = [
    ("l1", (16, 52, 20, 64, 8), 1),
    ("l2-l4", (16, 52, 20, 64, 8), 3),
    ("l5", (16, 52, 20, 128, 8), 1),
    ("l6-l7", (16, 26, 20, 128, 16), 2),
    ("l8", (16, 26, 20, 256, 16), 1),
    ("l9-l10", (16, 13, 20, 256, 32), 2),
]
OUTPUTS = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
ABLATE_SHAPES = SHAPES + [("scene256 l9", (8, 8, 256, 256, 32), 0)]
# the phases of the main kernel, each skipped by making its loop's condition
# false: (name, text of csrc/unit_ctr_gc_bwd_param.cu that starts with the
# loop's header and occurs once)
ABLATIONS = [
    ("staging of g and x3s",
     "for (int base = tid; base < csize; base += kThreads * kBatch) {\n        float gv"),
    ("dm FMAs", "for (int j = 0; j < kTC; ++j) {\n          float gu"),
    ("D = tanh", "for (int i = tid; i < PP * RP; i += kThreads) {\n      const int r = i % RP"),
    ("dA channel sums", "for (int p = tid; p < PP; p += kThreads) {\n      const int iu"),
    ("P = D^T dm", "for (int p = pg; p < PP; p += kG)"),
    ("DD = dm w4^T", "for (int p = tid / kNRQ; p < PP; p += kThreads / kNRQ)"),
    ("dx1, dx2 sums",
     "for (int i = tid; i < 2 * JP * RP; i += kThreads) {\n      const int r = i % RP, row"),
]


def ablated(source: str, anchors) -> str:
    """`source` with the loop each anchor starts with skipped."""
    for anchor in anchors:
        if source.count(anchor) != 1:
            raise ValueError(f"the ablation anchor {anchor[:40]!r}... is not in the "
                             "source exactly once")
        header = anchor[:anchor.index(")") + 1]
        init, cond, step = header.split("; ")
        source = source.replace(anchor, anchor.replace(
            header, f"{init}; false && {cond}; {step}", 1))
    return source


def load_other(source: str, out_dir: str, lib: str = "libk3_other.so"):
    """(scratch_floats, launch) of `source`, built by nvcc with the port's
    flags into out_dir/lib."""
    target = os.path.join(out_dir, lib)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", target, source]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(target)
    fns = []
    for name in ("unit_ctr_gc_bwd_param_scratch_floats", "unit_ctr_gc_bwd_param_f32"):
        _, argtypes, restype = ctr_gc._SIGNATURES[name]
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        fns.append(fn)
    return fns


def call_other(fns, x1s, x2s, g, x3s, w4s, b4s, alpha):
    """The other K3 on the inputs, allocated and launched as the port's
    wrapper does."""
    scratch_floats, launch = fns
    N, S, V, R = x1s.shape
    T, C = g.shape[1], w4s.shape[-1]

    def empty(*shape):
        return torch.empty(shape, device=g.device, dtype=torch.float32)

    outs = (empty(N, S, V, R), empty(N, S, V, R), empty(S, R, C), empty(S, C),
            empty(1), empty(S, V, V))
    scratch = empty(scratch_floats(N, S, V, R, C))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = launch(*[t.data_ptr() for t in (x1s, x2s, g, x3s, w4s, b4s, alpha, *outs,
                                          scratch)], N, S, T, V, R, C, stream)
    if err:
        raise RuntimeError(f"the other K3 returned CUDA error {err}")
    return outs


def inputs(shape, seed, device):
    N, T, V, C, R = shape
    S = 3
    gen = torch.Generator().manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen) * scale).to(device)

    return (randn(N, S, V, R), randn(N, S, V, R), randn(N, T, V, C),
            randn(N, T, V, S * C), randn(S, R, C, scale=0.1), randn(S, C, scale=0.1),
            (torch.rand(1, generator=gen) + 0.5).to(device))


def check(what, got, want):
    for name, a, w in zip(OUTPUTS, got, want):
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        err = (a - w).abs()
        if not torch.isfinite(a).all() or (err > rtol * w.abs() + atol).any():
            raise AssertionError(f"{what} {name}: max |diff| {err.max().item():.3e} "
                                 f"(max|ref| {w.abs().max().item():.3e})")


def ablate(tmp: str, device) -> dict:
    """{variant: {shape: device ms}} of this checkout's K3 and of its builds
    with each phase (and every phase) skipped."""
    with open(os.path.join(build.CSRC, ctr_gc.PARAM_SOURCE)) as f:
        source = f.read()
    variants = [(name, [anchor]) for name, anchor in ABLATIONS]
    variants.append(("every phase", [anchor for _, anchor in ABLATIONS]))
    fns = {}
    for i, (name, anchors) in enumerate(variants):
        path = os.path.join(tmp, f"k3_ablated_{i}.cu")
        with open(path, "w") as f:
            f.write(ablated(source, anchors))
        fns[name] = load_other(path, tmp, f"libk3_ablated_{i}.so")
    out = {}
    for i, (shape_name, shape, _) in enumerate(ABLATE_SHAPES):
        a = inputs(shape, seed=700 + i, device=device)
        out[shape_name] = {"none": graph_ms(lambda: ctr_gc.unit_ctr_gc_bwd_param(*a))}
        for name, _ in variants:
            out[shape_name][name] = graph_ms(lambda: call_other(fns[name], *a))
        log(f"K3 {shape_name:11s} N,T,V,C,R={shape}, device us with the phase skipped: "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in out[shape_name].items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--other", help="the other K3's .cu source")
    mode.add_argument("--ablate", action="store_true",
                      help="time this K3 with each phase skipped in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k3_ab times kernels on the card: CUDA is not available")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device={device} {device_name(device)}; card: {card}")
    if args.ablate:
        with tempfile.TemporaryDirectory(prefix="k3_ab_") as tmp, torch.no_grad():
            print(json.dumps({"card": card, "ablation": ablate(tmp, device)}))
        return 0
    rows = []
    with tempfile.TemporaryDirectory(prefix="k3_ab_") as tmp, torch.no_grad():
        other = load_other(args.other, tmp)
        for i, (name, shape, count) in enumerate(SHAPES):
            a = inputs(shape, seed=700 + i, device=device)
            mine = ctr_gc.unit_ctr_gc_bwd_param(*a)
            theirs = call_other(other, *a)
            plain = unit_ctr_gc_param_grads_plain(*a)
            check(f"K3 {name}", mine, plain)
            check(f"other K3 {name}", theirs, plain)
            ms = {"this": [], "other": []}
            for who in ("this", "other", "other", "this"):
                fn = (lambda: ctr_gc.unit_ctr_gc_bwd_param(*a)) if who == "this" \
                    else (lambda: call_other(other, *a))
                ms[who].append(graph_ms(fn))
            bound_ms, bound_by = unit_ctr_gc_param_sol(*shape)
            N, T, V, C, R = shape
            row = dict(name=name, shape=dict(zip("NTVCR", shape)), launches_per_step=count,
                       this_ms=min(ms["this"]), other_ms=min(ms["other"]),
                       bound_ms=bound_ms, bound_by=bound_by,
                       blocks=ctr_gc.bwd_param_blocks(N, 3, V, C))
            rows.append(row)
            log(f"K3 {name:7s} N,T,V,C,R={shape}: this {row['this_ms'] * 1e3:.1f} us "
                f"({row['blocks']} blocks), other {row['other_ms'] * 1e3:.1f} us, bound "
                f"{bound_ms * 1e3:.1f} us ({bound_by})")
    step = {k: sum(r[k] * r["launches_per_step"] for r in rows)
            for k in ("this_ms", "other_ms", "bound_ms")}
    log(f"K3 per train step at batch 16: this {step['this_ms']:.4f} ms, other "
        f"{step['other_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms")
    print(json.dumps({"card": card, "other": args.other, "per_train_step": step,
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
