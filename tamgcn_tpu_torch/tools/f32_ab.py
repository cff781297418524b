"""The f32 forms of K1, K2 and K3 of this checkout against the same kernels
built from another directory of sources with the same C interface, such as
an earlier commit's csrc/, on one card:

    mkdir -p work_dir/other && git archive <commit> tamgcn_tpu_torch/csrc | tar -x -C work_dir/other
    python -m tamgcn_tpu_torch.tools.f32_ab --other work_dir/other/tamgcn_tpu_torch/csrc

At the unit-op shapes of the NW-UCLA CTR-GCN at full width (K1 at the eval
batch 64, K2 and K3 at the training batch 16), of configs/scene256.yaml
(V=256, batch 8: the joint-tiled K1 and K2) and a ragged V=37, each kernel
of this checkout and of the other sources runs on the same inputs, and
their outputs are compared bit for bit; both are timed by
utils/timing.py:graph_ms in turns this, other, other, this, and summed per
NW-UCLA path (K1 per eval forward, K2 and K3 per train step). Prints a line
per kernel and shape to stderr and one JSON line with every number to
stdout; exits 1 if any output differs (a redesign that rounds otherwise is
held to the plain versions by chip_smoke.py instead). Needs CUDA and nvcc.
tools/k3_ab.py --ablate builds K3 variants with build_entries and times
them with this module's inputs and launchers.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops.cuda import build, ctr_gc
from ..utils.timing import graph_ms
from . import device_name, log

# (block, (N, T, V, C, R)) of each kernel
EVAL = [("l1-l4", (64, 52, 20, 64, 8)), ("l5", (64, 52, 20, 128, 8)),
        ("l6-l7", (64, 26, 20, 128, 16)), ("l8", (64, 26, 20, 256, 16)),
        ("l9-l10", (64, 13, 20, 256, 32))]
TRAIN = [(name, (16,) + shape[1:]) for name, shape in EVAL]
SCENE = [("scene256 l1-l4", (8, 32, 256, 64, 8)), ("scene256 l9-l10", (8, 8, 256, 256, 32)),
         ("ragged V=37", (3, 7, 37, 80, 10))]
SHAPES = {"K1": EVAL + SCENE, "K2": TRAIN + SCENE, "K3": TRAIN + SCENE}
# launches of each NW-UCLA block shape per eval forward or train step
PER_PATH = {"l1-l4": 4, "l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2}
ENTRIES = {"K1": ("unit_ctr_gc_fwd_f32",),
           "K2": ("unit_ctr_gc_bwd_dx3_f32",),
           "K3": ("unit_ctr_gc_bwd_param_scratch_floats", "unit_ctr_gc_bwd_param_f32")}


def build_entries(source: str, out_dir: str, lib: str, names, include=None) -> dict:
    """{name: ctypes function} of the C entry points `names` of `source`,
    built by nvcc with the port's flags into out_dir/lib, with the argument
    types of ops/cuda/ctr_gc.py. `include`: a directory of headers besides
    the source's own."""
    target = os.path.join(out_dir, lib)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *(["-I", include] if include else []),
           "-o", target, source]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(target)
    fns = {}
    for name in names:
        _, argtypes, restype = ctr_gc._SIGNATURES[name]
        fns[name] = fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, restype
    return fns


def load_other(csrc: str, out_dir: str) -> dict:
    """{entry name: ctypes function} of the other sources' K1, K2 and K3
    (each source includes its own directory's headers)."""
    fns = {}
    for kname, names in ENTRIES.items():
        source = os.path.join(csrc, ctr_gc._SIGNATURES[names[-1]][0])
        fns.update(build_entries(source, out_dir, f"lib{kname}_other.so", names))
    return fns


def inputs(shape, seed, device):
    """(x1s, x2s, x3s, w4s, b4s, alpha, As, g), f32, alpha != 0."""
    N, T, V, C, R = shape
    S = 3
    gen = torch.Generator().manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen) * scale).to(device)

    return (randn(N, S, V, R), randn(N, S, V, R), randn(N, T, V, S * C),
            randn(S, R, C, scale=0.1), randn(S, C, scale=0.1),
            (torch.rand(1, generator=gen) + 0.5).to(device),
            torch.rand((S, V, V), generator=gen).to(device), randn(N, T, V, C))


def this(kname, a):
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
    if kname == "K1":
        return (ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As),)
    if kname == "K2":
        return (ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As),)
    return ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)


def other(fns, kname, a):
    """The other kernel on the inputs, allocated and launched as the port's
    wrapper allocates and launches its own."""
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
    N, S, V, R = x1s.shape
    T, C = g.shape[1], w4s.shape[-1]
    dev = g.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    if kname == "K1":
        outs = (empty(N, T, V, C),)
        ptrs = (x1s, x2s, x3s, w4s, b4s, alpha, As, *outs)
        err = fns["unit_ctr_gc_fwd_f32"](*[t.data_ptr() for t in ptrs], N, S, T, V, R, C,
                                         stream)
    elif kname == "K2":
        outs = (empty(N, T, V, S * C),)
        ptrs = (x1s, x2s, g, w4s, b4s, alpha, As, *outs)
        err = fns["unit_ctr_gc_bwd_dx3_f32"](*[t.data_ptr() for t in ptrs], N, S, T, V, R,
                                             C, stream)
    else:
        outs = (empty(N, S, V, R), empty(N, S, V, R), empty(S, R, C), empty(S, C),
                empty(1), empty(S, V, V))
        scratch = empty(fns["unit_ctr_gc_bwd_param_scratch_floats"](N, S, V, R, C))
        ptrs = (x1s, x2s, g, x3s, w4s, b4s, alpha, *outs, scratch)
        err = fns["unit_ctr_gc_bwd_param_f32"](*[t.data_ptr() for t in ptrs], N, S, T, V,
                                               R, C, stream)
    if err:
        raise RuntimeError(f"the other {kname} returned CUDA error {err}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other csrc directory (unit_ctr_gc_fwd.cu, "
                         "unit_ctr_gc_bwd_dx3.cu, unit_ctr_gc_bwd_param.cu and headers)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("f32_ab runs kernels on the card: CUDA is not available")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device={device} {device_name(device)}; card: {card}")
    rows = []
    with tempfile.TemporaryDirectory(prefix="f32_ab_") as tmp, torch.no_grad():
        fns = load_other(args.other, tmp)
        for kname, shapes in SHAPES.items():
            for i, (name, shape) in enumerate(shapes):
                a = inputs(shape, seed=900 + i, device=device)
                mine, theirs = this(kname, a), other(fns, kname, a)
                torch.cuda.synchronize()
                equal = all(torch.equal(m, t) for m, t in zip(mine, theirs))
                ms = {"this": [], "other": []}
                for who in ("this", "other", "other", "this"):
                    fn = (lambda: this(kname, a)) if who == "this" else (
                        lambda: other(fns, kname, a))
                    ms[who].append(graph_ms(fn))
                row = dict(kernel=kname, name=name, shape=dict(zip("NTVCR", shape)),
                           bitwise_equal=equal, this_ms=min(ms["this"]),
                           other_ms=min(ms["other"]))
                rows.append(row)
                log(f"{kname} {name:16s} N,T,V,C,R={shape}: bitwise equal {equal}; "
                    f"device this {row['this_ms'] * 1e3:.1f} us, other "
                    f"{row['other_ms'] * 1e3:.1f} us")
    same = all(r["bitwise_equal"] for r in rows)
    per_path = {}
    for kname, path in (("K1", "eval forward, batch 64"), ("K2", "train step, batch 16"),
                        ("K3", "train step, batch 16")):
        mine = [r for r in rows if r["kernel"] == kname and r["name"] in PER_PATH]
        per_path[f"{kname} per {path}"] = {
            who: sum(r[who] * PER_PATH[r["name"]] for r in mine)
            for who in ("this_ms", "other_ms")}
        log(f"{kname} per {path}: this {per_path[f'{kname} per {path}']['this_ms']:.4f} "
            f"ms, other {per_path[f'{kname} per {path}']['other_ms']:.4f} ms")
    print(json.dumps({"card": card, "other": args.other, "all_bitwise_equal": same,
                      "per_path": per_path, "shapes": rows}))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
