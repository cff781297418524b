"""The f32 forms of K1, K2 and K3 of this checkout against the same kernels
built from another directory of sources with the same C interface, such as
an earlier commit's csrc/, on one card:

    mkdir -p work_dir/other && git archive <commit> tamgcn_tpu_torch/csrc | tar -x -C work_dir/other
    python -m tamgcn_tpu_torch.tools.f32_ab --other work_dir/other/tamgcn_tpu_torch/csrc

At the unit-op shapes of the NW-UCLA CTR-GCN at full width (K1 at the eval
batch 64, K2 and K3 at the training batch 16), of configs/scene256.yaml's
five blocks (V=256, batch 8: the joint-tiled K1t and K2t) and at a ragged
V=37, each kernel of this checkout and of the other sources runs on the
same inputs. The whole-V K1 and K2 and K3 must match the other sources bit
for bit; K1t and K2t (the shapes where the launchers take the joint-tiled
design) are held instead to their plain versions at chip_smoke.py's phase-3
tolerance (rtol 1e-5, atol 1e-5 * max|plain|), in this checkout and in the
other. Both are timed by utils/timing.py:graph_ms in turns this, other,
other, this, and summed per path with the launches of each block shape: K1
per NW-UCLA eval forward, K2 and K3 per NW-UCLA train step, K1t per
scene256 eval forward, K2t per scene256 train step. Prints a line per
kernel and shape to stderr and one JSON line with every number to stdout;
exits 1 if any check fails. Needs CUDA and nvcc. tools/k3_ab.py --ablate
builds K3 variants with build_entries and times them with this module's
inputs and launchers.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops.aggregation import unit_ctr_gc_dx3_plain, unit_ctr_gc_plain
from ..ops.cuda import build, ctr_gc
from ..utils.timing import graph_ms
from . import device_name, log

# (block, (N, T, V, C, R)) of each kernel
EVAL = [("l1-l4", (64, 52, 20, 64, 8)), ("l5", (64, 52, 20, 128, 8)),
        ("l6-l7", (64, 26, 20, 128, 16)), ("l8", (64, 26, 20, 256, 16)),
        ("l9-l10", (64, 13, 20, 256, 32))]
TRAIN = [(name, (16,) + shape[1:]) for name, shape in EVAL]
SCENE = [("scene256 l1-l4", (8, 32, 256, 64, 8)), ("scene256 l5", (8, 32, 256, 128, 8)),
         ("scene256 l6-l7", (8, 16, 256, 128, 16)), ("scene256 l8", (8, 16, 256, 256, 16)),
         ("scene256 l9-l10", (8, 8, 256, 256, 32)), ("ragged V=37", (3, 7, 37, 80, 10))]
SHAPES = {"K1": EVAL + SCENE, "K2": TRAIN + SCENE, "K3": TRAIN + SCENE}
# launches of each block shape per eval forward or train step, NW-UCLA and
# scene256
PER_PATH = {"l1-l4": 4, "l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2}
# (sum, kernel, prefix of its shape names)
PATHS = (("K1 per NW-UCLA eval forward, batch 64", "K1", ""),
         ("K2 per NW-UCLA train step, batch 16", "K2", ""),
         ("K3 per NW-UCLA train step, batch 16", "K3", ""),
         ("K1t per scene256 eval forward, batch 8", "K1", "scene256 "),
         ("K2t per scene256 train step, batch 8", "K2", "scene256 "),
         ("K3 per scene256 train step, batch 8", "K3", "scene256 "))
TILED_RTOL = 1e-5  # chip_smoke.py phase 3: rtol and atol / max|plain|
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


def plain(kname, a):
    """K1's or K2's plain version on the inputs."""
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
    if kname == "K1":
        return unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)
    return unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)


def within_plain(out, want) -> bool:
    err = (out - want).abs()
    return bool(torch.isfinite(out).all()) and not bool(
        (err > TILED_RTOL * want.abs() + TILED_RTOL * want.abs().max()).any())


def tiled(kname, shape) -> bool:
    """Whether K1 (K2) takes its joint-tiled design at shape (N, T, V, C, R)."""
    V, R = shape[2], shape[4]
    if kname == "K1":
        return ctr_gc.fwd_variant(3, V, R) == "tiled"
    return kname == "K2" and ctr_gc.dx3_variant(3, V, R) == "tiled"


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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
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
                design = "tiled" if tiled(kname, shape) else "whole"
                if design == "tiled":
                    want = plain(kname, a)
                    check = "within plain"
                    ok = within_plain(mine[0], want) and within_plain(theirs[0], want)
                else:
                    check = "bitwise equal"
                    ok = all(torch.equal(m, t) for m, t in zip(mine, theirs))
                ms = {"this": [], "other": []}
                for who in ("this", "other", "other", "this"):
                    fn = (lambda: this(kname, a)) if who == "this" else (
                        lambda: other(fns, kname, a))
                    ms[who].append(graph_ms(fn))
                row = dict(kernel=kname, name=name, shape=dict(zip("NTVCR", shape)),
                           design=design, check=check, ok=ok, this_ms=min(ms["this"]),
                           other_ms=min(ms["other"]))
                rows.append(row)
                log(f"{kname} {name:16s} N,T,V,C,R={shape} ({design}): {check} {ok}; "
                    f"device this {row['this_ms'] * 1e3:.1f} us, other "
                    f"{row['other_ms'] * 1e3:.1f} us")
    ok = all(r["ok"] for r in rows)
    per_path = {}
    for key, kname, prefix in PATHS:
        mine = [r for r in rows if r["kernel"] == kname and r["name"].startswith(prefix)
                and r["name"][len(prefix):] in PER_PATH]
        per_path[key] = {who: sum(r[who] * PER_PATH[r["name"][len(prefix):]] for r in mine)
                         for who in ("this_ms", "other_ms")}
        log(f"{key}: this {per_path[key]['this_ms']:.4f} ms, other "
            f"{per_path[key]['other_ms']:.4f} ms")
    print(json.dumps({"card": card, "other": args.other, "all_ok": ok,
                      "per_path": per_path, "shapes": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
