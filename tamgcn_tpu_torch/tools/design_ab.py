"""K1 and K2 in their whole-V design against their joint-tiled design, on one
card, at the joints where the two meet:

    python -m tamgcn_tpu_torch.tools.design_ab

Builds this checkout's unit_ctr_gc_fwd.cu and unit_ctr_gc_bwd_dx3.cu from
two copies of csrc/: one in which the whole-V design takes every V up to 32
(csrc/unit_ctr_gc_whole.cuh with kMaxV = 32 and its launcher's case for 4
joint tiles, JT = 4), and one in which it takes no V (its `takes` returns
false), so that the launchers run the joint-tiled design. At V = 20, 24, 25,
28 and 32 and the NW-UCLA widths (T, C, R of blocks l1, l6-l7 and l9-l10 at
batch 16; l6-l7 and l9-l10 at batch 64), both are held to their plain
versions at chip_smoke.py's phase-3 tolerance (rtol 1e-5, atol 1e-5 *
max|plain|), f32 with TF32 off, and timed by utils/timing.py:graph_ms in
turns whole, tiled, tiled, whole. The shipped kMaxV should send each V to
the design that is faster at most of its shapes. Prints a line per kernel
and shape to stderr and one JSON line to stdout; exits 1 if a check fails.
Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile

import torch

from ..ops.aggregation import unit_ctr_gc_dx3_plain, unit_ctr_gc_plain
from ..ops.cuda import build
from ..utils.timing import graph_ms
from . import log
from .f32_ab import build_entries, inputs, other, within

JOINTS = (20, 24, 25, 28, 32)
# (N, T, C, R): NW-UCLA blocks at the training batch and the eval batch
WIDTHS = ((16, 52, 64, 8), (16, 26, 128, 16), (16, 13, 256, 32), (64, 26, 128, 16),
          (64, 13, 256, 32))
TAKES = "__host__ __device__ inline bool takes(int V) {"
MAX_V = "constexpr int kMaxV = "
CASE3 = "    case 3: return L::template whole<RP, 3>("
NAMES = {"K1": ("unit_ctr_gc_fwd.cu", "unit_ctr_gc_fwd_f32"),
         "K2": ("unit_ctr_gc_bwd_dx3.cu", "unit_ctr_gc_bwd_dx3_f32")}


def patched(csrc: str, out_dir: str, design: str) -> str:
    """A copy of csrc in out_dir/design whose whole-V design takes every V
    up to 32 (design "whole") or none ("tiled")."""
    dst = os.path.join(out_dir, f"csrc_{design}")
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, "unit_ctr_gc_whole.cuh")
    with open(path) as f:
        lines = f.read().split("\n")
    out = []
    for line in lines:
        if design == "tiled" and line.startswith(TAKES):
            line = line.replace(TAKES, TAKES + " return false;")
        elif design == "whole" and line.startswith(MAX_V):
            line = MAX_V + "32;" + line[line.index(";") + 1:]
        out.append(line)
        if design == "whole" and line.startswith(CASE3):
            out.append(line.replace("case 3:", "case 4:").replace("<RP, 3>", "<RP, 4>"))
    if out == lines:
        raise RuntimeError(f"{path} has none of the lines design_ab patches")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("design_ab runs kernels on the card: CUDA is not available")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device={device}; card: {card}")
    rows = []
    with tempfile.TemporaryDirectory(prefix="design_ab_") as tmp, torch.no_grad():
        fns = {}
        for design in ("whole", "tiled"):
            csrc = patched(build.CSRC, tmp, design)
            for kname, (source, name) in NAMES.items():
                fns.setdefault(design, {}).update(build_entries(
                    os.path.join(csrc, source), tmp, f"lib{kname}_{design}.so", (name,)))
        for V in JOINTS:
            for i, (N, T, C, R) in enumerate(WIDTHS):
                shape = (N, T, V, C, R)
                a = inputs(shape, seed=800 + i, device=device)
                x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
                for kname in NAMES:
                    want = (unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)
                            if kname == "K1"
                            else unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As))
                    ok = all(within(other(fns[d], kname, a)[0], want, 1e-5, 1e-5)
                             for d in ("whole", "tiled"))
                    ms = {"whole": [], "tiled": []}
                    for d in ("whole", "tiled", "tiled", "whole"):
                        ms[d].append(graph_ms(lambda: other(fns[d], kname, a)))
                    row = dict(kernel=kname, shape=dict(zip("NTVCR", shape)), ok=ok,
                               whole_ms=min(ms["whole"]), tiled_ms=min(ms["tiled"]))
                    rows.append(row)
                    log(f"{kname} N,T,V,C,R={shape}: within plain {ok}; device whole "
                        f"{row['whole_ms'] * 1e3:.1f} us, tiled {row['tiled_ms'] * 1e3:.1f} us")
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"card": card, "all_ok": ok, "shapes": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
