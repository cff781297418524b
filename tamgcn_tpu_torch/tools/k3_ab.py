"""K3 (csrc/unit_ctr_gc_bwd_param.cu) with each of its phases skipped in
turn, on one card:

    python -m tamgcn_tpu_torch.tools.k3_ab

This checkout's K3 is built again with each phase of its main kernel
skipped (ABLATIONS; the outputs are then wrong and not checked) and timed by
utils/timing.py:graph_ms (a CUDA graph of 20 back-to-back calls) beside the
unchanged K3, at the blocks of the NW-UCLA CTR-GCN's train step at batch 16
(full width) and at configs/scene256.yaml's deepest block: the time a
phase's removal saves is its share. Prints a line per shape to stderr and
one JSON line with every number to stdout. Needs CUDA and nvcc. K1-K3
against another source tree: tools/f32_ab.py.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import torch

from ..ops.cuda import build, ctr_gc
from ..utils.timing import graph_ms
from . import device_name, f32_ab, log

SHAPES = f32_ab.TRAIN + [("scene256 l9", (8, 8, 256, 256, 32))]
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
        fns[name] = f32_ab.build_entries(path, tmp, f"libk3_ablated_{i}.so",
                                         f32_ab.ENTRIES["K3"], include=build.CSRC)
    out = {}
    for i, (shape_name, shape) in enumerate(SHAPES):
        a = f32_ab.inputs(shape, seed=700 + i, device=device)
        out[shape_name] = {"none": graph_ms(lambda: f32_ab.this("K3", a))}
        for name, _ in variants:
            out[shape_name][name] = graph_ms(lambda: f32_ab.other(fns[name], "K3", a))
        log(f"K3 {shape_name:11s} N,T,V,C,R={shape}, device us with the phase skipped: "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in out[shape_name].items()))
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k3_ab times kernels on the card: CUDA is not available")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device={device} {device_name(device)}; card: {card}")
    with tempfile.TemporaryDirectory(prefix="k3_ab_") as tmp, torch.no_grad():
        print(json.dumps({"card": card, "ablation": ablate(tmp, device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
