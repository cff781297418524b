"""The one A/B tool of the port's kernels: K1, K2, K3, K5 and K6 in f32, the
bf16 forms of K3, K5, K6 and T1 (K3_bf16, K5_bf16, K6_bf16, T1_bf16) and
the experiment kernels T1 and T2 of this checkout against the same kernels
built from another directory of sources with the same C interface, such as
an earlier commit's csrc/, on one card:

    mkdir -p work_dir/other && git archive <commit> tamgcn_tpu_torch/csrc | tar -x -C work_dir/other
    python -m tamgcn_tpu_torch.tools.f32_ab --other work_dir/other/tamgcn_tpu_torch/csrc
    [--kernels T1 T2] [--bitwise K3 K5 T1] [--split]

At the unit-op shapes of the NW-UCLA CTR-GCN at full width (K1 at the eval
batch 64 and at the training batch 16, K2 and K3 at the training batch 16),
of configs/scene256.yaml's five blocks (V=256, batch 8: the joint-tiled K1t
and K2t) and at a ragged V=37, at the fast-eval forward's blocks (K5, batch
64, chip_smoke.py's K5_MAIN_PATH, and C = 2048 beside them) and at the
fused-conv3 train step's (K6, batch 16, K6_MAIN_PATH), each kernel of this
checkout and of the other sources runs on the same inputs. K3 must match
the other sources bit for bit. K1 and K2 (both designs) are held instead to
their plain versions at chip_smoke.py's phase-3 tolerance (rtol 1e-5, atol
1e-5 * max|plain|), K5 at phase 6's (rtol 1e-5, atol 1e-4 * max|plain|) and
K6 at phase 7's (dx rtol 1e-5, dw3 and db3 rtol 1e-4, atol 1e-4 *
max|plain|), in this checkout and in the other, and two launches of this
checkout's K1, K2, K5 and K6 must agree bit for bit. K3_bf16 (the NW-UCLA
train-step blocks) and K6_bf16 (K6's blocks) take bf16 activations and are
held to their bf16 plain versions as chip_smoke.py's phases 10 and 11 hold
them (bf16 outputs within 2^-7 of their max |plain| and equal in all but 1%
of the elements, K3's f32 outputs at rtol 1e-4, atol 1e-4 * max|plain|,
dalpha rtol 1e-3), in both trees, and two launches of this checkout's must
agree bit for bit. K5_bf16 (the fast-eval blocks at batch 64 and C = 2048,
on a bf16 x) and T1_bf16 (T1's shapes on a bf16 prefix) are held to their
bf16 plain versions by chip_smoke.py's criterion for the two forms (at
least 95% of each output's elements bit for bit equal, every element within
2^-7 of max |plain|), in both trees, two launches of this checkout's bit
for bit. `--bitwise` names the kernels held bit for bit to the other
sources in place of their plain versions (K3 by default; K5 and T1 where a
change leaves their f32 forms as they were). T1 (the eval multi-scale TCN,
at exp_ms_tcn's six shapes, and a ragged shape and bc=128 beside them) and
T2 (the stage-2 aggregation: each form of exp_stage2's probes at its shape
in f32, then the tile form on bf16 operands and every f32 form at V=25
beside them) are held likewise, at chip_smoke.py's phase-8 tolerances (T1
rtol 1e-5, atol 1e-4 * max|plain|; T2 rtol 1e-5, in bf16 2^-7, atol 1e-5 *
max|plain|). The other tree's K3_bf16 is built from its
unit_ctr_gc_bwd_param_bf16.cu, or from its unit_ctr_gc_bwd_param.cu where
it has no such source (before K3's bf16 form had one). All are timed by
utils/timing.py:graph_ms in turns this, other, other, this, and summed per
path with the launches of each block shape: K1 per NW-UCLA eval forward and
per train step, K2 and K3 per NW-UCLA train step, K1t per scene256 eval
forward, K2t per scene256 train step, K5 and K5_bf16 per fast-eval
forward's blocks, K6 per train step with TAMGCN_FUSE_CONV3=1, K3_bf16 per
bf16 train step, K6_bf16 per bf16 train step with the switch, T1 and
T1_bf16 per exp_ms_tcn pass (one call at each of its six shapes), T2 per
exp_stage2 pass (its twelve probes: tile 7, win 1, floor 2, flat 1, flat
with the subset sum 1).
Prints a line per kernel and shape to stderr and one JSON line with every
number to stdout; exits 1 if any check fails. Needs CUDA and nvcc.
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

from ..ops.aggregation import (unit_ctr_gc_bwd_conv3_plain, unit_ctr_gc_dx3_plain,
                               unit_ctr_gc_param_grads_plain, unit_ctr_gc_plain)
from ..ops.cuda import build, ctr_gc, gcn_tcn_block, ms_tcn, stage2
from ..ops.gcn_tcn_block import gcn_tcn_block_plain
from ..ops.ms_tcn import ms_tcn_plain
from ..ops.stage2 import RULES, stage2_aggregate, stage2_dims, stage2_plain
from ..utils.timing import graph_ms, graph_split
from . import device_name, log

# (block, (N, T, V, C, R)) of each kernel
EVAL = [("l1-l4", (64, 52, 20, 64, 8)), ("l5", (64, 52, 20, 128, 8)),
        ("l6-l7", (64, 26, 20, 128, 16)), ("l8", (64, 26, 20, 256, 16)),
        ("l9-l10", (64, 13, 20, 256, 32))]
TRAIN = [(name, (16,) + shape[1:]) for name, shape in EVAL]
# K1 at the training batch, named apart from its eval shapes
K1_TRAIN = [("train " + name, shape) for name, shape in TRAIN]
SCENE = [("scene256 l1-l4", (8, 32, 256, 64, 8)), ("scene256 l5", (8, 32, 256, 128, 8)),
         ("scene256 l6-l7", (8, 16, 256, 128, 16)), ("scene256 l8", (8, 16, 256, 256, 16)),
         ("scene256 l9-l10", (8, 8, 256, 256, 32)), ("ragged V=37", (3, 7, 37, 80, 10))]
# (block, (N, T, V, Cin, C, R)) of K5 at the fast-eval batch and of K6 at the
# training batch (chip_smoke.py's K5_MAIN_PATH and K6_MAIN_PATH)
K5_SHAPES = [("l1", (64, 52, 20, 3, 64, 8)), ("l2-l4", (64, 52, 20, 64, 64, 8)),
             ("l5", (64, 52, 20, 64, 128, 8)), ("l6-l7", (64, 26, 20, 128, 128, 16)),
             ("l8", (64, 26, 20, 128, 256, 16)), ("l9-l10", (64, 13, 20, 256, 256, 32))]
K6_SHAPES = [("l5", (16, 52, 20, 64, 128, 8)), ("l6-l7", (16, 26, 20, 128, 128, 16)),
             ("l8", (16, 26, 20, 128, 256, 16)), ("l9-l10", (16, 13, 20, 256, 256, 32))]
# T1 (N, T, V, bc, stride): exp_ms_tcn's six shapes (bc = C/4), then two
# beside them (odd T at stride 2 with bc = 5; bc = 128)
T1_SHAPES = [("l1-l4", (64, 52, 20, 16, 1)), ("l5", (64, 52, 20, 32, 2)),
             ("l6-l7", (64, 26, 20, 32, 1)), ("l8", (64, 26, 20, 64, 2)),
             ("l9-l10", (64, 13, 20, 64, 1)), ("V=25", (32, 64, 25, 16, 1)),
             ("ragged", (3, 7, 20, 5, 2)), ("bc=128", (8, 13, 20, 128, 1))]
# T2 (N, T, V, C, S, form, subset sum, dtype): each form of exp_stage2's
# probes at its shape in f32, then the tile form on bf16 operands and every
# f32 form at V=25
T2_FORMS = [("tile", False), ("win", False), ("floor", False), ("flat", False),
            ("flat", True)]
T2_SHAPES = ([(f"{f}{' ss' if ss else ''}", (64, 13, 20, 256, 3, f, ss, "float32"))
              for f, ss in T2_FORMS]
             + [("tile bf16", (64, 13, 20, 256, 3, "tile", False, "bfloat16"))]
             + [(f"V=25 {f}{' ss' if ss else ''}", (64, 13, 25, 256, 3, f, ss, "float32"))
                for f, ss in T2_FORMS])
# K5 and K5_bf16 beside the fast-eval blocks: C = 2048 (chip_smoke.py's
# K5_EXTRA), where the bf16 form lost to the f32 one
K5_WIDE = [("C=2048", (1, 2, 20, 2048, 2048, 8))]
SHAPES = {"K1": EVAL + K1_TRAIN + SCENE, "K2": TRAIN + SCENE, "K3": TRAIN + SCENE,
          "K5": K5_SHAPES + K5_WIDE,
          "K6": K6_SHAPES, "K3_bf16": TRAIN, "K5_bf16": K5_SHAPES + K5_WIDE,
          "K6_bf16": K6_SHAPES, "T1": T1_SHAPES, "T1_bf16": T1_SHAPES, "T2": T2_SHAPES}
# launches of each block shape per eval forward or train step, NW-UCLA and
# scene256 (K1-K3); per fast-eval forward (K5) and fused train step (K6)
PER_PATH = {"l1-l4": 4, "l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2}
PER_BLOCK = {"K5": {"l1": 1, "l2-l4": 3, "l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2},
             "K6": {"l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2}}
PER_BLOCK["K6_bf16"] = PER_BLOCK["K6"]
PER_BLOCK["K5_bf16"] = PER_BLOCK["K5"]
# one call at each exp_ms_tcn shape; exp_stage2's twelve probes by form
PER_BLOCK["T1"] = PER_BLOCK["T1_bf16"] = {name: 1 for name, _ in T1_SHAPES[:6]}
PER_BLOCK["T2"] = {"tile": 7, "win": 1, "floor": 2, "flat": 1, "flat ss": 1}
# (sum, kernel, prefix of its shape names)
PATHS = (("K1 per NW-UCLA eval forward, batch 64", "K1", ""),
         ("K1 per NW-UCLA train step, batch 16", "K1", "train "),
         ("K2 per NW-UCLA train step, batch 16", "K2", ""),
         ("K3 per NW-UCLA train step, batch 16", "K3", ""),
         ("K1t per scene256 eval forward, batch 8", "K1", "scene256 "),
         ("K2t per scene256 train step, batch 8", "K2", "scene256 "),
         ("K3 per scene256 train step, batch 8", "K3", "scene256 "),
         ("K5 per fast-eval forward, batch 64", "K5", ""),
         ("K5_bf16 per fast-eval forward's blocks on bf16 x, batch 64", "K5_bf16", ""),
         ("K6 per fused-conv3 train step, batch 16", "K6", ""),
         ("K3_bf16 per NW-UCLA bf16 train step, batch 16", "K3_bf16", ""),
         ("K6_bf16 per fused-conv3 bf16 train step, batch 16", "K6_bf16", ""),
         ("T1 per exp_ms_tcn pass, one call at each of its six shapes", "T1", ""),
         ("T1_bf16 per exp_ms_tcn pass on a bf16 prefix", "T1_bf16", ""),
         ("T2 per exp_stage2 pass, its twelve probes", "T2", ""))
UNIT_RTOL = 1e-5  # chip_smoke.py phase 3: rtol and atol / max|plain| of K1, K2
# chip_smoke.py phases 6 and 7: (rtol, atol / max|plain|) per output
K5_TOL = {"prefix": (1e-5, 1e-4), "pw": (1e-5, 1e-4)}
K6_TOL = {"dx": (1e-5, 1e-4), "dw3": (1e-4, 1e-4), "db3": (1e-4, 1e-4)}
# the bf16 forms (chip_smoke.py:BF16_TOL and BF16_SHARE): a bf16 output within
# 2^-7 of its max |plain| and equal in all but 1% of its elements; K3's f32
# outputs (rtol, atol / max|plain|), dalpha at rtol 1e-3 alone
BF16_TOL, BF16_SHARE = 2 ** -7, 0.01
# the bf16 forms of K5 and T1 (chip_smoke.py:BF16_FORM_SHARE, BF16_FORM_TOL):
# at least 95% of each output's elements bit for bit equal, every element
# within 2^-7 of max |plain|
BF16_FORM_SHARE, BF16_FORM_TOL = 0.95, 2 ** -7
K3_BF16_TOL = {"dx1s": "bf16", "dx2s": "bf16", "dw4s": (1e-4, 1e-4), "db4s": (1e-4, 1e-4),
               "dalpha": (1e-3, 0.0), "dAs": (1e-4, 1e-4)}
K6_BF16_TOL = {"dx": "bf16", "dw3": "bf16", "db3": "bf16"}
# chip_smoke.py phase 8: (rtol, atol / max|plain|) of T1 and of T2 in f32;
# T2 on bf16 operands within a bf16 rounding (rtol 2^-7)
T1_TOL, T2_TOL, T2_BF16_TOL = (1e-5, 1e-4), (1e-5, 1e-5), (2 ** -7, 1e-5)
ENTRIES = {"K1": ("unit_ctr_gc_fwd_f32",),
           "K2": ("unit_ctr_gc_bwd_dx3_f32",),
           "K3": ("unit_ctr_gc_bwd_param_scratch_floats", "unit_ctr_gc_bwd_param_f32"),
           "K5": ("gcn_tcn_block_f32",),
           "K6": ("unit_ctr_gc_bwd_conv3_scratch_floats", "unit_ctr_gc_bwd_conv3_f32"),
           "K3_bf16": ("unit_ctr_gc_bwd_param_bf16_scratch_floats", "unit_ctr_gc_bwd_param_bf16"),
           "K6_bf16": ("unit_ctr_gc_bwd_conv3_scratch_floats", "unit_ctr_gc_bwd_conv3_bf16"),
           "K5_bf16": ("gcn_tcn_block_bf16",), "T1": ("ms_tcn_f32",),
           "T1_bf16": ("ms_tcn_bf16",), "T2": ("stage2_aggregate",)}
# an earlier tree's K3_bf16: in the f32 source, with the f32 scratch query
EARLIER_K3_BF16 = (ctr_gc.PARAM_SOURCE,
                   ("unit_ctr_gc_bwd_param_scratch_floats", "unit_ctr_gc_bwd_param_bf16"))
# (source, argument types, return type) of each entry point
SIGNATURES = dict(ctr_gc._SIGNATURES, gcn_tcn_block_f32=(
    gcn_tcn_block.SOURCE, gcn_tcn_block.ARGTYPES, ctypes.c_int),
    gcn_tcn_block_bf16=(gcn_tcn_block.SOURCE, gcn_tcn_block.ARGTYPES, ctypes.c_int),
    ms_tcn_f32=(ms_tcn.SOURCE, ms_tcn.ARGTYPES, ctypes.c_int),
    ms_tcn_bf16=(ms_tcn.SOURCE, ms_tcn.ARGTYPES, ctypes.c_int),
    stage2_aggregate=(stage2.SOURCE, stage2.ARGTYPES, ctypes.c_int))


def build_entries(source: str, out_dir: str, lib: str, names, include=None) -> dict:
    """{name: ctypes function} of the C entry points `names` of `source`,
    built by nvcc with the port's flags into out_dir/lib, with the argument
    types of the port's wrappers. `include`: a directory of headers besides
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
        _, argtypes, restype = SIGNATURES[name]
        fns[name] = fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, restype
    return fns


def other_source(csrc: str, kname: str):
    """(source path, entry names) of kname in the other sources."""
    names = ENTRIES[kname]
    source = os.path.join(csrc, SIGNATURES[names[-1]][0])
    if kname == "K3_bf16" and not os.path.exists(source):
        return os.path.join(csrc, EARLIER_K3_BF16[0]), EARLIER_K3_BF16[1]
    return source, names


def load_other(csrc: str, out_dir: str, knames=tuple(ENTRIES)) -> dict:
    """{entry name: ctypes function} of the other sources' kernels `knames`
    (each source includes its own directory's headers)."""
    fns = {}
    for kname in knames:
        source, names = other_source(csrc, kname)
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


def block_inputs(shape, seed, device):
    """K5's inputs as keywords, as chip_smoke.py:block_inputs makes them:
    alpha != 0, b4 != 0, a non-symmetric A, a BN affine far from (1, 0),
    P = 3C/4, BC = C/4, a down conv where Cin != C."""
    N, T, V, Cin, C, R = shape
    S, P, BC = 3, 3 * C // 4, C // 4
    gen = torch.Generator().manual_seed(seed)

    def w(*s, fan=4):
        return torch.randn(s, generator=gen) / fan ** 0.5

    args = dict(
        x=torch.randn((N, T, V, Cin), generator=gen),
        x1s=torch.randn((N, S, V, R), generator=gen),
        x2s=torch.randn((N, S, V, R), generator=gen),
        w3=w(Cin, S * C, fan=Cin), b3=w(S * C), w4s=w(S, R, C, fan=R), b4s=w(S, C),
        alpha=torch.tensor([0.7]), As=torch.rand((S, V, V), generator=gen),
        gy=torch.stack([1.0 + 0.5 * torch.randn(C, generator=gen),
                        0.3 * torch.randn(C, generator=gen)]),
        wo=w(C, C, fan=C), bo=w(C), wp=w(C, P, fan=C), bp=w(P), wpw=w(C, BC, fan=C),
        bpw=w(BC), wd=None if Cin == C else w(Cin, C, fan=Cin),
        bd=None if Cin == C else w(C))
    return {k: None if a is None else a.to(device) for k, a in args.items()}


def conv3_inputs(shape, seed, device):
    """K6's inputs (x1s, x2s, g, x, w3, w4s, b4s, alpha, As): the unit op's,
    conv3's input x and its weight w3 (Cin, S*C), a transposed view of a
    contiguous (S*C, Cin) tensor as in the model."""
    N, T, V, Cin, C, R = shape
    x1s, x2s, _, w4s, b4s, alpha, As, g = inputs((N, T, V, C, R), seed, device)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((N, T, V, Cin), generator=gen).to(device)
    w3 = (torch.randn((3 * C, Cin), generator=gen) / Cin ** 0.5).to(device).t()
    return x1s, x2s, g, x, w3, w4s, b4s, alpha, As


def t1_inputs(shape, seed, device):
    """T1's operands (prefix, w, b, mp_affine, stride), as chip_smoke.py's
    t1_inputs makes them."""
    N, T, V, bc, stride = shape
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((N, T, V, 3 * bc), generator=gen).to(device),
            (torch.randn((2, 5, bc, bc), generator=gen) / (5 * bc) ** 0.5).to(device),
            (0.1 * torch.randn((2, bc), generator=gen)).to(device),
            torch.stack([1.0 + 0.5 * torch.randn(bc, generator=gen),
                         0.3 * torch.randn(bc, generator=gen)]).to(device), stride)


def t2_inputs(shape, seed, device):
    """T2's operands (m, x3, form, S, subset_sum) in the form's layout, as
    chip_smoke.py's t2_inputs makes them: M (V, V, S*C) and x3 (N, T, V, S*C),
    flattened for the flat form."""
    N, T, V, C, S, form, subset_sum, dtype = shape
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype)
    m = (0.05 * torch.randn((V, V, S * C), generator=gen)).to(device, dtype)
    x3 = torch.randn((N, T, V, S * C), generator=gen).to(device, dtype)
    if form == "flat":
        m, x3 = m.reshape(V, -1), x3.reshape(N, T, -1)
    return m, x3, form, S, subset_sum


def kernel_inputs(kname, shape, seed, device):
    """The inputs of kname at shape; the bf16 forms' activations in bf16
    (K3_bf16: x1s, x2s, x3s, g; K6_bf16: x1s, x2s, g, x, w3; K5_bf16: x;
    T1_bf16: the prefix)."""
    if kname.startswith("T1"):
        a = t1_inputs(shape, seed, device)
        return a if kname == "T1" else (a[0].bfloat16(),) + a[1:]
    if kname == "T2":
        return t2_inputs(shape, seed, device)
    if kname.startswith("K5"):
        a = block_inputs(shape, seed, device)
        return a if kname == "K5" else dict(a, x=a["x"].bfloat16())
    if kname.startswith("K6"):
        a = conv3_inputs(shape, seed, device)
        return a if kname == "K6" else tuple(t.bfloat16() for t in a[:5]) + a[5:]
    a = inputs(shape, seed, device)
    if kname == "K3_bf16":
        a = tuple(t.bfloat16() if i in (0, 1, 2, 7) else t for i, t in enumerate(a))
    return a


def this(kname, a):
    """This checkout's kernel on the inputs, through its wrapper: a tuple of
    outputs."""
    if kname.startswith("T1"):
        return (ms_tcn.ms_tcn_fwd(*a),)
    if kname == "T2":
        return (stage2_aggregate(*a),)
    if kname.startswith("K5"):
        return gcn_tcn_block.gcn_tcn_block_fwd(**a)
    if kname.startswith("K6"):
        return ctr_gc.unit_ctr_gc_bwd_conv3(*a)
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
    if kname == "K1":
        return (ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As),)
    if kname == "K2":
        return (ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As),)
    return ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)


def plain(kname, a):
    """The plain version of kname (but K3) on the inputs: a tuple."""
    if kname.startswith("T1"):
        return (ms_tcn_plain(*a),)
    if kname == "T2":
        return (stage2_plain(*a),)
    if kname.startswith("K5"):
        return gcn_tcn_block_plain(**a)
    if kname.startswith("K6"):
        return unit_ctr_gc_bwd_conv3_plain(*a)
    x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
    if kname == "K3_bf16":
        return unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)
    if kname == "K1":
        return (unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As),)
    return (unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As),)


def within(out, want, rtol, atol_frac) -> bool:
    err = (out - want).abs()
    return bool(torch.isfinite(out).all()) and not bool(
        (err > rtol * want.abs() + atol_frac * want.abs().max()).any())


def bf16_within(out, want) -> bool:
    """A bf16 output within BF16_TOL of max |want|, equal in all but
    BF16_SHARE of its elements."""
    err = (out.float() - want.float()).abs()
    return (out.dtype == want.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
            and err.max().item() <= BF16_TOL * want.float().abs().max().item()
            and (out != want).float().mean().item() <= BF16_SHARE)


def bf16_form_within(out, want) -> bool:
    """A bf16 output of K5_bf16 or T1_bf16: at least BF16_FORM_SHARE of its
    elements bit for bit the plain version's, every one within BF16_FORM_TOL
    of max |want|."""
    a, b = out.float(), want.float()
    return (out.dtype == want.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
            and (a == b).float().mean().item() >= BF16_FORM_SHARE
            and (a - b).abs().max().item() <= BF16_FORM_TOL * b.abs().max().item())


def within_plain(kname, outs, wants) -> bool:
    """Each output within the kernel's tolerance of its plain version."""
    if kname in ("K5_bf16", "T1_bf16"):
        return all(bf16_form_within(o, w) for o, w in zip(outs, wants))
    if kname == "T2" and outs[0].dtype == torch.bfloat16:
        return within(outs[0].float(), wants[0].float(), *T2_BF16_TOL)
    tols = {"T1": [T1_TOL], "T2": [T2_TOL], "K5": list(K5_TOL.values()),
            "K6": list(K6_TOL.values()),
            "K3_bf16": list(K3_BF16_TOL.values()), "K6_bf16": list(K6_BF16_TOL.values())}.get(
        kname, [(UNIT_RTOL, UNIT_RTOL)])
    return all(bf16_within(o, w) if tol == "bf16" else within(o, w, *tol)
               for o, w, tol in zip(outs, wants, tols))


def tiled(kname, shape) -> bool:
    """Whether K1 (K2) takes its joint-tiled design at shape (N, T, V, C, R)."""
    if kname not in ("K1", "K2"):
        return False
    V, R = shape[2], shape[4]
    if kname == "K1":
        return ctr_gc.fwd_variant(3, V, R) == "tiled"
    return ctr_gc.dx3_variant(3, V, R) == "tiled"


def other(fns, kname, a):
    """The other kernel on the inputs, allocated and launched as the port's
    wrapper allocates and launches its own."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    if kname.startswith("T1"):
        prefix, w, b, mp, stride = a
        dev = prefix.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        N, T, V, P = prefix.shape
        outs = (empty(N, -(-T // stride), V, P, dtype=prefix.dtype),)
        err = fns[ENTRIES[kname][0]](*[t.data_ptr() for t in (prefix, w, b, mp, *outs)], N, T,
                                     V, P // 3, stride, stream)
    elif kname == "T2":
        m, x3, form, S, subset_sum = a
        mv, xv, N, T, V, L = stage2_dims(m, x3, form, S, subset_sum)
        dev = x3.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        subsets = S if subset_sum else 1
        out = empty(N, T, V, L // subsets, dtype=x3.dtype)
        err = fns["stage2_aggregate"](mv.data_ptr(), xv.data_ptr(), out.data_ptr(), N, T, V, L,
                                      stage2.RULE_CODES[RULES[form]], subsets,
                                      stage2.DTYPE_CODES[x3.dtype], stream)
        outs = (out.reshape(N, T, -1) if form == "flat" else out,)
    elif kname.startswith("K5"):
        x = a["x"]
        dev = x.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        N, T, V, Cin = x.shape
        S, R = a["x1s"].shape[1], a["x1s"].shape[-1]
        C, P, BC = a["w4s"].shape[-1], a["wp"].shape[-1], a["wpw"].shape[-1]
        # the scratch of this tree's K5, which holds the earlier one's
        y = empty(gcn_tcn_block.scratch_floats_bf16(x.data_ptr(), N, T, V, S, Cin, C, P, BC)
                  if kname == "K5_bf16" else gcn_tcn_block.scratch_floats(N, T, V, S, C))
        outs = (empty(N, T, V, P, dtype=x.dtype), empty(N, T, V, BC, dtype=x.dtype))
        ptrs = [a[k].data_ptr() for k in ("x", "x1s", "x2s", "w3", "b3", "w4s", "b4s",
                                          "alpha", "As", "gy")]
        ptrs += [None, None] if a["wd"] is None else [a["wd"].data_ptr(), a["bd"].data_ptr()]
        ptrs += [a[k].data_ptr() for k in ("wo", "bo", "wp", "bp", "wpw", "bpw")]
        ptrs += [y.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr()]
        err = fns[ENTRIES[kname][0]](*ptrs, N, S, T, V, Cin, R, C, P, BC, stream)
    elif kname.startswith("K6"):
        x1s, x2s, g, x, w3, w4s, b4s, alpha, As = a
        dev = g.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        N, S, V, R = x1s.shape
        T, C, Cin = g.shape[1], w4s.shape[-1], x.shape[-1]
        w3t = w3.t().contiguous()
        dx, dw3t, db3 = (empty(N, T, V, Cin, dtype=g.dtype), empty(S * C, Cin, dtype=g.dtype),
                         empty(S * C, dtype=g.dtype))
        scratch = empty(fns["unit_ctr_gc_bwd_conv3_scratch_floats"](N, S, T, V, R, C, Cin))
        ptrs = (x1s, x2s, g, w4s, b4s, alpha, As, x, w3t, dx, dw3t, db3, scratch)
        err = fns["unit_ctr_gc_bwd_conv3_" + ("f32" if kname == "K6" else "bf16")](
            *[t.data_ptr() for t in ptrs], N, S, T, V, R, C, Cin, stream)
        outs = (dx, dw3t.t(), db3)
    else:
        x1s, x2s, x3s, w4s, b4s, alpha, As, g = a
        N, S, V, R = x1s.shape
        T, C = g.shape[1], w4s.shape[-1]
        dev = g.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kname == "K1":
            outs = (empty(N, T, V, C),)
            ptrs = (x1s, x2s, x3s, w4s, b4s, alpha, As, *outs)
            err = fns["unit_ctr_gc_fwd_f32"](*[t.data_ptr() for t in ptrs], N, S, T, V, R, C,
                                             stream)
        elif kname == "K2":
            outs = (empty(N, T, V, S * C),)
            ptrs = (x1s, x2s, g, w4s, b4s, alpha, As, *outs)
            err = fns["unit_ctr_gc_bwd_dx3_f32"](*[t.data_ptr() for t in ptrs], N, S, T, V,
                                                 R, C, stream)
        else:
            outs = (empty(N, S, V, R, dtype=g.dtype), empty(N, S, V, R, dtype=g.dtype),
                    empty(S, R, C), empty(S, C), empty(1), empty(S, V, V))
            # K3_bf16's scratch query: its own source's, or an earlier tree's f32 one
            query = (fns.get("unit_ctr_gc_bwd_param_bf16_scratch_floats")
                     if kname == "K3_bf16" else None)
            query = query or fns["unit_ctr_gc_bwd_param_scratch_floats"]
            scratch = empty(query(N, S, V, R, C))
            ptrs = (x1s, x2s, g, x3s, w4s, b4s, alpha, *outs, scratch)
            err = fns["unit_ctr_gc_bwd_param_" + ("f32" if kname == "K3" else "bf16")](
                *[t.data_ptr() for t in ptrs], N, S, T, V, R, C, stream)
    if err:
        raise RuntimeError(f"the other {kname} returned CUDA error {err}")
    return outs


def check_mode(kname, bitwise=("K3",)) -> str:
    """How kname is held: "bitwise" to the other sources (the kernels named
    in `bitwise`: K3, and the f32 forms of K5 and T1 where a change leaves
    them as they were), or "plain": within its tolerance of its plain
    version in both trees, two launches of this tree bitwise equal (K1, K2,
    K5, K6 and the bf16 forms: a redesign sums in another order than the
    tree it replaces)."""
    return "bitwise" if kname in bitwise else "plain"


def check(kname, shape, a, fns, bitwise=("K3",)):
    """(design, what was checked, ok) for one kernel at one shape, as
    check_mode says."""
    mine, theirs = this(kname, a), other(fns, kname, a)
    torch.cuda.synchronize()
    if check_mode(kname, bitwise) == "bitwise":
        return "whole", "bitwise equal", all(torch.equal(m, t) for m, t in zip(mine, theirs))
    again = this(kname, a)
    want = plain(kname, a)
    ok = (all(torch.equal(m, t) for m, t in zip(mine, again))
          and within_plain(kname, mine, want) and within_plain(kname, theirs, want))
    design = ("tiled" if tiled(kname, shape) else "whole") if kname in ("K1", "K2") else "-"
    return design, "within plain, two launches bitwise equal", ok


def per_path_count(kname, name, prefix):
    """Launches of the block shape `name` on the path of kname and prefix,
    0 where the shape is not on it."""
    if kname in PER_BLOCK:
        return PER_BLOCK[kname].get(name, 0) if not prefix else 0
    if not name.startswith(prefix):
        return 0
    return PER_PATH.get(name[len(prefix):], 0)


def path_table() -> dict:
    """{path: {shape name: launches on the path}} for every path of PATHS,
    the shapes that are not on it left out."""
    table = {}
    for key, kname, prefix in PATHS:
        counts = {name: per_path_count(kname, name, prefix) for name, _ in SHAPES[kname]}
        table[key] = {name: n for name, n in counts.items() if n}
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other csrc directory (unit_ctr_gc_fwd.cu, "
                         "unit_ctr_gc_bwd_dx3.cu, unit_ctr_gc_bwd_param.cu, "
                         "gcn_tcn_block.cu, unit_ctr_gc_bwd_conv3.cu, ms_tcn.cu, "
                         "stage2_aggregate.cu and headers)")
    ap.add_argument("--kernels", nargs="+", choices=list(SHAPES), default=list(SHAPES),
                    help="the kernels to compare (all by default)")
    ap.add_argument("--bitwise", nargs="+", choices=list(SHAPES), default=["K3"],
                    help="the kernels held bit for bit to the other sources in place of "
                         "their plain versions (K3 by default)")
    ap.add_argument("--split", action="store_true",
                    help="also each shape's device time by kernel of this tree's call "
                         "(utils/timing.py:graph_split), e.g. K6's phase A and phase B")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("f32_ab runs kernels on the card: CUDA is not available")
    device = torch.device("cuda", 0)
    # the plain versions in full f32 (T1's runs on cuDNN's convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device={device} {device_name(device)}; card: {card}")
    rows = []
    with tempfile.TemporaryDirectory(prefix="f32_ab_") as tmp, torch.no_grad():
        fns = load_other(args.other, tmp, args.kernels)
        for kname in args.kernels:
            for i, (name, shape) in enumerate(SHAPES[kname]):
                a = kernel_inputs(kname, shape, seed=900 + i, device=device)
                design, what, ok = check(kname, shape, a, fns, args.bitwise)
                ms = {"this": [], "other": []}
                for who in ("this", "other", "other", "this"):
                    fn = (lambda: this(kname, a)) if who == "this" else (
                        lambda: other(fns, kname, a))
                    ms[who].append(graph_ms(fn))
                keys = {"T1": ("N", "T", "V", "bc", "stride"),
                        "T2": ("N", "T", "V", "C", "S", "form", "subset_sum", "dtype")}.get(
                    kname.removesuffix("_bf16"),
                    "NTVCR" if len(shape) == 5 else ("N", "T", "V", "Cin", "C", "R"))
                row = dict(kernel=kname, name=name, shape=dict(zip(keys, shape)),
                           design=design, check=what, ok=ok, this_ms=min(ms["this"]),
                           other_ms=min(ms["other"]))
                if args.split:
                    row["split_ms"] = graph_split(lambda: this(kname, a))
                    log(f"{kname} {name}: device ms per call by kernel "
                        + json.dumps({k[:60]: round(v, 5) for k, v in row["split_ms"].items()}))
                rows.append(row)
                log(f"{kname} {name:16s} {','.join(keys)}={tuple(shape)} ({design}): {what} {ok}; "
                    f"device this {row['this_ms'] * 1e3:.1f} us, other "
                    f"{row['other_ms'] * 1e3:.1f} us")
    ok = all(r["ok"] for r in rows)
    per_path = {}
    for (key, kname, _), counts in zip(PATHS, path_table().values()):
        if kname not in args.kernels:
            continue
        per_path[key] = {who: sum(r[who] * counts.get(r["name"], 0)
                                  for r in rows if r["kernel"] == kname)
                         for who in ("this_ms", "other_ms")}
        log(f"{key}: this {per_path[key]['this_ms']:.4f} ms, other "
            f"{per_path[key]['other_ms']:.4f} ms")
    print(json.dumps({"card": card, "other": args.other, "all_ok": ok,
                      "per_path": per_path, "shapes": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
