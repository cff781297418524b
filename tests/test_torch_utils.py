"""The port's timing and roofline helpers (tamgcn_tpu_torch/utils), on the
CPU: time_chained's call count and chaining, hard_sync, and the roofline
bounds against numbers worked out by hand at the published H100 SXM peaks."""
import math

import pytest
import torch

from tamgcn_tpu_torch.utils import roofline, timing


def test_time_chained_calls_fn_warmup_plus_iters_times_chain():
    calls, seen = [], []

    def fn(x):
        calls.append(1)
        seen.append(x.item())
        return x + 1

    dt = timing.time_chained(fn, lambda out, a: (out,), (torch.tensor(0.0),),
                             chain=3, iters=2, warmup=1)
    assert len(calls) == (1 + 2) * 3
    assert dt > 0
    # each run starts from the given args and threads every output onward
    assert seen == [0.0, 1.0, 2.0] * 3


def test_hard_sync_sums_every_tensor():
    x = {"a": torch.tensor([-1.0, 2.0]), "b": [torch.tensor(3.0, dtype=torch.bfloat16)]}
    assert timing.hard_sync(x) == 6.0


# K1's and K2's f32 FMAs are held to the 3xTF32 tensor-core rate, 495 / 3
# TFLOP/s: the joint-tiled designs run them there
@pytest.mark.parametrize("shape,want", [
    # l1 at batch 64: 17.10 M f32 values, 68.4 MB (20.4 us), bytes
    ((64, 52, 20, 64, 8), (20.42e-3, "bytes")),
    # l9 at batch 16: 0.221 G FMA (2.68 us at 165 TFLOP/s; 6.60 us at the
    # CUDA cores' 67) below 17.4 MB (5.19 us)
    ((16, 13, 20, 256, 32), (5.191e-3, "bytes")),
    # configs/scene256.yaml l1-l4 at batch 8 (K1t): 4.03 G FMA (48.8 us)
    ((8, 32, 256, 64, 8), (48.81e-3, "operations")),
    # scene256 l9-l10 (K1t): 16.1 G FMA (195.2 us), above 69.6 MB (20.8 us)
    ((8, 8, 256, 256, 32), (195.23e-3, "operations")),
])
def test_unit_ctr_gc_sol(shape, want):
    ms, by = roofline.unit_ctr_gc_sol(*shape)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-3)


@pytest.mark.parametrize("shape,want", [
    # K2 at l1, batch 16: 4.28 M f32 values, 17.1 MB (5.108 us)
    ((16, 52, 20, 64, 8), (5.108e-3, "bytes")),
    # K2t at scene256 l6-l7 and l9-l10, batch 8: the forward's FMAs
    ((8, 16, 256, 128, 16), (78.09e-3, "operations")),
    ((8, 8, 256, 256, 32), (195.23e-3, "operations")),
])
def test_unit_ctr_gc_dx3_sol(shape, want):
    ms, by = roofline.unit_ctr_gc_dx3_sol(*shape)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-3)


def test_scene256_paths_at_the_3xtf32_rate():
    # K1t per scene256 eval forward and K2t per train step (blocks l1-l4 x4,
    # l5, l6-l7 x2, l8, l9-l10 x2): 82.1 G FMA, 0.996 ms at 165 TFLOP/s
    # (2.452 ms at the CUDA cores' 67)
    blocks = [((8, 32, 256, 64, 8), 4), ((8, 32, 256, 128, 8), 1),
              ((8, 16, 256, 128, 16), 2), ((8, 16, 256, 256, 16), 1),
              ((8, 8, 256, 256, 32), 2)]
    for fn in (roofline.unit_ctr_gc_sol, roofline.unit_ctr_gc_dx3_sol):
        ms = sum(k * fn(*shape)[0] for shape, k in blocks)
        assert ms == pytest.approx(0.9957, rel=1e-3)
    assert roofline.TF32X3_FLOPS == pytest.approx(165e12)


@pytest.mark.parametrize("shape,act_bytes,want", [
    # K3 at l1, batch 16: 4.30 M f32 values, 17.2 MB (5.13 us), above 0.167
    # GFLOP (2.49 us)
    ((16, 52, 20, 64, 8), 4, (5.129e-3, "bytes")),
    # K3 at l9, batch 16: dm 0.128 and D^T dm, dm w4^T 0.629 GFLOP (11.30 us)
    # at the f32 peak, where the f32 design's FFMA runs them
    ((16, 13, 20, 256, 32), 4, (11.297e-3, "operations")),
    # K3-bf16 at l9, batch 16: dm 0.128 GFLOP at the bf16 peak (0.13 us) and
    # D^T dm, dm w4^T 0.629 GFLOP at the 3xTF32 rate (3.81 us), above 8.97
    # MB (2.68 us); the bf16 design's tensor-core products (11.30 us at the
    # f32 peak before its redesign)
    ((16, 13, 20, 256, 32), 2, (3.942e-3, "operations")),
    # K3-bf16 at l8, batch 16: 17.3 MB of bf16 activations (5.16 us) above
    # 0.51 GFLOP (2.57 us)
    ((16, 26, 20, 256, 16), 2, (5.156e-3, "bytes")),
])
def test_unit_ctr_gc_param_sol(shape, act_bytes, want):
    ms, by = roofline.unit_ctr_gc_param_sol(*shape, act_bytes=act_bytes)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-3)


@pytest.mark.parametrize("fn,shape,want", [
    # K1 bf16 at l1, batch 64: 17.10 M bf16 activations and 2929 f32
    # parameters, 34.2 MB (10.21 us), above stage 1's 0.079 GFLOP at the
    # bf16 peak and stage 2's 0.511 GFLOP at the f32 peak (7.71 us)
    ("unit_ctr_gc_sol", (64, 52, 20, 64, 8), (10.213e-3, "bytes")),
    # K2 bf16 at l1, batch 16: 4.28 M activations, 8.56 MB (2.556 us)
    ("unit_ctr_gc_dx3_sol", (16, 52, 20, 64, 8), (2.556e-3, "bytes")),
    # K3 bf16 at l1, batch 16: 4.29 M activations and 4658 f32 values, 8.60
    # MB (2.567 us), above dm's 0.128 GFLOP at the bf16 peak and D^T dm, dm
    # w4^T's 0.039 GFLOP at the 3xTF32 rate (0.37 us)
    ("unit_ctr_gc_param_sol", (16, 52, 20, 64, 8), (2.567e-3, "bytes")),
    # K1 bf16 at l9, batch 16: stage 1 (0.315 GFLOP) at the bf16 tensor-core
    # peak and stage 2 (0.128 GFLOP) as two TF32 terms take 0.84 us, below
    # the 8.75 MB (2.612 us)
    ("unit_ctr_gc_sol", (16, 13, 20, 256, 32), (2.612e-3, "bytes")),
    # K1t bf16 at scene256's l1-l4 (V=256, batch 8): stage 1 1.61 GFLOP at
    # the bf16 peak (1.63 us) and the aggregation 6.44 GFLOP as two TF32
    # terms (26.03 us), above 33.8 MB (10.1 us); 40.67 us with the
    # aggregation at the 3xTF32 rate, before its bound followed the card
    ("unit_ctr_gc_sol", (8, 32, 256, 64, 8), (27.659e-3, "operations")),
    # K2t bf16 at scene256's l9-l10: stage 1 25.8 GFLOP (26.06 us) and the
    # aggregation 6.44 GFLOP (26.03 us); 65.10 us before
    ("unit_ctr_gc_dx3_sol", (8, 8, 256, 256, 32), (52.087e-3, "operations")),
])
def test_unit_op_bf16_bounds(fn, shape, want):
    ms, by = getattr(roofline, fn)(*shape, act_bytes=2)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-3)
    f32 = getattr(roofline, fn)(*shape)[0]
    assert ms <= f32


def test_peaks_and_bound_match_the_published_h100():
    assert roofline.HBM_BW == 3.35e12 and roofline.F32_FLOPS == 67e12
    # 3.35e9 / 4 f32 values: 1 ms of bytes; 67e9 FLOP: 1 ms of operations
    assert roofline.bound(3.35e9 / 4, 67e9 / 2) == pytest.approx((1.0, "bytes"))
    assert roofline.bound(1, 67e9) == (1.0, "operations")
    assert roofline.bound(3.35e9 / 2, 0, itemsize=2) == pytest.approx((1.0, "bytes"))
    assert roofline.BF16_FLOPS == 989e12
    assert roofline.bound(1, 67e9 / 2, bf16_flops=989e9 / 2) == pytest.approx(
        (1.0, "operations"))
    assert roofline.bound(1, 165e9, f32_peak=roofline.TF32X3_FLOPS) == pytest.approx(
        (1.0, "operations"))


def test_ms_tcn_and_stage2_bounds():
    # T1 at l2-l4: 25.6 MB moved (7.6 us), bytes; its 0.68 G FMAs at l8 and
    # l9-l10 at the 3xTF32 rate (8.3 us): l8 moves 38.5 MB (11.5 us), bytes,
    # l9-l10 25.7 MB (7.7 us), operations
    ms, by = roofline.ms_tcn_sol(64, 52, 20, 16, 1)
    assert by == "bytes" and ms == pytest.approx(7.63e-3, rel=1e-2)
    ms, by = roofline.ms_tcn_sol(64, 26, 20, 64, 2)
    assert by == "bytes" and ms == pytest.approx(11.5e-3, rel=1e-2)
    ms, by = roofline.ms_tcn_sol(64, 13, 20, 64, 1)
    assert by == "operations" and ms == pytest.approx(8.29e-3, rel=1e-2)
    assert roofline.ms_tcn_sol(3, 7, 20, 5, 2)[0] > 0
    # T2's tile form at the tools' shape: 103 MB (31 us); with the subset
    # sum 69 MB (21 us); bf16 halves the bytes
    ms, by = roofline.stage2_sol(64, 13, 20, 768)
    assert by == "bytes" and ms == pytest.approx(30.9e-3, rel=1e-2)
    ms_ss, _ = roofline.stage2_sol(64, 13, 20, 768, 3)
    assert ms_ss == pytest.approx(20.7e-3, rel=1e-2)
    ms_bf, by_bf = roofline.stage2_sol(64, 13, 20, 768, itemsize=2)
    assert by_bf == "bytes" and math.isclose(ms_bf, ms / 2)


# exp_ms_tcn's six shapes (N, T, V, bc, stride), one call each per tool pass,
# with the bound worked by hand: bytes = 4 * (N*T*V*3bc + N*To*V*3bc + 10bc^2
# + 4bc) over 3.35 TB/s, FMAs 2 * 10 * bc^2 per output row at 165 TFLOP/s
T1_PASS = [((64, 52, 20, 16, 1), 7.6e-3, "bytes"), ((64, 52, 20, 32, 2), 11.5e-3, "bytes"),
           ((64, 26, 20, 32, 1), 7.6e-3, "bytes"), ((64, 26, 20, 64, 2), 11.5e-3, "bytes"),
           ((64, 13, 20, 64, 1), 8.3e-3, "operations"), ((32, 64, 25, 16, 1), 5.9e-3, "bytes")]


@pytest.mark.parametrize("shape, ms, by", T1_PASS, ids=lambda x: str(x))
def test_ms_tcn_bound_per_shape_at_the_3xtf32_rate(shape, ms, by):
    got, got_by = roofline.ms_tcn_sol(*shape)
    assert got_by == by and got == pytest.approx(ms, abs=0.05e-3)


def test_ms_tcn_bound_per_tool_pass():
    # 0.076 ms at the CUDA cores' 67 TFLOP/s, 0.052 ms at 3xTF32's 165
    total = sum(roofline.ms_tcn_sol(*shape)[0] for shape, _, _ in T1_PASS)
    assert total == pytest.approx(0.052, abs=0.5e-3)
    ops = 2 * 64 * 13 * 20 * 2 * 5 * 64 * 64 + 4 * 64 * 13 * 20 * 64
    assert roofline.ms_tcn_sol(64, 13, 20, 64, 1)[0] == pytest.approx(
        ops / roofline.TF32X3_FLOPS * 1e3)


# K6 at the fused-conv3 train step's blocks (N, T, V, Cin, C, R) at batch 16,
# launches per step; K5 at the fast-eval forward's blocks at batch 64
K6_STEP = [((16, 52, 20, 64, 128, 8), 1), ((16, 26, 20, 128, 128, 16), 2),
           ((16, 26, 20, 128, 256, 16), 1), ((16, 13, 20, 256, 256, 32), 2)]
K5_FORWARD = [((64, 52, 20, 3, 64, 8), 1), ((64, 52, 20, 64, 64, 8), 3),
              ((64, 52, 20, 64, 128, 8), 1), ((64, 26, 20, 128, 128, 16), 2),
              ((64, 26, 20, 128, 256, 16), 1), ((64, 13, 20, 256, 256, 32), 2)]


@pytest.mark.parametrize("fn,shape,want", [
    # K6: M and the aggregation as K2, 4*N*T*V*S*C*Cin FLOP of the two
    # products with w3 and x, at 165 TFLOP/s; l9-l10 3.72 GFLOP (22.5 us)
    ("unit_ctr_gc_bwd_conv3_sol", (16, 52, 20, 64, 128, 8), 11.740e-3),
    ("unit_ctr_gc_bwd_conv3_sol", (16, 26, 20, 128, 128, 16), 11.184e-3),
    ("unit_ctr_gc_bwd_conv3_sol", (16, 26, 20, 128, 256, 16), 22.369e-3),
    ("unit_ctr_gc_bwd_conv3_sol", (16, 13, 20, 256, 256, 32), 22.528e-3),
    # K5: M, the aggregation and the five products; l9-l10 12.7 GFLOP
    ("gcn_tcn_block_sol", (64, 52, 20, 3, 64, 8), 10.804e-3),
    ("gcn_tcn_block_sol", (64, 52, 20, 64, 64, 8), 20.098e-3),
    ("gcn_tcn_block_sol", (64, 52, 20, 64, 128, 8), 60.023e-3),
    ("gcn_tcn_block_sol", (64, 26, 20, 128, 128, 16), 38.051e-3),
    ("gcn_tcn_block_sol", (64, 26, 20, 128, 256, 16), 115.756e-3),
    ("gcn_tcn_block_sol", (64, 13, 20, 256, 256, 32), 76.816e-3),
])
def test_block_and_conv3_bounds(fn, shape, want):
    ms, by = getattr(roofline, fn)(*shape)
    assert by == "operations" and ms == pytest.approx(want, rel=1e-3)


def test_fused_step_and_fast_eval_paths_at_the_3xtf32_rate():
    # K6 per fused-conv3 train step at batch 16: 0.1015 ms at 165 TFLOP/s
    # (0.2500 at the CUDA cores' 67); K5 per fast-eval forward at batch 64:
    # 0.4766 ms (1.1737)
    k6 = sum(k * roofline.unit_ctr_gc_bwd_conv3_sol(*shape)[0] for shape, k in K6_STEP)
    k5 = sum(k * roofline.gcn_tcn_block_sol(*shape)[0] for shape, k in K5_FORWARD)
    assert k6 == pytest.approx(0.10153, rel=1e-3)
    assert k5 == pytest.approx(0.47661, rel=1e-3)
    # a ragged block with a down conv (Cin != C) reads wd and bd
    assert roofline.gcn_tcn_block_sol(3, 7, 20, 80, 64, 10)[0] > roofline.gcn_tcn_block_sol(
        3, 7, 20, 64, 64, 10)[0]


@pytest.mark.parametrize("shape,want", [
    # K6-bf16 at l5: stage 1 and the products with w3 and x (1.675 GFLOP) at
    # the bf16 peak, 1.694 us, plus the aggregation (0.256 GFLOP, an f32 M
    # times a bf16 g) as two TF32 terms, 1.033 us, and db3's adds at the
    # 3xTF32 rate, 0.039 us; above the 8.67 MB of bytes (2.59 us)
    ((16, 52, 20, 64, 128, 8), 2.7651e-3),
    ((16, 26, 20, 128, 128, 16), 2.2692e-3),
    ((16, 26, 20, 128, 256, 16), 4.5384e-3),
    # l9-l10: 3.586 GFLOP at the bf16 peak (3.626 us), the aggregation's
    # 0.128 as two TF32 terms (0.516 us), above 7.4 MB (2.21 us); the f32
    # form's bound is 22.5 us
    ((16, 13, 20, 256, 256, 32), 4.1617e-3),
])
def test_conv3_bf16_bounds(shape, want):
    ms, by = roofline.unit_ctr_gc_bwd_conv3_bf16_sol(*shape)
    assert by == "operations" and ms == pytest.approx(want, rel=1e-3)
    assert ms < roofline.unit_ctr_gc_bwd_conv3_sol(*shape)[0]


def test_conv3_bf16_path_and_the_k4_bf16_bound():
    # K6-bf16 per fused-conv3 bf16 train step at batch 16: 0.02017 ms (at
    # 0.02223 if its aggregation were taken at the 3xTF32 rate)
    k6 = sum(k * roofline.unit_ctr_gc_bwd_conv3_bf16_sol(*shape)[0] for shape, k in K6_STEP)
    assert k6 == pytest.approx(0.020165, rel=1e-3)
    # K4-bf16 on one CTRGC forward and backward at N=16, T=52, V=20, C=128,
    # R=8: x3 bf16 in, out f32, g f32 in and dx3 f32 out, 14 bytes a value
    # of (16, 52, 20, 128): 29.85 MB (8.911 us), above M's two products
    # (2 x 13.1 MFLOP) and the forward's aggregation (85.2 MFLOP) as two
    # TF32 terms and the transpose's (85.2 MFLOP) at the 3xTF32 rate
    # (0.97 us)
    ms, by = roofline.ctr_gc_fused_bf16_sol(16, 52, 20, 128, 8)
    assert by == "bytes" and ms == pytest.approx(8.9110e-3, rel=1e-3)
    ms25, by25 = roofline.ctr_gc_fused_bf16_sol(16, 26, 25, 128, 16)
    assert by25 == "bytes" and ms25 == pytest.approx(5.5852e-3, rel=1e-3)
    # the two-term TF32 rate: 247.5 TFLOP/s
    assert roofline.TF32X2_FLOPS == 495e12 / 2
    assert roofline.bound(1, 0, tf32x2_flops=247.5e9) == pytest.approx((1.0, "operations"))


# the NW-UCLA unit-op blocks (N, T, V, C, R) at the training batch, with the
# launches of K1 (and of K2) per train step
UNIT_STEP = [((16, 52, 20, 64, 8), 4), ((16, 52, 20, 128, 8), 1),
             ((16, 26, 20, 128, 16), 2), ((16, 26, 20, 256, 16), 1),
             ((16, 13, 20, 256, 32), 2)]


def test_k1_and_k2_paths_at_the_nucla_batches():
    # every block is bound by its bytes: K1 per train step at batch 16 and
    # K2 (the same values, g in and dx3s out) 0.0615 ms; K1 per eval forward
    # at batch 64 four times that, 0.2457 ms
    k1 = sum(k * roofline.unit_ctr_gc_sol(*shape)[0] for shape, k in UNIT_STEP)
    k2 = sum(k * roofline.unit_ctr_gc_dx3_sol(*shape)[0] for shape, k in UNIT_STEP)
    k1_64 = sum(k * roofline.unit_ctr_gc_sol(64, *shape[1:])[0] for shape, k in UNIT_STEP)
    assert k1 == pytest.approx(0.06150, rel=1e-3)
    assert k2 == pytest.approx(0.06150, rel=1e-3)
    assert k1_64 == pytest.approx(0.24566, rel=1e-3)
    assert all(roofline.unit_ctr_gc_sol(*shape)[1] == "bytes" for shape, _ in UNIT_STEP)


@pytest.mark.parametrize("n,fwd,want", [
    # by hand: ceil(C / 16) channel tiles x N x, for K1, ceil(T / 16) frame
    # tiles (l1-l4 4 x 4, l5 8 x 4, l6-l7 8 x 2, l8 16 x 2, l9-l10 16 x 1),
    # for K2 S = 3 subsets (l1-l4 4 x 3, l5 and l6-l7 8 x 3, l8 and l9-l10
    # 16 x 3)
    (16, True, [256, 512, 256, 512, 256]),
    (64, True, [1024, 2048, 1024, 2048, 1024]),
    (16, False, [192, 384, 384, 768, 768]),
], ids=["K1-batch16", "K1-batch64", "K2-batch16"])
def test_whole_v_blocks_fill_the_card_at_the_main_paths(n, fwd, want):
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    got = [ctr_gc.whole_v_blocks(n, 3, t, c, fwd=fwd) for (_, t, _, c, _), _ in UNIT_STEP]
    assert got == want and min(got) >= 132


def test_whole_v_blocks_at_the_edges():
    from tamgcn_tpu_torch.ops.cuda import ctr_gc

    # the ragged shape: C 80 in 5 tiles, T 7 in one; T 17 and 40 in 2 and 3
    # balanced frame tiles of K1 (K2's blocks walk the frames); one subset
    # (the standalone CTRGC)
    assert ctr_gc.whole_v_blocks(3, 3, 7, 80) == 15
    assert ctr_gc.whole_v_blocks(3, 3, 7, 80, fwd=False) == 45
    assert ctr_gc.whole_v_blocks(1, 3, 17, 16) == 2
    assert ctr_gc.whole_v_blocks(2, 3, 40, 64) == 4 * 3 * 2
    assert ctr_gc.whole_v_blocks(2, 3, 40, 64, fwd=False) == 4 * 3 * 2
    assert ctr_gc.whole_v_blocks(16, 1, 52, 128, fwd=False) == 8 * 16


def test_f32_ab_paths_and_check_modes(tmp_path):
    import os

    from tamgcn_tpu_torch.tools import f32_ab

    table = f32_ab.path_table()
    nucla = {"l1-l4": 4, "l5": 1, "l6-l7": 2, "l8": 1, "l9-l10": 2}
    assert table["K1 per NW-UCLA eval forward, batch 64"] == nucla
    assert table["K1 per NW-UCLA train step, batch 16"] == {
        "train " + name: k for name, k in nucla.items()}
    assert table["K2 per NW-UCLA train step, batch 16"] == nucla
    assert table["K3 per NW-UCLA train step, batch 16"] == nucla
    for key in ("K1t per scene256 eval forward, batch 8", "K2t per scene256 train step, batch 8"):
        assert table[key] == {"scene256 " + name: k for name, k in nucla.items()}
    assert sum(table["K5 per fast-eval forward, batch 64"].values()) == 10
    assert sum(table["K6 per fused-conv3 train step, batch 16"].values()) == 6
    # K1's two NW-UCLA paths at their batches
    k1 = dict(f32_ab.SHAPES["K1"])
    assert {k1[name][0] for name in table["K1 per NW-UCLA eval forward, batch 64"]} == {64}
    assert {k1[name][0] for name in table["K1 per NW-UCLA train step, batch 16"]} == {16}
    # the bf16 forms of K3 and K6 at the NW-UCLA train step's blocks, batch 16
    assert table["K3_bf16 per NW-UCLA bf16 train step, batch 16"] == nucla
    assert table["K6_bf16 per fused-conv3 bf16 train step, batch 16"] == table[
        "K6 per fused-conv3 train step, batch 16"]
    assert {s[0] for _, s in f32_ab.SHAPES["K3_bf16"] + f32_ab.SHAPES["K6_bf16"]} == {16}
    # K3 bitwise to the other tree; the redesigned kernels, the bf16 forms of
    # K3 and K6 among them, to their plain versions
    assert f32_ab.check_mode("K3") == "bitwise"
    assert {f32_ab.check_mode(k) for k in ("K1", "K2", "K5", "K6", "K3_bf16", "K6_bf16")} == {
        "plain"}
    # the bf16 tolerances: bf16 outputs against 2^-7 of max |plain| and a 1%
    # share; K3's f32 outputs as in f32, dalpha at rtol 1e-3
    want = torch.tensor([1.0, -2.0, 0.5, 4.0] * 50).bfloat16()
    near = want.clone()
    near[0] = want[0].float() + 2 ** -7  # one element (0.5%) one bf16 step off
    assert f32_ab.within_plain("K6_bf16", [near] * 3, [want] * 3)
    far = want.float().add(0.05).bfloat16()
    assert not f32_ab.within_plain("K6_bf16", [far, want, want], [want] * 3)
    flipped = want.clone()
    flipped[:4] = -want[:4]  # 2% of the elements
    assert not f32_ab.within_plain("K6_bf16", [flipped, want, want], [want] * 3)
    f32 = torch.linspace(-1.0, 1.0, 64)
    grads = [want, want, f32, f32, torch.tensor([2.0]), f32]
    assert f32_ab.within_plain("K3_bf16", grads, grads)
    assert not f32_ab.within_plain(
        "K3_bf16", grads[:2] + [f32 + 1e-3] + grads[3:], grads)
    assert f32_ab.within_plain(
        "K3_bf16", grads[:4] + [torch.tensor([2.0015])] + grads[5:], grads)
    # an earlier tree's K3_bf16 lives in its f32 source
    csrc = str(tmp_path)
    assert f32_ab.other_source(csrc, "K3_bf16") == (
        os.path.join(csrc, "unit_ctr_gc_bwd_param.cu"),
        ("unit_ctr_gc_bwd_param_scratch_floats", "unit_ctr_gc_bwd_param_bf16"))
    open(os.path.join(csrc, "unit_ctr_gc_bwd_param_bf16.cu"), "w").close()
    assert f32_ab.other_source(csrc, "K3_bf16") == (
        os.path.join(csrc, "unit_ctr_gc_bwd_param_bf16.cu"), f32_ab.ENTRIES["K3_bf16"])


def test_f32_ab_t1_t2_passes_and_tolerances():
    """f32_ab's sums for the experiment kernels are the tools' passes: T1 one
    call at each of exp_ms_tcn's six shapes, T2 exp_stage2's twelve probes
    by form at its shape in f32; both held to their plain versions at phase
    8's tolerances."""
    from tamgcn_tpu_torch.tools import exp_ms_tcn, exp_stage2, f32_ab

    table = f32_ab.path_table()
    t1 = table["T1 per exp_ms_tcn pass, one call at each of its six shapes"]
    shapes = dict(f32_ab.SHAPES["T1"])
    assert [(n, t, v, 4 * bc, s) for n, t, v, bc, s in (shapes[k] for k in t1)] == list(
        exp_ms_tcn.SHAPES)
    assert set(t1.values()) == {1}
    t2 = table["T2 per exp_stage2 pass, its twelve probes"]
    assert sum(t2.values()) == len(exp_stage2.PROBES) + 2
    for form in ("tile", "win", "floor"):
        assert t2[form] == sum(f == form for _, f in exp_stage2.PROBES)
    tool = (exp_stage2.N, exp_stage2.T, exp_stage2.V, exp_stage2.C, exp_stage2.S)
    for name in t2:
        assert dict(f32_ab.SHAPES["T2"])[name][:5] == tool
        assert dict(f32_ab.SHAPES["T2"])[name][7] == "float32"
    assert {f32_ab.check_mode(k) for k in ("T1", "T2")} == {"plain"}
    want = torch.linspace(-1.0, 1.0, 201)
    # T1: atol 1e-4 * max|plain|; T2 in f32: 1e-5
    assert f32_ab.within_plain("T1", [want + 5e-5], [want])
    assert not f32_ab.within_plain("T1", [want + 3e-4], [want])
    assert f32_ab.within_plain("T2", [want + 5e-6], [want])
    assert not f32_ab.within_plain("T2", [want + 5e-5], [want])
    # T2 on bf16 operands: within a bf16 rounding of each output
    wb = want.bfloat16()
    assert f32_ab.within_plain("T2", [wb.float().mul(1 + 2 ** -8).bfloat16()], [wb])
    assert not f32_ab.within_plain("T2", [wb.float().add(0.02).bfloat16()], [wb])


def test_f32_ab_bf16_forms_of_k5_and_t1():
    """f32_ab's K5_bf16 and T1_bf16: the fast-eval blocks at batch 64 (and C
    = 2048 beside them, as K5's) and T1's shapes, summed per path as their
    f32 forms;
    bf16 inputs; held to their plain versions by chip_smoke.py's criterion
    for the two forms (95% of the elements bit for bit, every one within
    2^-7 of max |plain|); K5 and T1 bit for bit to the other tree on
    request."""
    from tamgcn_tpu_torch.tools import f32_ab

    table = f32_ab.path_table()
    assert table["K5_bf16 per fast-eval forward's blocks on bf16 x, batch 64"] == table[
        "K5 per fast-eval forward, batch 64"]
    assert table["T1_bf16 per exp_ms_tcn pass on a bf16 prefix"] == table[
        "T1 per exp_ms_tcn pass, one call at each of its six shapes"]
    assert f32_ab.SHAPES["K5_bf16"] == f32_ab.SHAPES["K5"]
    assert f32_ab.SHAPES["K5"][-1] == ("C=2048", (1, 2, 20, 2048, 2048, 8))
    assert f32_ab.SHAPES["T1_bf16"] == f32_ab.SHAPES["T1"]
    block = f32_ab.kernel_inputs("K5_bf16", (2, 3, 20, 3, 16, 4), 0, "cpu")
    assert block["x"].dtype == torch.bfloat16 and block["w3"].dtype == torch.float32
    t1 = f32_ab.kernel_inputs("T1_bf16", (2, 5, 20, 8, 2), 0, "cpu")
    assert t1[0].dtype == torch.bfloat16 and t1[1].dtype == torch.float32 and t1[-1] == 2
    assert f32_ab.check_mode("K5") == f32_ab.check_mode("T1") == "plain"
    assert {f32_ab.check_mode(k, ("K3", "K5", "T1")) for k in ("K3", "K5", "T1")} == {
        "bitwise"}
    assert {f32_ab.check_mode(k, ("K3", "K5", "T1")) for k in ("K5_bf16", "T1_bf16")} == {
        "plain"}
    want = torch.tensor([1.0, -2.0, 0.5, 4.0] * 50).bfloat16()
    flipped = want.clone()
    flipped[:8] = want[:8].float().mul(1 + 2 ** -7).bfloat16()  # 4% one bf16 step off
    assert f32_ab.within_plain("K5_bf16", [flipped, want], [want, want])
    assert f32_ab.within_plain("T1_bf16", [flipped], [want])
    more = want.clone()
    more[:12] = want[:12].float().mul(1 + 2 ** -7).bfloat16()  # 6%
    assert not f32_ab.within_plain("T1_bf16", [more], [want])
    far = want.clone()
    far[0] = 1.25  # a quarter off, beyond 2^-7 of max |plain|
    assert not f32_ab.within_plain("K5_bf16", [want, far], [want, want])
    assert not f32_ab.within_plain("T1_bf16", [want.float()], [want])


def test_design_ab_patches_only_the_whole_v_rule(tmp_path):
    """tools/design_ab.py builds the whole-V design up to V = 32 and the
    joint-tiled one at every V from copies of csrc/ that differ from it in
    csrc/unit_ctr_gc_whole.cuh's rule alone: kMaxV and the launcher's case
    for 4 joint tiles, or `takes` returning false."""
    import os

    from tamgcn_tpu_torch.ops.cuda import build
    from tamgcn_tpu_torch.tools import design_ab

    for design in ("whole", "tiled"):
        copy = design_ab.patched(build.CSRC, str(tmp_path), design)
        assert sorted(os.listdir(copy)) == sorted(os.listdir(build.CSRC))
        for name in os.listdir(build.CSRC):
            with open(os.path.join(build.CSRC, name)) as f, open(os.path.join(copy, name)) as g:
                a, b = f.read().splitlines(), g.read().splitlines()
            if name != "unit_ctr_gc_whole.cuh":
                assert a == b, name
                continue
            added = [line for line in b if line not in a]
            removed = [line for line in a if line not in b]
            if design == "tiled":
                assert len(a) == len(b) and removed == [design_ab.TAKES + " return V >= 1 && V <= kMaxV; }"]
                assert added == [design_ab.TAKES + " return false; return V >= 1 && V <= kMaxV; }"]
            else:
                assert len(b) == len(a) + 1 and len(removed) == 1
                assert removed[0].startswith(design_ab.MAX_V + "24;")
                assert added[0].startswith(design_ab.MAX_V + "32;")
                assert added[1].startswith("    case 4: return L::template whole<RP, 4>(")
