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


@pytest.mark.parametrize("shape,want", [
    # l1 at batch 64: 17.10 M f32 values, 68.4 MB (20.4 us), bytes
    ((64, 52, 20, 64, 8), (20.42e-3, "bytes")),
    # l9 at batch 16: 0.221 G FMA (6.60 us) above 17.4 MB (5.19 us)
    ((16, 13, 20, 256, 32), (6.603e-3, "operations")),
])
def test_unit_ctr_gc_sol(shape, want):
    ms, by = roofline.unit_ctr_gc_sol(*shape)
    assert by == want[1] and ms == pytest.approx(want[0], rel=1e-3)


def test_peaks_and_bound_match_the_published_h100():
    assert roofline.HBM_BW == 3.35e12 and roofline.F32_FLOPS == 67e12
    # 3.35e9 / 4 f32 values: 1 ms of bytes; 67e9 FLOP: 1 ms of operations
    assert roofline.bound(3.35e9 / 4, 67e9 / 2) == pytest.approx((1.0, "bytes"))
    assert roofline.bound(1, 67e9) == (1.0, "operations")
    assert roofline.bound(3.35e9 / 2, 0, itemsize=2) == pytest.approx((1.0, "bytes"))


def test_ms_tcn_and_stage2_bounds():
    # T1 at l2-l4: 25.6 MB moved (7.6 us), bytes; at l8 and l9-l10 0.68 G
    # FMAs (20 us), operations
    ms, by = roofline.ms_tcn_sol(64, 52, 20, 16, 1)
    assert by == "bytes" and ms == pytest.approx(7.63e-3, rel=1e-2)
    for shape in ((64, 26, 20, 64, 2), (64, 13, 20, 64, 1)):
        ms, by = roofline.ms_tcn_sol(*shape)
        assert by == "operations" and ms == pytest.approx(20.4e-3, rel=1e-2)
    assert roofline.ms_tcn_sol(3, 7, 20, 5, 2)[0] > 0
    # T2's tile form at the tools' shape: 103 MB (31 us); with the subset
    # sum 69 MB (21 us); bf16 halves the bytes
    ms, by = roofline.stage2_sol(64, 13, 20, 768)
    assert by == "bytes" and ms == pytest.approx(30.9e-3, rel=1e-2)
    ms_ss, _ = roofline.stage2_sol(64, 13, 20, 768, 3)
    assert ms_ss == pytest.approx(20.7e-3, rel=1e-2)
    ms_bf, by_bf = roofline.stage2_sol(64, 13, 20, 768, itemsize=2)
    assert by_bf == "bytes" and math.isclose(ms_bf, ms / 2)
