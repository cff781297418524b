"""The benchmark's counts: the FLOP count equals torch's FlopCounterMode
over the reference at both configurations' full widths, and the kernel
bounds use the data-sheet peaks, never the rate of the unit a kernel
happens to use."""
import inspect

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tgbench import harness, weights
from tgbench.reference import model as ref
from tgbench.work import bounds, flops


# CTR-GCN's NTU-60 cross-subject network (configs/ntu60.yaml), for the
# count's two-person path until a cell of it is added
NTU60 = {"model": {"num_class": 60, "num_point": 25, "num_person": 2, "graph": "ntu_rgb_d",
                   "base_channel": 64, "in_channels": 3}, "time_steps": 64}


@pytest.mark.parametrize("name", ["ctrgcn-nucla", "ntu60"])
def test_flops_match_the_flop_counter(name):
    cfg = NTU60 if name == "ntu60" else harness.load_json(harness.HERE, "configs", f"{name}.json")
    model, t = cfg["model"], cfg["time_steps"]
    w = weights.make(model, 1, "cpu")
    x = torch.randn(2, 3, t, model["num_point"], model["num_person"])
    with FlopCounterMode(display=False) as fwd, torch.no_grad():
        ref.forward(model, w, x)
    assert fwd.get_total_flops() == 2 * flops.forward_per_sample(model, t)
    leaves = {k: v.requires_grad_(True) for k, v in w.items() if "running" not in k}
    with FlopCounterMode(display=False) as both:
        ref.forward(model, {**w, **leaves}, x, train=True).sum().backward()
    assert both.get_total_flops() == 2 * flops.train_per_sample(model, t)


def test_peaks_are_the_data_sheet_dense_peaks():
    assert bounds.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12}
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    source = inspect.getsource(bounds)
    for rate in ("165e12", "67e12", "495e12 / 3", "247.5"):
        assert rate not in source


def test_no_share_can_pass_100_percent():
    """At f32 operands every bound is at least the operations at the TF32
    peak, which no f32 product on the card exceeds."""
    n, t, v, c, r = 16, 52, 20, 64, 8
    ops = 2 * n * 3 * t * v * v * c + 2 * n * 3 * v * v * r * c
    assert bounds.forward_s(n, t, v, c, r) >= ops / 495e12


def test_unit_op_bound_counts_every_block():
    cfg = harness.load_json(harness.HERE, "configs", "ctrgcn-nucla.json")
    fwd = bounds.unit_op_s(cfg["model"], 52, 64, train=False)
    train = bounds.unit_op_s(cfg["model"], 52, 64, train=True)
    assert 0 < fwd < train
    per_block = [bounds.forward_s(64 * m, t, v, c, r)
                 for m, t, _, v, _, c, r, _, _ in flops.blocks(cfg["model"], 52)]
    assert len(per_block) == 10 and fwd == pytest.approx(sum(per_block))
