"""The readers of the program's spans (tgbench/program_spans.py) on a made-up
span table: each gives its ms from the table's totals and the traced steps,
and None where the table is empty, where the program has no table (a
checkout older than it) and off the card."""
import sys
from types import SimpleNamespace

import pytest
import torch

from tamgcn_tpu_torch.utils import spans
from tgbench import harness

BENCH = harness.manifest()
STEPS = 8
TABLE = {"tamgcn.loader.assemble": spans.Total(16, 0.012, 0.004),
         "tamgcn.loader.h2d": spans.Total(16, 0.064, 0.064),
         "tamgcn.train.step": spans.Total(8, 0.0024, 0.0008),
         "tamgcn.loader.wait": spans.Total(9, 0.036, 0.036),
         "tamgcn.eval.pass_end": spans.Total(2, 0.006, 0.006)}
EXPECTED = {"loader_assemble_ms.train": 0.5,  # self seconds over the steps
            "h2d_ms.train": 8.0, "host_step_ms.train": 0.3, "loader_wait_ms.eval": 4.5,
            "h2d_ms.eval": 8.0,
            "pass_end_ms.eval": 3.0}  # seconds over the span's own count


def context(device="cuda"):
    return SimpleNamespace(run=SimpleNamespace(device=torch.device(device, 0)),
                           window=SimpleNamespace(facts={"traced_steps": STEPS}), trace=None)


def test_every_span_metric_has_a_reader_here():
    names = {m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"}
    assert names == set(EXPECTED) | {"loader_wait_ms.train"}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_gives_its_ms(monkeypatch, metric):
    monkeypatch.setattr(spans, "totals", lambda: dict(TABLE))
    assert harness.reader(metric)(context()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_gives_none_on_an_empty_table(monkeypatch, metric):
    monkeypatch.setattr(spans, "totals", dict)
    assert harness.reader(metric)(context()) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_gives_none_without_the_table_or_off_the_card(monkeypatch, metric):
    monkeypatch.setattr(spans, "totals", lambda: dict(TABLE))
    assert harness.reader(metric)(context("cpu")) is None
    # as in a checkout without the table: the import raises
    monkeypatch.delattr(sys.modules["tamgcn_tpu_torch.utils"], "spans")
    monkeypatch.setitem(sys.modules, "tamgcn_tpu_torch.utils.spans", None)
    assert harness.reader(metric)(context()) is None
