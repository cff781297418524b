"""The check that decides `correct` can fail: each cell driven through the
harness on the CPU at a small size (the look for a card skipped), with the
timed path broken underneath by each fault the cell can have, and with the
lower-precision control (the program's own bf16 path), must come out not
correct; the sound run, correct. On the card the same readings at each
cell's own size come from tgbench/tools/readings.py."""
import time

import pytest
import torch

from tgbench import harness

BENCH = harness.manifest()
SEED = 2 ** 31 + 11
CELLS = {"nucla-train": ("state_unchanged", "half_batch", "answer_altered"),
         "nucla-eval": ("half_batch", "answer_altered")}


@pytest.fixture(autouse=True)
def no_mkldnn():
    # the CPU build's oneDNN corrupts the heap in a train-mode backward of
    # the small CTR-GCN at some shapes; the plain kernels avoid it
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def small(run):
    t, cfg = run.config["trainer"], run.config
    t.update(debug=True, batch_size=8, test_batch_size=16, num_worker=2)
    t["test_feeder_args"] = dict(t["test_feeder_args"], debug=True)
    t["model_args"] = dict(t["model_args"], base_channel=8)
    cfg["model"]["base_channel"] = 8
    cfg["data"]["limit"] = 64
    t["train_feeder_args"] = dict(t["train_feeder_args"], repeat=1)
    if "batch" in run.traffic:
        run.traffic["batch"] = 16
    run.traffic["trace_min_seconds"] = 0.1


def drive(cell, fault=None, overrides=None, trace=False):
    result, checks = harness.execute(BENCH, cell, SEED, 0.2, trace, torch.device("cpu"),
                                     time.perf_counter(), fault=fault, overrides=overrides,
                                     adjust=small)
    return result


@pytest.mark.parametrize("cell,fault", [(c, f) for c, faults in CELLS.items() for f in faults])
def test_a_fault_is_not_correct(cell, fault):
    assert drive(cell, fault=fault)["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_bf16_control_is_not_correct(cell):
    assert drive(cell, overrides={"dtype": "bfloat16"})["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct_and_well_formed(cell):
    result = drive(cell, trace=True)
    assert result["correct"] is True, result["checks"]
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
    for name, value in result["metrics"].items():  # no device number from the CPU
        assert name.startswith("loader_wait_ms"), name
