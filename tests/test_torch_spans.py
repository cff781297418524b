"""The span table (tamgcn_tpu_torch/utils/spans.py), on the CPU.

Off (no profiler collecting) a span records nothing and enters no
profiler range. torch's global flag that turns it on exists and reads
True in a scheduled profile's active phase only. On, nested spans give
self seconds that are their duration less their children's; a thread
started inside the profile (the loader's producer) is in the table though
kineto keeps none of its ranges; a main-thread span starts where its
kineto range starts, within 1 ms. A train epoch and an eval pass of a tiny
CTR-GCN under a profiler record every span of the loop and the loader with
the counts the loop implies, and `--profile_dir` writes the producer's
spans into its Chrome trace on the producer's thread.
"""
import collections
import glob
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.train.config import base_parser
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
from tamgcn_tpu_torch.utils import spans

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")


@pytest.fixture(autouse=True)
def empty_table():
    spans.reset()
    yield
    spans.reset()


def _kineto_events(prof):
    return list(prof.profiler.kineto_results.events())


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range entered with no profiler collecting")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)  # must exist
    assert not torch.autograd.profiler._is_profiler_enabled
    with spans.span("tamgcn.test.outer", 1):
        with spans.span("tamgcn.test.inner"):
            pass
    worker = threading.Thread(target=lambda: spans.span("tamgcn.test.thread").__enter__())
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert spans.totals() == {} and spans.records() == []


def test_the_flag_is_set_in_a_scheduled_profiles_active_phase_only():
    read = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    phases = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        phases.append(read())  # warm-up
        torch.ones(4).sum()
        prof.step()
        phases.append(read())  # active
        with spans.span("tamgcn.test.active"):
            torch.ones(4).sum()
        prof.step()
        phases.append(read())  # done
    assert phases == [False, True, False]
    assert spans.totals()["tamgcn.test.active"].count == 1


def test_nested_spans_give_self_seconds_and_parents():
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("tamgcn.test.outer", 7):
            time.sleep(0.004)
            for k in range(2):
                with spans.span("tamgcn.test.inner", k):
                    time.sleep(0.004)
    t = spans.totals()
    outer, inner = t["tamgcn.test.outer"], t["tamgcn.test.inner"]
    assert (outer.count, inner.count) == (1, 2)
    assert inner.self_seconds == pytest.approx(inner.seconds, abs=1e-9)
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds, abs=1e-9)
    assert outer.self_seconds >= 0.004 and inner.seconds >= 0.008
    recs = spans.records()
    (o,) = [i for i, r in enumerate(recs) if r.name == "tamgcn.test.outer"]
    assert recs[o].parent == -1 and recs[o].ident == 7
    assert [(r.parent, r.ident) for r in recs if r.name == "tamgcn.test.inner"] == [(o, 0), (o, 1)]
    assert all(r.start_ns < r.end_ns for r in recs)


def test_a_thread_started_inside_the_profile_is_kept_by_the_table_alone():
    tids = []

    def producer():
        tids.append(threading.get_native_id())
        with spans.span("tamgcn.test.producer", 0):
            torch.ones(8).mul(2)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("tamgcn.test.main"):
            worker = threading.Thread(target=producer)
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    (rec,) = [r for r in spans.records() if r.name == "tamgcn.test.producer"]
    assert rec.tid == tids[0] != threading.main_thread().native_id
    assert rec.parent == -1  # the main thread's open span is not its parent
    names = {e.name() for e in _kineto_events(prof)}
    assert "tamgcn.test.main" in names and "tamgcn.test.producer" not in names


def test_a_main_thread_span_starts_where_its_kineto_range_starts():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("tamgcn.test.clock", 3):
            torch.ones(8).sum()
    (rec,) = spans.records()
    (event,) = [e for e in _kineto_events(prof) if e.name() == "tamgcn.test.clock"]
    start = event.start_ns() if hasattr(event, "start_ns") else 1000 * event.start_us()
    assert abs(rec.start_ns - start) < 1_000_000


LOOP_SPANS = ("tamgcn.train.epoch", "tamgcn.train.step", "tamgcn.train.log",
              "tamgcn.train.epoch_end", "tamgcn.eval.pass", "tamgcn.eval.step",
              "tamgcn.eval.pass_end", "tamgcn.loader.wait", "tamgcn.loader.assemble",
              "tamgcn.loader.h2d", "tamgcn.loader.put_wait")


def _trainer(tmp_path):
    import yaml

    parser = base_parser()
    with open(SMOKE) as f:
        parser.set_defaults(**yaml.safe_load(f))
    return RecognitionTrainer(parser.parse_args([
        "--use_gpu", "false", "--work_dir", str(tmp_path), "--print_log", "false",
        "--model_args", "base_channel=8", "--batch_size", "4", "--test_batch_size", "4",
        "--train_feeder_args", "num_samples=12", "--test_feeder_args", "num_samples=6",
        "--num_worker", "1", "--log_interval", "2"]))


def test_a_train_epoch_and_an_eval_pass_record_every_span(tmp_path):
    t = _trainer(tmp_path)
    t.train_epoch(0)  # builds the steps outside the profile
    with profile(activities=[ProfilerActivity.CPU]):
        t.train_epoch(1)
        t.test_epoch()
    count = {name: total.count for name, total in spans.totals().items()}
    steps, batches = 3, 2  # 12 clips at 4; 6 at 4, the last of 2
    assert count == {
        "tamgcn.train.epoch": 1, "tamgcn.train.step": steps, "tamgcn.train.log": 2,
        "tamgcn.train.epoch_end": 1, "tamgcn.eval.pass": 1, "tamgcn.eval.step": batches,
        "tamgcn.eval.pass_end": 1,
        # one wait a batch and one for the end of each loader
        "tamgcn.loader.wait": steps + 1 + batches + 1,
        "tamgcn.loader.assemble": steps + batches, "tamgcn.loader.h2d": steps + batches,
        "tamgcn.loader.put_wait": steps + batches}
    assert set(count) == set(LOOP_SPANS)
    recs = spans.records()
    main = threading.main_thread().native_id
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append(r)
    assert [r.ident for r in by_name["tamgcn.train.step"]] == [3, 4, 5]  # the global step
    assert [r.ident for r in by_name["tamgcn.loader.wait"]] == [0, 1, 2, 3, 0, 1, 2]
    for name in ("tamgcn.loader.assemble", "tamgcn.loader.h2d", "tamgcn.loader.put_wait"):
        assert all(r.tid != main for r in by_name[name]), name
        assert [r.ident for r in by_name[name]] == [0, 1, 2, 0, 1], name
    epoch = recs.index(by_name["tamgcn.train.epoch"][0])
    for name in ("tamgcn.train.step", "tamgcn.train.log", "tamgcn.train.epoch_end"):
        assert all(r.parent == epoch for r in by_name[name]), name
    totals = spans.totals()
    for name in ("tamgcn.train.epoch", "tamgcn.eval.pass"):
        assert 0 <= totals[name].self_seconds < totals[name].seconds


def test_profile_dir_writes_the_producers_spans_into_the_trace(tmp_path):
    argv = ["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir", str(tmp_path / "run"),
            "--model_args", "base_channel=8", "--num_epoch", "1", "--batch_size", "8",
            "--test_batch_size", "8", "--train_feeder_args", "num_samples=16",
            "--test_feeder_args", "num_samples=8", "--num_worker", "1",
            "--print_log", "false", "--profile_dir", str(tmp_path / "prof")]
    assert main(argv) == 0
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    main_tid = threading.main_thread().native_id
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == main_tid]
    first, last = min(e["ts"] for e in ops), max(e["ts"] + e["dur"] for e in ops)
    for name in ("tamgcn.loader.assemble", "tamgcn.loader.h2d"):
        found = [e for e in events if e.get("name") == name]
        assert found and all(e["ph"] == "X" and e["tid"] != main_tid for e in found), name
        # on the trace's own time base: inside the span of the main thread's ops
        assert all(first - 1e6 < e["ts"] < last + 1e6 for e in found), name
    assert any(e.get("name") == "tamgcn.train.step" and e.get("tid") == main_tid for e in events)
