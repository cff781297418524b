"""BENCHMARK.json against the contract's shape, and the harness finding a
new cell made of new files only."""
import json
import os
import re
import shutil
import subprocess
import sys

from tgbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert not any(w.endswith("_torch") for w in BENCH["paths"])


def test_names_units_and_text():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for item in items:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer"):
            if key in item:
                text = item[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("tgbench/")
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        run_cfg = harness.load_json(harness.HERE, "configs", f"{w['config']}.json")
        traffic = harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{traffic['driver']}.py"))
        assert os.path.exists(os.path.join(harness.HERE, "limits", f"{w['name']}.json"))
        assert run_cfg["name"] == w["config"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(BENCH, w["name"], True)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25


def test_per_layer_metrics_move_one_end_to_end_metric_in_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], set()).add(m["name"])
        for cell in m["workloads"]:
            reported = {x["name"] for x in harness.metrics_for(BENCH, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)
        assert os.path.exists(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark with one more configuration, traffic mix and
    limits file, and the cell added to BENCHMARK.json: the harness finds all
    of it by name, and no file that was there changes."""
    shutil.copytree(harness.HERE, tmp_path / "tgbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: (tmp_path / "tgbench" / p).read_bytes()
              for p in os.listdir(tmp_path / "tgbench") if (tmp_path / "tgbench" / p).is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_json(harness.HERE, "configs", "ctrgcn-nucla.json")
    cfg["name"] = "ctrgcn-nucla-wide"
    (tmp_path / "tgbench/configs/ctrgcn-nucla-wide.json").write_text(json.dumps(cfg))
    (tmp_path / "tgbench/traffic/eval_passes_again.json").write_text(
        json.dumps({"driver": "eval_loop", "trace_min_seconds": 1.0}))
    (tmp_path / "tgbench/limits/wide-eval.json").write_text(json.dumps({"logit_gap": 1e-3}))
    bench["configs"].append(dict(bench["configs"][0], name="ctrgcn-nucla-wide",
                                 file="tgbench/configs/ctrgcn-nucla-wide.json"))
    bench["workloads"].append({"name": "wide-eval", "config": "ctrgcn-nucla-wide",
                               "traffic": "eval_passes_again", "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] == "mfu.eval":
            m["workloads"].append("wide-eval")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from tgbench import harness; "
            "b = harness.manifest(); r = harness.make_run(b, 'wide-eval', 1, None, '/x'); "
            "print(r.config['name'], r.traffic['driver'], harness.driver_class('eval_loop').__name__, "
            "[m['name'] for m in harness.metrics_for(b, 'wide-eval', True)])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True).stdout
    assert out.split()[:3] == ["ctrgcn-nucla-wide", "eval_loop", "Driver"]
    assert "mfu.eval" in out
    after = {p: (tmp_path / "tgbench" / p).read_bytes() for p in before}
    assert after == before
