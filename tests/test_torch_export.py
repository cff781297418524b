"""The serving export (tamgcn_tpu_torch/tools/export_serving.py) on the CPU.

  * roundtrip: the tool exports, saves, reloads and checks CTR-GCN (fixed
    batch, --fast_eval, --poly_batch) and ST-GCN with --poly_batch (at
    base_channel 8 and T = 16; tests/test_torch_export_rgb.py takes the
    RGB and fusion families) and prints the JAX tool's JSON line;
  * the graph holds the kernels: one `tamgcn.unit_ctr_gc` node per block
    (`tamgcn.gcn_tcn_block` with --fast_eval) and no node outside them that
    builds the refined adjacency (a tensor with two joint axes side by
    side): the plain version's ops are not in the graph;
  * against JAX: the reloaded artifact's logits against the JAX model's
    `apply` on the same weights (perturbed, calibrated, converted with
    convert.from_flax and passed with --weights as the port's .pt and as a
    Flax .npz), within 1e-5 x max|logit|;
  * the serving contract: the artifact loads and runs in a process that
    imports `tamgcn_tpu_torch.ops` and nothing else of the port, and
    `torch.export.load` without the ops registered raises;
  * the four export defects of the JAX tool (ADVICE.md) are avoided;
  * `serving.entry` on the CPU.
"""
import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _numerics import perturb_offset_convs
from _weight_forms import to_flax_arrays
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.serving import artifact_data_parallel, entry
from tamgcn_tpu_torch.tools import export_serving
from tamgcn_tpu_torch.train.config import load_config

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
STGCN = os.path.join(REPO, "configs", "nucla", "stgcn.yaml")
BC, T, V = 8, 16, 20


def export(capsys, out, config, *extra):
    """Run the tool on the CPU; returns its JSON record."""
    assert export_serving.main(["--out", str(out), "--platforms", "cpu", "--time", str(T),
                                *extra, "-c", config]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(line)
    assert record["metric"] == "serving_export_roundtrip"
    assert record["roundtrip_max_abs_err"] <= 2e-5 and record["nr_devices"] == 1
    assert os.path.getsize(out) == record["bytes"] > 0
    return record


def plain_aggregation_nodes(program) -> list[str]:
    """Nodes outside the custom ops whose output has two joint axes side by
    side: the refined adjacency M (N, V, V, C) and the (N, V, V, R) tanh of
    the plain unit op."""
    bad = []
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if node.op != "call_function" or not isinstance(val, torch.Tensor):
            continue
        shape = tuple(val.shape)
        if len(shape) >= 4 and any(a == b == V for a, b in zip(shape, shape[1:])):
            bad.append(f"{node.target} {shape}")
    return bad


CASES = {
    "ctrgcn": (SMOKE, ["--batch", "4", "--model_args", f"base_channel={BC}"],
               {"tamgcn.unit_ctr_gc.default": 10}),
    "ctrgcn_fast_eval": (SMOKE, ["--batch", "4", "--fast_eval",
                                 "--model_args", f"base_channel={BC}"],
                         {"tamgcn.gcn_tcn_block.default": 10}),
    "ctrgcn_poly_batch": (SMOKE, ["--batch", "4", "--poly_batch",
                                  "--model_args", f"base_channel={BC}"],
                          {"tamgcn.unit_ctr_gc.default": 10}),
    # the JAX tool raises TypeError here (use_pallas injected into ST-GCN)
    "stgcn_poly_batch": (STGCN, ["--batch", "4", "--poly_batch"], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip_and_the_kernels_in_the_graph(case, tmp_path, capsys):
    config, extra, ops = CASES[case]
    out = tmp_path / f"{case}.pt2"
    record = export(capsys, out, config, *extra)
    assert record["output_shape"] == [4, 10] and record["input_shapes"] == [[4, 3, T, V, 1]]
    assert record["custom_ops"] == ops
    assert record["eager_max_abs_err"] <= 1e-4 * 10
    poly = "--poly_batch" in extra
    assert record["poly_batch"] is poly
    assert record["half_batch_output_shape"] == ([2, 10] if poly else None)
    program = torch.export.load(str(out))
    assert plain_aggregation_nodes(program) == []
    if poly:  # any batch, one artifact
        x = torch.randn(3, 3, T, V, 1)
        assert program.module()(x).shape == (3, 10)


def _calibrated():
    """JAX CTR-GCN variables: alpha and the offset convs perturbed, gcn1/bn
    scales O(1), the running statistics of a calibration batch (10 x a
    train-mode pass from zeroed statistics)."""
    jm = jax_create(use_pallas=False, base_channel=BC)
    rs = np.random.RandomState(4)
    x_cal = jnp.asarray(rs.randn(4, 3, T, V, 1).astype(np.float32))
    init = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(4), x_cal))
    params = perturb_offset_convs(init["params"], scale=0.3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(1.0 + 0.1 * rs.randn(*v.shape), np.float32)
        if "/".join(k.key for k in p[-3:]) == "gcn1/bn/scale" else v, params)
    zero = jax.tree_util.tree_map(jnp.zeros_like, init["batch_stats"])
    _, new = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": zero}, x_cal)
    stats = jax.tree_util.tree_map(lambda v: 10.0 * np.asarray(v),
                                   jax.device_get(new["batch_stats"]))
    return jm, {"params": jax.device_get(params), "batch_stats": stats}


def test_artifact_logits_match_jax(tmp_path, capsys):
    jm, variables = _calibrated()
    model = create_ctrgcn_nucla(base_channel=BC)
    state = from_flax(variables, model)
    # the weights as the port's .pt and, for the fast eval, as a Flax .npz
    pt, npz = tmp_path / "converted.pt", tmp_path / "flax.npz"
    torch.save(state, pt)
    np.savez(npz, **to_flax_arrays(state, model))
    x = np.random.RandomState(7).randn(4, 3, T, V, 1).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x)))
    for extra, weights in (([], pt), (["--fast_eval"], npz)):
        out = tmp_path / f"ctrgcn{len(extra)}.pt2"
        export(capsys, out, SMOKE, "--batch", "4", "--weights", str(weights), *extra,
               "--model_args", f"base_channel={BC}")
        with torch.no_grad():
            got = torch.export.load(str(out)).module()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=" ".join(extra))


def test_serving_contract_needs_only_the_ops(tmp_path, capsys):
    """Both artifacts (the unit op, K5) load and run in a process that imports
    only tamgcn_tpu_torch.ops; without it torch.export.load raises."""
    x = np.random.RandomState(2).randn(4, 3, T, V, 1).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = []
    for name, extra in (("model", []), ("fast", ["--fast_eval"])):
        out = tmp_path / f"{name}.pt2"
        export(capsys, out, SMOKE, "--batch", "4", *extra, "--model_args", f"base_channel={BC}")
        with torch.no_grad():
            want.append(torch.export.load(str(out)).module()(torch.from_numpy(x)).numpy())
    serve = (
        "import sys, numpy as np, torch\n"
        "import tamgcn_tpu_torch.ops\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "for name in ('model', 'fast'):\n"
        f"    program = torch.export.load({str(tmp_path)!r} + f'/{{name}}.pt2')\n"
        "    with torch.no_grad():\n"
        f"        np.save({str(tmp_path)!r} + f'/{{name}}.npy', program.module()(x).numpy())\n"
        "port = sorted(m for m in sys.modules if m.startswith('tamgcn_tpu_torch'))\n"
        "print(' '.join(port))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", serve], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=300)
    assert done.returncode == 0, done.stderr
    loaded = done.stdout.split()
    assert "tamgcn_tpu_torch.ops" in loaded
    assert not [m for m in loaded if m.split(".")[1:2] in
                (["models"], ["train"], ["tools"], ["data"], ["serving"], ["graphs"])], loaded
    np.testing.assert_array_equal(np.load(tmp_path / "model.npy"), want[0])
    np.testing.assert_array_equal(np.load(tmp_path / "fast.npy"), want[1])
    bare = subprocess.run(
        [sys.executable, "-c", f"import torch; torch.export.load({str(out)!r})"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert bare.returncode != 0 and "RuntimeError" in bare.stderr


def test_the_jax_tools_defects_are_avoided(tmp_path):
    # the RGB input reads image_size as well as size (JAX reads only size)
    arg = load_config(["-c", os.path.join(REPO, "configs", "nucla", "smoke_resnet.yaml")])
    for feeder_args, side in (({"size": 48}, 48), ({"image_size": 40}, 40), ({}, 224)):
        arg.test_feeder_args = feeder_args
        assert export_serving.example_shapes(arg, 2, T) == [(2, 3, side, side)]
    base = ["--out", str(tmp_path / "a.pt2"), "--platforms", "cpu", "-c", SMOKE,
            "--model_args", f"base_channel={BC}"]
    # the divisibility message reads the right way round
    with pytest.raises(SystemExit, match="batch 3 must be divisible by data_parallel=2"):
        export_serving.run(["--batch", "3", "--data_parallel", "2", *base])
    # --data_parallel 2: exported at the per-rank batch, N recorded, served on
    # two ranks each on its rows (rank 0 gathers) as the live model on all 4
    record = export_serving.run(["--batch", "4", "--data_parallel", "2", *base])
    assert record["nr_devices"] == 2 and record["input_shapes"][0][0] == 2
    assert record["sharded_max_abs_err"] is not None  # held within 1e-4 x max|logit|
    assert artifact_data_parallel(str(tmp_path / "a.pt2")) == 2
    with pytest.raises(SystemExit, match="drop --poly_batch"):
        export_serving.run(["--batch", "4", "--data_parallel", "2", "--poly_batch", *base])
    # a --weights directory without a checkpoint names itself (JAX: epochNone)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match=re.escape(f"no checkpoint found in {empty}")):
        export_serving.run(["--weights", str(empty), *base])
    # (--poly_batch on ST-GCN: tests/test_torch_export.py::CASES["stgcn_poly_batch"])
    with pytest.raises(SystemExit, match="fixed batch"):
        export_serving.run(["--fast_eval", "--poly_batch", *base])
    with pytest.raises(ValueError, match="TPU"):
        export_serving.run(["--out", "x.pt2", "--platforms", "cpu,tpu", "-c", SMOKE])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--platforms cpu"):
            export_serving.run(["--out", "x.pt2", "-c", SMOKE])


def test_serving_entry_on_the_cpu():
    fn, args = entry(device="cpu")
    assert args[0].shape == (8, 3, 52, 20, 1) and not fn.training
    with torch.no_grad():
        logits = fn(*args)
    assert logits.shape == (8, 10) and torch.isfinite(logits).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
