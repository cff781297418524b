"""The port's interpretability stage against the JAX package's (CPU).

`interpret.gradient_body_part_importance` equals the JAX function within
rtol 1e-5 on the same ST-GCN weights (tests/test_torch_stgcn.py's perturbed,
calibrated variables) and the same loader batches, and so does the per-joint
input gradient (atol 1e-5 * max). Both run in f64 (the port's model
`.double()`, JAX in x64): in f32 this input gradient carries rounding noise
of ~0.3% of its max in either package (each f32 result lies that far from
the f64 one, and the two f32 results as far from each other), which the
f32 importance inherits. The importance tool
(`python -m tamgcn_tpu_torch.tools.train_stgcn_importance`) trains on
NW-UCLA-layout clips on the CPU and writes the JAX tool's JSON layout, in
10-label and in group mode.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu import data as jax_data
from tamgcn_tpu.interpret import gradient_body_part_importance as jax_importance
from tamgcn_tpu.interpret import make_input_grad_fn as jax_input_grad_fn
from tamgcn_tpu.interpret import save_weights_json as jax_save_weights_json
from tamgcn_tpu.models import create_stgcn_nucla as jax_create
from tamgcn_tpu_torch import interpret
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_stgcn_nucla
from tamgcn_tpu_torch.tools import train_stgcn_importance
from test_torch_stgcn import _variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stgcn():
    """(JAX model, its f64 variables, the port's model in f64)."""
    jm = jax_create()
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       _variables(jm, seed=5))
    model = create_stgcn_nucla().double()
    model.load_state_dict(from_flax(variables, model))
    return jm, variables, model


def test_importance_matches_jax(stgcn):
    jm, variables, model = stgcn
    feeder = jax_data.get_feeder("synthetic_gcn", num_samples=24, split="train",
                                 time_steps=16, seed=2)
    # f64 data: the JAX BatchNorm computes in its input's dtype
    batches = [(b[0].astype(np.float64),) + tuple(b[1:])
               for b in jax_data.Loader(feeder, batch_size=8, shuffle=False)]
    with jax.enable_x64(True):
        want = jax_importance(jm, variables, batches, num_class=10, samples_per_class=2)
        x, y = batches[0][0], np.asarray(batches[0][-2])
        ref = np.asarray(jax_input_grad_fn(jm, variables)(jnp.asarray(x), jnp.asarray(y)))
    got = interpret.gradient_body_part_importance(model, batches, num_class=10,
                                                  samples_per_class=2)
    assert sorted(got) == list(range(10))
    for g in range(10):
        assert list(got[g]) == list(interpret.NUCLA_TARGET_JOINTS)
        np.testing.assert_allclose([got[g][p] for p in got[g]],
                                   [want[g][p] for p in want[g]], rtol=1e-5, err_msg=str(g))
    seen = [g for g in range(10) if any(v > 0 for v in want[g].values())]
    assert seen and all(max(got[g].values()) == 1.0 for g in seen)
    # the per-joint input gradient itself
    mine = interpret.make_input_grad_fn(model)(torch.from_numpy(x), torch.from_numpy(y))
    assert mine.shape == (8, 20)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    assert not model.training


@pytest.fixture(scope="module")
def nucla_dir(tmp_path_factory):
    """NW-UCLA-layout clips of 10 to 59 frames for the first 64 names of each
    split (what feeders with debug=True read)."""
    root = tmp_path_factory.mktemp("nucla")
    rng = np.random.default_rng(6)
    for split in ("train", "val"):
        for info in jax_data.load_nucla_split(split)[:64]:
            name = info["file_name"]
            (root / name).mkdir(exist_ok=True)
            skel = rng.normal(size=(int(rng.integers(10, 60)), 20, 3)).tolist()
            with open(root / name / f"{name}.json", "w") as f:
                json.dump({"skeletons": skel}, f)
    return str(root)


def _tool(nucla_dir, work_dir, *extra):
    return train_stgcn_importance.main([
        "--data_path", nucla_dir, "--use_gpu", "false", "--num_epoch", "1",
        "--samples_per_class", "2", "--debug", "true", "--num_worker", "1",
        "--train_feeder_args", "repeat=1", "--test_feeder_args", "debug=True",
        "--work_dir", str(work_dir), *extra])


def test_importance_tool_writes_the_jax_layout(nucla_dir, tmp_path):
    assert _tool(nucla_dir, tmp_path) == 0
    path = tmp_path / "label_weights.json"
    with open(path) as f:
        text = f.read()
    weights = {int(k): v for k, v in json.loads(text).items()}
    assert sorted(weights) == list(range(10))
    jax_save_weights_json(weights, str(tmp_path / "jax_layout.json"))
    with open(tmp_path / "jax_layout.json") as f:
        assert f.read() == text
    for parts in weights.values():
        assert list(parts) == list(interpret.NUCLA_TARGET_JOINTS)
        assert max(parts.values()) in (0.0, 1.0)
    with open(tmp_path / "edge_importance_per_joint.json") as f:
        scores = json.load(f)
    assert len(scores) == 20 and max(scores) == 1.0


def test_importance_tool_group_mode(nucla_dir, tmp_path):
    group_map = {str(k): k // 2 for k in range(10)}
    with open(tmp_path / "groups.json", "w") as f:
        json.dump(group_map, f)
    assert _tool(nucla_dir, tmp_path, "--group_map", str(tmp_path / "groups.json")) == 0
    with open(tmp_path / "group_weights.json") as f:
        weights = json.load(f)
    assert sorted(weights, key=int) == [str(g) for g in range(5)]
    with open(tmp_path / "log.txt") as f:
        assert "group 4:" in f.read()
    assert not os.path.exists(tmp_path / "label_weights.json")
