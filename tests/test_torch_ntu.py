"""NTU-60: the generic skeleton feeder and the two-person CTR-GCN at V = 25,
against the JAX package on the CPU.

  * `SkeletonFeederGCN` bit for bit against JAX's on a synthetic NTU-layout
    dataset (25 joints, mixed one- and two-person clips, as
    tests/test_data.py's `ntu_dir`): joint, bone and motion, train and val,
    num_person 1 (a two-person clip keeps its person of most motion) and 2,
    numpy; the native core's batches (single-person clips) bit for bit
    against JAX's numpy samples; native at num_person 2 raises as in JAX;
  * the whole CTR-GCN at num_person=2, V=25 (ntu_rgb_d graph, base_channel
    8, batch 3, T=16, alpha, the offset convs and gcn1's BatchNorm scale
    perturbed, calibrated running statistics): eval logits within 1e-5 *
    max |logit| and train-mode logits within 5e-5 * max;
  * configs/ntu60.yaml through `__main__.main` at small sizes on the
    synthetic dataset with --distributed false (one epoch, test phase on its
    best.pt), and the config as shipped refused, naming --distributed.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _numerics import perturb_offset_convs
from tamgcn_tpu.data.feeder_skeleton_gcn import SkeletonFeederGCN as JaxFeeder
from tamgcn_tpu.models.ctrgcn import CTRGCN as JaxCTRGCN
from tamgcn_tpu_torch import runtime
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.data import get_feeder
from tamgcn_tpu_torch.models import get_model

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NTU_YAML = os.path.join(REPO, "configs", "ntu60.yaml")
T, BC = 16, 8


def write_ntu(root, two_person_every=3, seed=3):
    """`<root>/<split>_split.json` and flat `<name>.json` clips of 25 joints,
    every `two_person_every`-th clip (0: none) with two persons."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", 24), ("val", 12)):
        records = []
        for i in range(n):
            name = f"S001C001P{i:03d}R001A{(i % 6) + 1:03d}"
            t = int(rng.integers(10, 40))
            two = two_person_every and i % two_person_every == 0
            skel = rng.normal(size=(t, 2, 25, 3) if two else (t, 25, 3)).tolist()
            with open(os.path.join(root, f"{name}.json"), "w") as f:
                json.dump({"skeletons": skel}, f)
            records.append({"file_name": name, "label": (i % 6) + 1})
        with open(os.path.join(root, f"{split}_split.json"), "w") as f:
            json.dump(records, f)
    return str(root)


@pytest.fixture(scope="module")
def ntu_dir(tmp_path_factory):
    return write_ntu(tmp_path_factory.mktemp("ntu"))


@pytest.fixture(scope="module")
def ntu_single(tmp_path_factory):
    return write_ntu(tmp_path_factory.mktemp("ntu1"), two_person_every=0, seed=4)


@pytest.mark.parametrize("num_person", [1, 2])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("modality", ["joint", "bone", "motion"])
def test_feeder_matches_jax_bit_for_bit(ntu_dir, modality, split, num_person):
    kw = dict(data_path=ntu_dir, split=split, modality=modality, time_steps=T,
              num_person=num_person, seed=5, repeat=2, backend="numpy")
    got, want = get_feeder("skeleton_gcn", **kw), JaxFeeder(**kw)
    assert got.backend == "numpy" and len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g[0].shape == (3, T, 25, num_person) and g[0].dtype == np.float32
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]


@pytest.mark.skipif(not runtime.available(), reason="the native core needs g++")
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("modality", ["joint", "bone", "motion"])
def test_native_batches_match_jax_numpy(ntu_single, modality, split):
    kw = dict(data_path=ntu_single, split=split, modality=modality, time_steps=T, seed=6)
    got = get_feeder("skeleton_gcn", backend="native", **kw)
    want = JaxFeeder(backend="numpy", **kw)
    assert got.backend == "native"
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        idx = np.arange(len(want))[::-1]
        data, label, base = got.get_batch(idx)
        np.testing.assert_array_equal(data, np.stack([want[i][0] for i in idx]))
        np.testing.assert_array_equal(label, want.label[idx])
        np.testing.assert_array_equal(base, idx)


def test_native_refused_where_jax_refuses(ntu_dir, ntu_single):
    with pytest.raises(RuntimeError, match="single-person"):
        get_feeder("skeleton_gcn", data_path=ntu_single, num_person=2, backend="native")
    with pytest.raises(RuntimeError, match="single-person"):  # two-person clips
        get_feeder("skeleton_gcn", data_path=ntu_dir, num_person=1, backend="native")
    auto = get_feeder("skeleton_gcn", data_path=ntu_dir, num_person=2)
    assert auto.backend == "numpy" and auto.get_batch([0, 1]) is None


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def two_person():
    """The JAX and port CTR-GCN at num_person=2, V=25 on perturbed,
    calibrated variables (tests/test_torch_model.py:perturbed_variables at
    NTU's shapes)."""
    kw = dict(num_class=60, num_point=25, num_person=2, graph="ntu_rgb_d",
              graph_args={"labeling_mode": "spatial"})
    jm = JaxCTRGCN(use_pallas=False, base_channel=BC, **kw)
    rs = np.random.RandomState(0)
    x_cal = rs.randn(4, 3, T, 25, 2).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x_cal), train=False))
    params = jax.device_get(perturb_offset_convs(init["params"], scale=0.3))
    params = _map(params, lambda p, v: (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
                  if p[-3:] == ("gcn1", "bn", "scale") else v)
    zero = _map(init["batch_stats"], lambda p, v: np.zeros_like(v))
    _, new = jm.apply({"params": params, "batch_stats": zero}, jnp.asarray(x_cal),
                      train=True, mutable=["batch_stats"])
    stats = _map(jax.device_get(new["batch_stats"]), lambda p, v: (
        10.0 * v * (1.0 + (0.1 * rs.randn(*v.shape) if p[-1] == "mean"
                           else 0.25 * np.abs(rs.randn(*v.shape))))).astype(np.float32))
    variables = {"params": params, "batch_stats": stats}
    model = get_model("ctrgcn", base_channel=BC, **kw)
    model.load_state_dict(from_flax(variables, model))
    return jm, variables, model


def test_two_person_model_matches_jax(two_person):
    jm, variables, model = two_person
    x = np.random.RandomState(1).randn(3, 3, T, 25, 2).astype(np.float32)
    x[1, ..., 1] = 0  # a one-person clip, its second person zero padding
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 60)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale
    want_t, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = model.train()(torch.from_numpy(x)).numpy()
    want_t = np.asarray(want_t)
    assert np.abs(got_t - want_t).max() <= 5e-5 * float(np.abs(want_t).max())


def _ntu_argv(work_dir, data, *extra):
    return ["recognition", "-c", NTU_YAML, "--distributed", "false", "--use_gpu", "false",
            "--work_dir", str(work_dir), "--num_worker", "1", "--batch_size", "8",
            "--test_batch_size", "6", "--model_args", f"base_channel={BC}",
            "--train_feeder_args", f"data_path={data}", f"time_steps={T}",
            "--test_feeder_args", f"data_path={data}", f"time_steps={T}", *extra]


def test_ntu60_config_trains_and_tests(ntu_dir, tmp_path):
    assert main(_ntu_argv(tmp_path / "train", ntu_dir, "--num_epoch", "1")) == 0
    best = tmp_path / "train" / "checkpoints" / "best.pt"
    assert best.exists()
    with open(tmp_path / "train" / "log.txt") as f:
        log = f.read()
    assert "train feeder: SkeletonFeederGCN, backend numpy" in log
    assert main(_ntu_argv(tmp_path / "test", ntu_dir, "--phase", "test", "--weights",
                          str(tmp_path / "train" / "checkpoints"), "--save_result",
                          "true")) == 0
    with open(tmp_path / "test" / "log.txt") as f:
        assert f"({best}) (pt)" in f.read()
    with pytest.raises(RuntimeError, match="--distributed true needs the launcher"):
        main(["recognition", "-c", NTU_YAML, "--use_gpu", "false", "--work_dir",
              str(tmp_path / "refused")])
