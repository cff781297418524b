"""The port's graphs, feeders, loader and config parsing against the JAX
package's, on the CPU: the adjacencies are equal, the synthetic and NW-UCLA
feeders give identical samples (the NW-UCLA train split with its
augmentation stream over two epochs), the loaders batch alike (the train
loader shuffled, dropping the last batch), and every shipped YAML config
parses in the port's `load_config`."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from tamgcn_tpu import data as jax_data
from tamgcn_tpu import graphs as jax_graphs
from tamgcn_tpu.data.synthetic import SyntheticSkeletonFeeder as JaxSynthetic
from tamgcn_tpu.train.config import base_parser as jax_base_parser
from tamgcn_tpu.train.config import load_config as jax_load_config
from tamgcn_tpu_torch import data, graphs
from tamgcn_tpu_torch.models import get_model
from tamgcn_tpu_torch.train.config import base_parser, check_supported, load_config

torch.set_num_threads(1)
CONFIGS = sorted(glob.glob("configs/**/*.yaml", recursive=True))


@pytest.mark.parametrize("name,args", [
    ("ucla", {"labeling_mode": "spatial"}),
    ("ntu_rgb_d", {"labeling_mode": "spatial"}),
    ("graph.ucla.Graph", {}),
    ("synthetic", {"num_node": 64, "seed": 3}),
])
def test_adjacency_equals_jax(name, args):
    a = graphs.get_graph(name, **args).A
    want = jax_graphs.get_graph(name, **args).A
    assert a.dtype == want.dtype
    np.testing.assert_array_equal(a, want)


def test_unknown_graph_raises():
    with pytest.raises(KeyError, match="ucla"):
        graphs.get_graph("nope")


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_feeder_identical(split):
    ours = data.SyntheticSkeletonFeeder(num_samples=6, split=split, seed=4)
    ref = JaxSynthetic(num_samples=6, split=split, seed=4)
    assert ours.sample_name == ref.sample_name
    np.testing.assert_array_equal(ours.label, ref.label)
    for i in range(len(ref)):
        a, la, ia = ours[i]
        b, lb, ib = ref[i]
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert (la, ia) == (lb, ib)


@pytest.fixture(scope="module")
def nucla_dir(tmp_path_factory):
    """NW-UCLA directory with random JSON skeletons for every val sample, as
    tests/test_data.py builds it."""
    root = tmp_path_factory.mktemp("nucla")
    rng = np.random.default_rng(0)
    for info in jax_data.load_nucla_split("val"):
        name = info["file_name"]
        d = root / name
        d.mkdir(exist_ok=True)
        skel = rng.normal(size=(max(info["length"], 2), 20, 3)).tolist()
        with open(d / f"{name}.json", "w") as f:
            json.dump({"skeletons": skel}, f)
    return str(root)


@pytest.mark.parametrize("modality", ["joint", "bone", "motion"])
def test_nucla_eval_feeder_identical(nucla_dir, modality):
    ours = data.NUCLAFeederGCN(nucla_dir, split="val", modality=modality)
    ref = jax_data.NUCLAFeederGCN(nucla_dir, split="val", modality=modality,
                                  backend="numpy")
    assert len(ours) == len(ref) == 464
    assert ours.sample_name == ref.sample_name
    np.testing.assert_array_equal(ours.label, ref.label)
    for i in (0, 1, 97, 463):
        a, la, ia = ours[i]
        b, lb, ib = ref[i]
        assert a.shape == (3, 52, 20, 1) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert (la, ia) == (lb, ib)


@pytest.fixture(scope="module")
def nucla_train_dir(tmp_path_factory):
    """Random JSON skeletons of 10 to 39 frames for the first 64 train
    samples, the ones a feeder with debug=True reads."""
    root = tmp_path_factory.mktemp("nucla_train")
    rng = np.random.default_rng(1)
    for i, info in enumerate(jax_data.load_nucla_split("train")[:64]):
        name = info["file_name"]
        (root / name).mkdir(exist_ok=True)
        skel = rng.normal(size=(10 + i % 30, 20, 3)).tolist()
        with open(root / name / f"{name}.json", "w") as f:
            json.dump({"skeletons": skel}, f)
    return str(root)


@pytest.mark.parametrize("modality", ["joint", "bone"])
def test_nucla_train_feeder_identical(nucla_train_dir, modality):
    """The train split's rotation, scale and random resampling draw the same
    Philox(seed, epoch, index) stream in both packages, epoch after epoch;
    `repeat` oversamples."""
    kw = dict(split="train", modality=modality, repeat=2, seed=3, debug=True)
    ours = data.NUCLAFeederGCN(nucla_train_dir, **kw)
    ref = jax_data.NUCLAFeederGCN(nucla_train_dir, backend="numpy", **kw)
    assert len(ours) == len(ref) == 128
    np.testing.assert_array_equal(ours.label, ref.label)
    first = {}
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in (0, 5, 63, 64, 127):
            a, la, ia = ours[i]
            b, lb, ib = ref[i]
            assert a.shape == (3, 52, 20, 1) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            assert (la, ia) == (lb, ib) == (int(ref.label[i % 64]), i % 64)
            first.setdefault(i, a)
        # the augmentation changes with the epoch, and between repeats
        assert epoch == 0 or not np.array_equal(ours[5][0], first[5])
    assert not np.array_equal(ours[0][0], ours[64][0])


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_nucla_feeder_backends_run_the_numpy_path(nucla_train_dir, backend):
    """`__getitem__` runs the port's numpy path whatever the backend (the
    native core serves `get_batch` only, tests/test_torch_runtime.py): the
    samples of the JAX feeder's numpy backend, draw for draw."""
    kw = dict(split="train", modality="joint", seed=5, debug=True)
    ours = data.NUCLAFeederGCN(nucla_train_dir, backend=backend, **kw)
    ref = jax_data.NUCLAFeederGCN(nucla_train_dir, backend="numpy", **kw)
    for i in (0, 17, 63):
        np.testing.assert_array_equal(ours[i][0], ref[i][0])


@pytest.mark.parametrize("backend,error,match", [
    ("native", RuntimeError, "native augmentation backend"),
    ("cpp", ValueError, "unknown backend"),
], ids=["native", "unknown"])
def test_nucla_feeder_refuses_what_it_has_no_backend_for(nucla_train_dir, backend, error,
                                                          match, monkeypatch):
    """backend="native" where the native core is unavailable (no g++ here,
    as the patched `runtime.available` says) raises, as the JAX feeder
    does, instead of running numpy in its place; an unknown backend
    raises."""
    from tamgcn_tpu_torch import runtime

    monkeypatch.setattr(runtime, "available", lambda: False)
    with pytest.raises(error, match=match):
        data.NUCLAFeederGCN(nucla_train_dir, split="train", debug=True, backend=backend)


def test_train_loader_batches_like_jax():
    """Shuffled per epoch from the seed, the last short batch dropped."""
    feeder = data.SyntheticSkeletonFeeder(num_samples=11, split="train", seed=2)
    ref_feeder = JaxSynthetic(num_samples=11, split="train", seed=2)
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=3, num_workers=2)
    ours, ref = data.Loader(feeder, **kw), jax_data.Loader(ref_feeder, **kw)
    orders = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert [len(b[1]) for b in got] == [len(b[1]) for b in want] == [4, 4]
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        orders.append(np.concatenate([b[2] for b in got]))
    assert not np.array_equal(orders[0], orders[1])


def test_eval_loader_batches_like_jax():
    feeder = data.SyntheticSkeletonFeeder(num_samples=11, split="val", seed=2)
    ref_feeder = JaxSynthetic(num_samples=11, split="val", seed=2)
    ours = list(data.Loader(feeder, batch_size=4, num_workers=2))
    ref = list(jax_data.Loader(ref_feeder, batch_size=4, num_workers=2))
    assert [len(b[1]) for b in ours] == [len(b[1]) for b in ref] == [4, 4, 3]
    for got, want in zip(ours, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_feeder_registry():
    assert data.resolve_feeder("feeder.feeder_nucla_gcn.Feeder") is data.NUCLAFeederGCN
    assert data.feeder_accepts_seed("synthetic_gcn")
    # every name of the JAX package's registry resolves to the port's feeder
    for name, cls in (("nucla_resnet", data.NUCLAFeederResNet),
                      ("feeder.feeder_nucla_resnet.Feeder", data.NUCLAFeederResNet),
                      ("nucla_fusion", data.NUCLAFeederFusion),
                      ("feeder.feeder_nucla_fusion.Feeder", data.NUCLAFeederFusion),
                      ("skeleton_gcn", data.SkeletonFeederGCN),
                      ("synthetic_rgb", data.SyntheticRGBFeeder),
                      ("synthetic_fusion", data.SyntheticFusionFeeder)):
        assert data.resolve_feeder(name) is cls
        assert jax_data.resolve_feeder(name).__name__ == cls.__name__
    with pytest.raises(KeyError, match="synthetic_gcn"):
        data.resolve_feeder("nope")


def test_config_sweep_found_everything():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, "configs")
                                               for p in CONFIGS])
def test_config_parses(path):
    """Every shipped config parses with the JAX package's flag set; what the
    slice lacks (RGB and fusion models and feeders, bf16, --distributed)
    raises NotImplementedError naming it, and the rest builds."""
    argv = ["-c", path, "--phase", "test"]
    arg = load_config(argv)
    want = vars(jax_load_config(argv, parser=jax_base_parser()))
    assert set(vars(arg)) == set(want)
    for k, v in vars(arg).items():
        assert v == want[k], k
    try:
        check_supported(arg)
        data.resolve_feeder(arg.feeder)
        model = get_model(arg.model, **dict(arg.model_args))
    except NotImplementedError as e:
        assert "slice" in str(e) or "not ported" in str(e), e
        return
    assert model.num_class == arg.model_args["num_class"]


def test_unknown_config_key_raises(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("no_such_flag: 1\n")
    with pytest.raises(KeyError, match="no_such_flag"):
        load_config(["-c", str(bad)], parser=base_parser())


def test_val_split_list_equals_jax():
    assert data.load_nucla_split("val") == jax_data.load_nucla_split("val")
    with pytest.raises(ValueError, match="split"):
        data.load_nucla_split("test")


def test_train_split_list_equals_jax():
    train = data.load_nucla_split("train")
    assert train == jax_data.load_nucla_split("train")
    assert len(train) == 1020
