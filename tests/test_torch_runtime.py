"""The port's native augmentation core and the NW-UCLA feeder's backends (CPU).

`tamgcn_tpu_torch.runtime.augment_batch` and the port feeder's `get_batch`
equal the JAX NW-UCLA feeder's numpy `__getitem__` bit for bit: train and
eval, the three modalities, two seeds, epochs 0 and 3. The port's `Loader`
yields the same batches with backend "native" as with "numpy". Skipped only
where g++ is missing, as tests/test_runtime_native.py is where the JAX
package's core is unavailable.
"""
import json
import os
import shutil

import numpy as np
import pytest

from tamgcn_tpu import data as jax_data
from tamgcn_tpu_torch import data, runtime

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@pytest.fixture(scope="module")
def nucla_dir(tmp_path_factory):
    """Random JSON skeletons of 2 to 79 frames for the first 64 samples of
    each split (what a feeder with debug=True reads)."""
    root = tmp_path_factory.mktemp("nucla")
    rng = np.random.default_rng(4)
    for split in ("train", "val"):
        for info in jax_data.load_nucla_split(split)[:64]:
            name = info["file_name"]
            (root / name).mkdir(exist_ok=True)
            skel = rng.normal(size=(int(rng.integers(2, 80)), 20, 3)).tolist()
            with open(root / name / f"{name}.json", "w") as f:
                json.dump({"skeletons": skel}, f)
    return str(root)


def _feeders(root, split, modality, seed, epoch, backend="native"):
    kw = dict(split=split, modality=modality, seed=seed, debug=True)
    ours = data.NUCLAFeederGCN(root, backend=backend, **kw)
    ref = jax_data.NUCLAFeederGCN(root, backend="numpy", **kw)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    return ours, ref


@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("modality", ["joint", "bone", "motion"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_native_batch_equals_jax_numpy_getitem(nucla_dir, split, modality, seed, epoch):
    ours, ref = _feeders(nucla_dir, split, modality, seed, epoch)
    assert ours.backend == "native"
    idx = np.array([0, 5, 17, 63, 31, 2, 44, 9])
    want = [ref[i] for i in idx]
    got = ours.get_batch(idx)
    x = np.stack([w[0] for w in want])
    assert got[0].dtype == np.float32 and got[0].shape == (8, 3, 52, 20, 1)
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], [w[1] for w in want])
    np.testing.assert_array_equal(got[2], [w[2] for w in want])
    direct = runtime.augment_batch([ours.data[i] for i in idx], idx, time_steps=52,
                                   train=split == "train", modality=modality,
                                   seed=seed, epoch=epoch)
    np.testing.assert_array_equal(direct, x)


@pytest.mark.parametrize("split", ["train", "val"])
def test_loader_native_equals_numpy(nucla_dir, split):
    """Shuffled train batches (drop_last) and val batches, epoch after
    epoch, the same from both backends; the numpy feeder has no batch path."""
    loaders = {}
    for backend in ("native", "numpy"):
        feeder, _ = _feeders(nucla_dir, split, "joint", 3, 0, backend=backend)
        loaders[backend] = data.Loader(feeder, batch_size=16, shuffle=split == "train",
                                       drop_last=split == "train", seed=2, num_workers=2)
    assert loaders["numpy"].dataset.get_batch(np.arange(4)) is None
    for epoch in (0, 1):
        for loader in loaders.values():
            loader.set_epoch(epoch)
        got, want = list(loaders["native"]), list(loaders["numpy"])
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_backend_semantics(nucla_dir, monkeypatch):
    auto = data.NUCLAFeederGCN(nucla_dir, split="train", debug=True)
    assert auto.backend == "native"
    f64 = data.NUCLAFeederGCN(nucla_dir, split="train", debug=True, dtype="float64")
    assert f64.backend == "numpy" and f64.get_batch([0, 1]) is None
    with pytest.raises(RuntimeError, match="native augmentation backend is unavailable"):
        data.NUCLAFeederGCN(nucla_dir, split="train", debug=True, dtype="float64",
                            backend="native")
    monkeypatch.setattr(runtime, "available", lambda: False)
    assert data.NUCLAFeederGCN(nucla_dir, split="train", debug=True).backend == "numpy"
    with pytest.raises(RuntimeError, match="unavailable"):
        data.NUCLAFeederGCN(nucla_dir, split="train", debug=True, backend="native")


def test_library_is_keyed_on_source_and_machine():
    path = runtime.library_path()
    assert os.path.dirname(path) == runtime.BUILD_DIR
    assert os.path.basename(path).startswith("libtamgcn_augment-")
    assert runtime.load().tamgcn_version() == 3
    assert os.path.isfile(path)
