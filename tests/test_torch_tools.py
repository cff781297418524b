"""The port's score tools against the JAX package's, on the CPU.

  * tamgcn_tpu_torch/ensemble.py against tamgcn_tpu/ensemble.py bit for bit
    (softmax, fuse, the alpha sweep, the per-class report, the alignment of
    score pickles, the NW-UCLA val labels), and viz.py's confusion figure
    pixel for pixel; without matplotlib the figure raises an ImportError
    naming it;
  * a smallest run of each tool: ensemble_eval on two score pickles,
    ensemble_online_eval on two CTR-GCN weight files through the port's
    trainer (--use_gpu false), visualize_fusion on a synthetic NW-UCLA val
    split (its intensity map and column weights against the JAX tool's
    functions on the same weights), and bf16_convergence --family rgb.
"""
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _weight_forms import to_flax_arrays
from tamgcn_tpu import ensemble as jax_ensemble
from tamgcn_tpu import viz as jax_viz
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu_torch import ensemble, viz
from tamgcn_tpu_torch.data.splits import load_nucla_split
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.tools import (bf16_convergence, ensemble_eval, ensemble_online_eval,
                                    visualize_fusion)
from tamgcn_tpu_torch.train.checkpoint import flax_tree, save_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import visualize_fusion as jax_visualize  # noqa: E402

SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8


def _scores(rs, n=40, classes=10):
    names = [f"s{i:03d}" for i in range(n)]
    return names, {k: rs.randn(classes) for k in names}


def test_ensemble_is_the_jax_one_bit_for_bit():
    rs = np.random.RandomState(0)
    names, a = _scores(rs)
    _, b = _scores(rs)
    labels = {k: int(rs.randint(10)) for k in names[5:]}
    got = ensemble.align_scores([a, b], labels)
    want = jax_ensemble.align_scores([a, b], labels)
    assert got[0] == want[0]
    for g, w in zip(got[1] + [got[2]], want[1] + [want[2]]):
        np.testing.assert_array_equal(g, w)
    _, (ma, mb), y = got
    for normalize in (True, False):
        np.testing.assert_array_equal(ensemble.fuse(ma, mb, 0.7, normalize),
                                      jax_ensemble.fuse(ma, mb, 0.7, normalize))
        assert ensemble.alpha_sweep(ma, mb, y, normalize=normalize) == \
            jax_ensemble.alpha_sweep(ma, mb, y, normalize=normalize)
    np.testing.assert_array_equal(ensemble.softmax(ma), jax_ensemble.softmax(ma))
    rep, jrep = ensemble.per_class_report(ma, y), jax_ensemble.per_class_report(ma, y)
    assert rep["top1"] == jrep["top1"] and rep["per_class_top1"] == jrep["per_class_top1"]
    np.testing.assert_array_equal(rep["confusion"], jrep["confusion"])
    assert ensemble.nucla_val_labels() == jax_ensemble.nucla_val_labels()


def test_load_scores_is_the_jax_one(tmp_path):
    rs = np.random.RandomState(1)
    _, d = _scores(rs)
    for obj in (d, list(d.values())):
        path = tmp_path / "s.pkl"
        with open(path, "wb") as f:
            pickle.dump(obj, f)
        got, want = ensemble.load_scores(str(path)), jax_ensemble.load_scores(str(path))
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_confusion_figure_is_the_jax_one(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(2)
    scores, labels = rs.randn(50, 10), rs.randint(0, 10, 50)
    ours = viz.plot_confusion_matrix(scores, labels, "t", str(tmp_path / "a.png"))
    theirs = jax_viz.plot_confusion_matrix(scores, labels, "t", str(tmp_path / "b.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(theirs)))


def test_figures_without_matplotlib_name_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_confusion_matrix(np.eye(3), np.arange(3), "t", str(tmp_path / "c.png"))


def test_ensemble_eval_tool(tmp_path, capsys):
    rs = np.random.RandomState(3)
    names, a = _scores(rs)
    _, b = _scores(rs)
    paths = {}
    for key, obj in (("a", a), ("b", b), ("labels", {k: i % 10 for i, k in enumerate(names)})):
        paths[key] = str(tmp_path / f"{key}.pkl")
        with open(paths[key], "wb") as f:
            pickle.dump(obj, f)
    assert ensemble_eval.main(["--scores_a", paths["a"], "--scores_b", paths["b"],
                               "--labels", paths["labels"], "--sweep"]) == 0
    out = capsys.readouterr().out
    assert "40 common samples" in out and "best: alpha=" in out


def _weights(tmp_path, seed):
    model = create_ctrgcn_nucla(base_channel=BC, generator=torch.Generator().manual_seed(seed))
    path = str(tmp_path / f"w{seed}.pt")
    save_weights(model, path)
    return path


def test_ensemble_online_eval_tool(tmp_path, capsys):
    extra = (f"--use_gpu false --model_args base_channel={BC} "
             "--test_feeder_args num_samples=24 --num_worker 1")
    out_dir = tmp_path / "out"
    assert ensemble_online_eval.main([
        "--config_a", SMOKE, "--weights_a", _weights(tmp_path, 1),
        "--config_b", SMOKE, "--weights_b", _weights(tmp_path, 2),
        "--out_dir", str(out_dir), "--extra_a", extra, "--extra_b", extra]) == 0
    text = capsys.readouterr().out
    assert "common samples: 24" in text and "best: alpha=" in text
    assert (out_dir / "confusion_matrix_model_a.png").exists()
    assert (out_dir / "confusion_matrix_alpha_1.0.png").exists()


def _write_val_clips(root, frames=12):
    rs = np.random.RandomState(4)
    for info in load_nucla_split("val"):
        name = info["file_name"]
        os.makedirs(root / name, exist_ok=True)
        with open(root / name / f"{name}.json", "w") as f:
            json.dump({"skeletons": rs.randn(frames, 20, 3).round(3).tolist()}, f)


def test_visualize_fusion_tool_matches_jax(tmp_path):
    import jax

    model = create_ctrgcn_nucla(base_channel=BC, generator=torch.Generator().manual_seed(5))
    skeleton = np.random.RandomState(5).randn(3, 52, 20, 1).astype(np.float32)
    got = visualize_fusion.joint_intensity(model, skeleton)
    jm = jax_create(use_pallas=False, base_channel=BC)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       flax_tree(to_flax_arrays(model.state_dict(), model)))
    want = jax_visualize.joint_intensity(jm, variables, skeleton)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(visualize_fusion.column_weight_map(want, (48, 64)),
                                  jax_visualize.column_weight_map(want, (48, 64)))

    data = tmp_path / "skeletons"
    _write_val_clips(data)
    weights = str(tmp_path / "full.pt")
    save_weights(create_ctrgcn_nucla(generator=torch.Generator().manual_seed(6)), weights)
    out = tmp_path / "vis.png"
    assert visualize_fusion.main(["--weights", weights, "--data_path", str(data),
                                  "--rgb_root", str(tmp_path / "none"), "--out", str(out),
                                  "--device", "cpu"]) == 0
    assert out.exists()


def test_bf16_convergence_rgb_family(capsys):
    rc = bf16_convergence.main(["--family", "rgb", "--device", "cpu", "--epochs", "1",
                                "--samples", "16", "--batch", "8"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "bf16_convergence_best_top1_delta_rgb"
    assert record["config"]["family"] == "rgb"
    assert rc == (0 if record["within_tol"] else 1)
    for run in ("f32", "bf16"):
        assert len(record[run]["train_loss"]) == 1
        assert np.isfinite(record[run]["train_loss"]).all()
        assert not any(record[run]["launches"].values())
