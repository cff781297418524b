"""The cross-modal fusion family (models/resnet_gcn_attention.py, its
feeders, train/trainer_cross_modal.py) and the RGB and fusion subcommands,
against the JAX package on the CPU.

  * the fusion model in f64 (seeded port weights, the GCN's alpha, offset
    convs and gcn1 BatchNorm scales moved off their init, running
    statistics of a calibration batch of 8, handed to the JAX model through
    the Flax layout): eval logits within 1e-9 * max |logit|; the train-mode
    forward with freeze_gcn_bn True (the GCN in eval mode, its statistics
    unchanged) and False (the GCN's BatchNorms on batch statistics, updated
    as JAX's) within 1e-9, with every BatchNorm statistic; the gradients of
    every parameter within 1e-9 relative, zero on the GCN (JAX's
    stop_gradient), and with freeze_gcn=False flowing into the GCN. f64, since in f32 ResNet-50's train-mode BatchNorm over
    four values per channel at layer4 amplifies rounding past any fixed
    f32 tolerance;
  * `import_state_dict("resnet_gcn_attention")` against JAX's
    import_fusion_state_dict then from_flax;
  * the RGB and fusion feeders bit for bit against JAX's: synthetic, and in
    the dataset's layout from small PNGs and skeleton JSONs (missing and
    unreadable files give the reference's black image and zero skeleton);
    an image that exists while Pillow is missing raises ImportError naming
    Pillow (JAX's feeders return black images there), and the synthetic
    feeders never import Pillow;
  * CrossModalTrainer on configs/nucla/smoke_cross_modal.yaml for one epoch,
    the GCN's tensors bit for bit where they started, with a CTR-GCN's
    weights from each form (port `.pt`, reference `.npz` and `.pt`, Flax
    `.npz`, a checkpoint directory) landing in `gcn`;
  * the recognition_rgb_only, recognition_cross_modal and recognition_fusion
    subcommands through `__main__.main` at tiny sizes.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _weight_forms import reference_fusion_state, to_flax_arrays, to_reference_state
from tamgcn_tpu import data as jax_data
from tamgcn_tpu.models.resnet_gcn_attention import ResNetGCNAttention as JaxFusion
from tamgcn_tpu.utils.torch_import import import_fusion_state_dict
from tamgcn_tpu_torch import data
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, get_model
from tamgcn_tpu_torch.ops.norm import BatchNorm
from tamgcn_tpu_torch.train.checkpoint import Checkpoints, flax_tree
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.trainer_cross_modal import CrossModalTrainer
from tamgcn_tpu_torch.utils.torch_import import import_state_dict

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs", "nucla")
KW = dict(num_class=10, num_point=20, num_person=1, graph="ucla",
          graph_args={"labeling_mode": "spatial"}, in_channels_rgb=15)
T, S = 16, 64  # skeleton frames, image size


def _perturb_gcn(gcn, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in gcn.state_dict().items():
            noise = torch.randn(t.shape, generator=g, dtype=t.dtype)
            if name.endswith("gcn1.alpha"):
                t.copy_(0.5 * noise)
            elif "offset_conv.weight" in name:
                t.add_(0.02 * noise)
            elif name.endswith("gcn1.bn.weight"):
                t.copy_(1.0 + 0.1 * noise)


@pytest.fixture(scope="module")
def fusion():
    """(f64 port model, its Flax variables, inputs of 4 samples)."""
    model = get_model("resnet_gcn_attention", freeze_gcn_bn=False,
                      generator=torch.Generator().manual_seed(0), **KW).double()
    _perturb_gcn(model.gcn, 1)
    rs = np.random.RandomState(0)
    xg, xr = rs.randn(12, 3, T, 20, 1), rs.randn(12, 15, S, S)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():  # running statistics of a calibration batch of 8
        for bn in bns:
            bn.momentum = 1.0
        model.train()(torch.from_numpy(xg[:8]), torch.from_numpy(xr[:8]))
        for bn in bns:
            bn.momentum = 0.1
    model.freeze_gcn_bn = True
    variables = flax_tree(to_flax_arrays(model.state_dict(), model))
    return model, variables, (xg[8:], xr[8:])


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


def test_eval_logits_match_jax(fusion):
    model, variables, (xg, xr) = fusion
    with jax.enable_x64(True):
        want = JaxFusion(use_pallas=False, **KW).apply(variables, jnp.asarray(xg),
                                                       jnp.asarray(xr), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xg), torch.from_numpy(xr))
    assert got.shape == (4, 10) and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-9)


@pytest.mark.parametrize("freeze_gcn_bn", [True, False])
def test_train_mode_forward_and_statistics_match_jax(fusion, freeze_gcn_bn):
    model, variables, (xg, xr) = fusion
    port = get_model("resnet_gcn_attention", freeze_gcn_bn=freeze_gcn_bn, **KW).double()
    port.load_state_dict(model.state_dict())
    port.train()
    assert port.gcn.training is not freeze_gcn_bn
    assert all(m.training for m in port.resnet.modules())
    with jax.enable_x64(True):
        jm = JaxFusion(use_pallas=False, freeze_gcn_bn=freeze_gcn_bn, **KW)
        want, new = jm.apply(variables, jnp.asarray(xg), jnp.asarray(xr), train=True,
                             mutable=["batch_stats"])
        want_state = from_flax({"params": variables["params"], **jax.device_get(new)}, port)
    before = {k: v.clone() for k, v in port.gcn.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(xg), torch.from_numpy(xr))
    _close(got.numpy(), want, 1e-9, "logits")
    # a statistic whose exact value is 0 (the mean of a conv fed by a
    # train-mode BatchNorm, its bias 0) is rounding noise: an absolute floor
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=k)
    moved = [k for k, v in port.gcn.state_dict().items() if not torch.equal(v, before[k])]
    if freeze_gcn_bn:
        assert not moved
    else:
        assert moved and all(k.endswith(("running_mean", "running_var")) for k in moved)


@pytest.mark.parametrize("freeze_gcn", [True, False])
def test_gradients_match_jax_and_are_zero_on_the_gcn(fusion, freeze_gcn):
    model, variables, (xg, xr) = fusion
    y = np.array([1, 4, 0, 7])
    jm = JaxFusion(use_pallas=False, freeze_gcn=freeze_gcn, **KW)

    def loss(params, stats, a, b, labels):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, a, b, train=True,
                          mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(out, labels).mean()

    with jax.enable_x64(True):
        value, grads = jax.jit(jax.value_and_grad(loss))(
            variables["params"], variables["batch_stats"], jnp.asarray(xg), jnp.asarray(xr),
            jnp.asarray(y))
        want = from_flax({"params": jax.device_get(grads),
                          "batch_stats": variables["batch_stats"]}, model)
    port = get_model("resnet_gcn_attention", freeze_gcn=freeze_gcn, **KW).double()
    port.load_state_dict(model.state_dict())
    logits = port.train()(torch.from_numpy(xg), torch.from_numpy(xr))
    got_loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    names, params = zip(*port.named_parameters())
    got = torch.autograd.grad(got_loss, params, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(got_loss.item(), float(value), rtol=1e-12)
    top = max(float(want[n].abs().max()) for n in names)
    bad = []
    for name, g in zip(names, got):
        w = want[name].numpy()
        if freeze_gcn and name.startswith("gcn."):
            assert not w.any() and not g.any(), name
            continue
        err = np.abs(g.numpy() - w)
        if (err > 1e-9 * np.abs(w) + 1e-9 * top).any():
            bad.append(f"{name}: max err {err.max():.3e}, max|jax| {np.abs(w).max():.3e}")
    assert not bad, bad
    gcn = [g for name, g in zip(names, got) if name.startswith("gcn.")]
    assert all(g.any() for g in gcn[:4]) is not freeze_gcn


def test_fusion_importer_equals_jax():
    sd = reference_fusion_state(3)
    model = get_model("resnet_gcn_attention", **KW)
    got = import_state_dict("models.resnet_gcn_attention.ResNet_GCN_Attention", sd, model)
    want = from_flax(import_fusion_state_dict(sd), model)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- feeders ------------------------------------------------------------------

def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_synthetic_feeders_match_jax_without_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, kw in (("synthetic_rgb", dict(image_size=16, temporal_rgb_frames=2)),
                     ("synthetic_fusion", dict(image_size=16, temporal_rgb_frames=5))):
        for split in ("train", "val"):
            got = data.get_feeder(name, num_samples=6, split=split, seed=3, **kw)
            want = jax_data.get_feeder(name, num_samples=6, split=split, seed=3, **kw)
            for epoch in (0, 1):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                for i in range(6):
                    _same(got[i], want[i])


@pytest.fixture(scope="module")
def nucla_layout(tmp_path_factory):
    """ST-ROI PNGs (and a JPG) and skeleton JSONs for the first names of
    both split lists, in the datasets' layouts; some names left out, one
    image unreadable, one skeleton in the (T, 60) "data" form."""
    from PIL import Image

    root = tmp_path_factory.mktemp("nucla")
    rgb, ske = root / "st_roi", root / "all_sqe"
    rgb.mkdir()
    ske.mkdir()
    rs = np.random.RandomState(5)
    for split in ("train", "val"):
        for i, info in enumerate(data.load_nucla_split(split)[:10]):
            name = info["file_name"]
            if i == 6:
                continue  # missing: black image, zero skeleton
            img = Image.fromarray(rs.randint(0, 256, (40 + i, 48, 3), np.uint8))
            if i == 7:
                (rgb / f"{name}.png").write_bytes(b"not an image")
            else:
                img.save(rgb / (f"{name}.jpg" if i == 5 else f"{name}.png"))
            frames = int(rs.randint(20, 70))
            skel = rs.randn(frames, 20, 3)
            key, value = ("data", skel.reshape(frames, 60)) if i == 4 else ("skeletons", skel)
            (ske / f"{name}.json").write_text(__import__("json").dumps({key: value.tolist()}))
    return str(rgb), str(ske)


@pytest.mark.parametrize("split", ["train", "val"])
def test_image_and_fusion_feeders_match_jax(nucla_layout, split):
    rgb, ske = nucla_layout
    resnet_kw = dict(rgb_path=rgb, split=split, random_flip=True, size=32, seed=2,
                     temporal_rgb_frames=2)
    fusion_kw = dict(skeleton_root=ske, rgb_root=rgb, split=split, window_size=52,
                     temporal_rgb_frames=5, seed=2, random_choose=split == "train",
                     random_shift=split == "train", random_move=split == "train")
    for name, kw in (("nucla_resnet", resnet_kw), ("nucla_fusion", fusion_kw)):
        got, want = data.get_feeder(name, **kw), jax_data.get_feeder(name, **kw)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for i in range(10):
                _same(got[i], want[i])
    black = data.get_feeder("nucla_resnet", **resnet_kw)
    assert not black[6][0].any() and not black[7][0].any() and black[0][0].any()


def test_an_image_without_pillow_raises(nucla_layout, monkeypatch):
    rgb, ske = nucla_layout
    monkeypatch.setitem(sys.modules, "PIL", None)
    resnet = data.get_feeder("nucla_resnet", rgb_path=rgb, split="val", size=32)
    fusion = data.get_feeder("nucla_fusion", skeleton_root=ske, rgb_root=rgb, split="val",
                             window_size=52)
    for feeder in (resnet, fusion):
        with pytest.raises(ImportError, match="Pillow"):
            feeder[0]
        assert not feeder[6][-3 if feeder is fusion else 0].any()  # missing: black
    # the JAX feeder returns a black image for every sample there
    jax_resnet = jax_data.get_feeder("nucla_resnet", rgb_path=rgb, split="val", size=32)
    assert not jax_resnet[0][0].any()


# ---- the trainer and the subcommands -----------------------------------------

SMOKE_CM = os.path.join(CONFIGS, "smoke_cross_modal.yaml")
TINY = ["--use_gpu", "false", "--num_worker", "1", "--batch_size", "4",
        "--test_batch_size", "4", "--train_feeder_args", "num_samples=4", "image_size=32",
        "--test_feeder_args", "num_samples=4", "image_size=32"]


@pytest.fixture(scope="module")
def ctrgcn_forms(tmp_path_factory):
    """A full-width NW-UCLA CTR-GCN's weights in every form --weights takes."""
    root = tmp_path_factory.mktemp("forms")
    model = create_ctrgcn_nucla(generator=torch.Generator().manual_seed(4))
    _perturb_gcn(model, 2)
    state = model.state_dict()
    ckpts = Checkpoints(str(root / "checkpoints"))
    ckpts.save("best", model, step=1)
    ref = to_reference_state(state, "ctrgcn")
    np.savez(root / "ref.npz", **ref)
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in ref.items()}, root / "ref.pt")
    np.savez(root / "flax.npz", **to_flax_arrays(state, model))
    paths = {"pt": ckpts.path("best"), "directory": ckpts.directory,
             "reference npz": str(root / "ref.npz"), "reference pt": str(root / "ref.pt"),
             "flax npz": str(root / "flax.npz")}
    return {k: v for k, v in state.items() if not k.startswith("fc.")}, paths


def _gcn_equal(model, want):
    got = model.gcn.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("form", ["pt", "directory", "reference npz", "reference pt",
                                  "flax npz"])
def test_ctrgcn_weights_land_in_gcn(ctrgcn_forms, form, tmp_path):
    want, paths = ctrgcn_forms
    trainer = CrossModalTrainer(load_config(
        ["-c", SMOKE_CM, "--phase", "test", "--weights", paths[form], "--work_dir",
         str(tmp_path), *TINY]))
    _gcn_equal(trainer.model, want)
    fresh = get_model("resnet_gcn_attention", generator=torch.Generator().manual_seed(1), **KW)
    for k, v in trainer.model.state_dict().items():
        if not k.startswith("gcn."):
            assert torch.equal(v, fresh.state_dict()[k]), k


def test_one_epoch_leaves_the_frozen_gcn_where_it_started(ctrgcn_forms, tmp_path):
    """smoke_cross_modal.yaml (freeze_gcn, --freeze_params gcn) for one epoch
    through `recognition_cross_modal`; its weights, then its own best.pt
    through `recognition_fusion` (the whole fusion model loads)."""
    want, paths = ctrgcn_forms
    work = tmp_path / "train"
    argv = ["-c", SMOKE_CM, "--weights", paths["pt"], "--work_dir", str(work), *TINY]
    trainer = CrossModalTrainer(load_config(argv))
    trainer.start()
    _gcn_equal(trainer.model, want)
    saved = torch.load(work / "checkpoints" / "epoch1.pt", weights_only=True)["model"]
    moved = [k for k in saved if not k.startswith("gcn.")
             and not torch.equal(saved[k], trainer.model.state_dict()[k])]
    assert not moved
    assert any(not torch.equal(saved[k], v) for k, v in get_model(
        "resnet_gcn_attention", generator=torch.Generator().manual_seed(1),
        **KW).state_dict().items() if k.startswith("classifier"))
    assert main(["recognition_fusion", "-c", os.path.join(CONFIGS, "fused.yaml"),
                 "--phase", "test", "--weights", str(work / "checkpoints" / "epoch1.pt"),
                 "--feeder", "synthetic_fusion", "--work_dir", str(tmp_path / "fused"),
                 "--save_result", "true", *TINY]) == 0
    with open(tmp_path / "fused" / "log.txt") as f:
        assert "(pt)" in f.read()


def test_rgb_only_subcommand_trains_and_tests(tmp_path):
    argv = ["-c", os.path.join(CONFIGS, "smoke_resnet.yaml"), "--num_epoch", "1", *TINY]
    assert main(["recognition_rgb_only", *argv, "--work_dir", str(tmp_path / "train")]) == 0
    assert main(["recognition_rgb_only", *argv, "--work_dir", str(tmp_path / "test"),
                 "--phase", "test", "--weights",
                 str(tmp_path / "train" / "checkpoints")]) == 0
    assert main(["recognition_cross_modal", "-c", SMOKE_CM, "--work_dir",
                 str(tmp_path / "cm"), "--num_epoch", "1", *TINY]) == 0
