"""The port's weight importers and the three forms of --weights (CPU).

Reference state dicts are built from the reference layer shapes with random
arrays (tests/_weight_forms.py; the reference checkpoints are not in the
repository): CTR-GCN at two base_channels and ST-GCN with edge importance.
Element for element (exact equality):
  * `utils.torch_import.import_state_dict(name, sd, model)` equals
    `convert.from_flax(JAX import_*_state_dict(sd))`, and `module.`-prefixed
    keys load the same as bare ones;
  * `--weights` as a `.pt`, a reference-named `.npz` and a Flax-layout `.npz`
    of the same weights gives the same model state and the same test-phase
    scores, through the trainer;
  * an orbax checkpoint of the JAX trainer, turned into a Flax `.npz` by
    tools/export_flax_npz.py, gives the port logits within rtol 1e-5 (and
    atol 1e-5 * max |JAX|) of the JAX model's in f32.
A directory, a `.npz` that mixes key forms and an unknown model name raise.
"""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _weight_forms import (reference_ctrgcn_state, reference_stgcn_state, to_flax_arrays,
                           to_reference_state)
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.train.checkpoint import Checkpointer
from tamgcn_tpu.utils.torch_import import import_ctrgcn_state_dict, import_stgcn_state_dict
from tamgcn_tpu_torch.convert import flax_param_paths, from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, create_stgcn_nucla, get_model
from tamgcn_tpu_torch.train.checkpoint import flax_tree, load_weights, read_weights
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
from tamgcn_tpu_torch.utils.torch_import import import_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
sys.path.insert(0, os.path.join(REPO, "tools"))
import export_flax_npz  # noqa: E402

BC = 8


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


CASES = {
    "ctrgcn-bc8": ("ctrgcn", lambda: reference_ctrgcn_state(1, base_channel=8),
                   lambda: create_ctrgcn_nucla(base_channel=8),
                   lambda sd: import_ctrgcn_state_dict(sd, base_channel=8)),
    "ctrgcn-bc16": ("models.ctrgcn.Model", lambda: reference_ctrgcn_state(2, base_channel=16),
                    lambda: create_ctrgcn_nucla(base_channel=16),
                    lambda sd: import_ctrgcn_state_dict(sd, base_channel=16)),
    "stgcn": ("stgcn", lambda: reference_stgcn_state(3), create_stgcn_nucla,
              import_stgcn_state_dict),
    "stgcn-alias": ("models.stgcn.Model", lambda: reference_stgcn_state(4),
                    create_stgcn_nucla, import_stgcn_state_dict),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_equals_jax_importer_then_from_flax(case):
    name, ref, make, jax_import = CASES[case]
    sd, model = ref(), make()
    got = import_state_dict(name, sd, model)
    _equal(got, from_flax(jax_import(sd), model))
    # the import is the inverse of tests/_weight_forms.to_reference_state
    back = to_reference_state(got, "stgcn" if "stgcn" in name else "ctrgcn")
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


@pytest.mark.parametrize("case", ["ctrgcn-bc8", "stgcn"])
def test_module_prefix_loads_as_bare_keys(case):
    name, ref, make, _ = CASES[case]
    sd, model = ref(), make()
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    _equal(import_state_dict(name, prefixed, model), import_state_dict(name, sd, model))


def test_import_refuses_unknown_models_and_incomplete_dicts():
    sd = reference_stgcn_state(0)
    model = create_stgcn_nucla()
    with pytest.raises(ValueError, match="no reference state-dict importer"):
        import_state_dict("stgcn_v2", sd, model)
    # an ST-GCN state dict is no ResNet's
    with pytest.raises(KeyError, match="conv1.weight"):
        import_state_dict("resnet_only", sd, get_model("resnet_only", num_class=10))
    del sd["fcn.bias"]
    with pytest.raises(KeyError):
        import_state_dict("stgcn", sd, model)
    # edge importance left out: from_flax leaves the port tensor unset
    sd = {k: v for k, v in reference_stgcn_state(0).items()
          if not k.startswith("edge_importance.3")}
    with pytest.raises(KeyError, match="left unset"):
        import_state_dict("stgcn", sd, model)


def test_flax_param_paths_name_stgcn_parameters():
    paths = flax_param_paths(create_stgcn_nucla())
    assert paths["blocks_4.res_bn.weight"] == "blocks_4/res_bn/scale"
    assert paths["blocks_0.gcn.conv.weight"] == "blocks_0/gcn/conv/kernel"
    assert paths["blocks_9.tcn_conv.weight"] == "blocks_9/tcn_conv/kernel"
    assert paths["edge_importance_7"] == "edge_importance_7"
    assert paths["fcn.weight"] == "fcn/kernel"


# ---- the three forms through the trainer's test phase -------------------------

def _forms(tmp_path, model_name, state, model):
    """The same weights as .pt, reference .npz and Flax .npz files."""
    paths = {"pt": str(tmp_path / "w.pt"), "reference npz": str(tmp_path / "ref.npz"),
             "flax npz": str(tmp_path / "flax.npz")}
    torch.save(state, paths["pt"])
    np.savez(paths["reference npz"], **to_reference_state(state, model_name))
    np.savez(paths["flax npz"], **to_flax_arrays(state, model))
    return paths


def _test_phase(work_dir, weights, *extra):
    argv = ["-c", SMOKE, "--phase", "test", "--use_gpu", "false", "--weights", weights,
            "--work_dir", str(work_dir), "--save_result", "true", "--num_worker", "1",
            "--test_feeder_args", "num_samples=6", "--test_batch_size", "6", *extra]
    trainer = RecognitionTrainer(load_config(argv))
    trainer.start()
    with open(os.path.join(str(work_dir), "test_result.pkl"), "rb") as f:
        return trainer, pickle.load(f)


@pytest.mark.parametrize("model_name", ["ctrgcn", "stgcn"])
def test_weights_forms_give_the_same_test_phase(model_name, tmp_path):
    if model_name == "ctrgcn":
        ref = reference_ctrgcn_state(5, base_channel=BC)
        model = create_ctrgcn_nucla(base_channel=BC)
        want = from_flax(import_ctrgcn_state_dict(ref, base_channel=BC), model)
        extra = ["--model_args", f"base_channel={BC}"]
    else:
        ref, model = reference_stgcn_state(6), create_stgcn_nucla()
        want = from_flax(import_stgcn_state_dict(ref), model)
        extra = ["--model", "stgcn", "--model_args", "edge_importance_weighting=True"]
    paths = _forms(tmp_path, model_name, want, model)
    scores = {}
    for form, path in paths.items():
        assert read_weights(path)[0] == form
        _equal(load_weights(path, model_name, model), want)
        trainer, scores[form] = _test_phase(tmp_path / form.replace(" ", "_"), path, *extra)
        _equal({k: v for k, v in trainer.model.state_dict().items()}, want)
    for form in paths:
        assert list(scores[form]) == list(scores["pt"])
        for k in scores["pt"]:
            np.testing.assert_array_equal(scores[form][k], scores["pt"][k])


def test_ignore_weights_applies_to_npz_forms(tmp_path):
    ref, model = reference_ctrgcn_state(7, base_channel=BC), create_ctrgcn_nucla(base_channel=BC)
    state = from_flax(import_ctrgcn_state_dict(ref, base_channel=BC), model)
    path = _forms(tmp_path, "ctrgcn", state, model)["reference npz"]
    trainer, _ = _test_phase(tmp_path / "run", path, "--model_args", f"base_channel={BC}",
                             "--ignore_weights", "fc.")
    got = trainer.model.state_dict()
    fresh = create_ctrgcn_nucla(base_channel=BC,
                                generator=torch.Generator().manual_seed(1)).state_dict()
    assert torch.equal(got["fc.weight"], fresh["fc.weight"])
    assert torch.equal(got["l3.gcn1.PA"], state["l3.gcn1.PA"])
    with open(os.path.join(str(tmp_path / "run"), "log.txt")) as f:
        log = f.read()
    assert "(reference npz)" in log and "checkpoint missing weight: fc.weight" in log


def test_weights_forms_that_raise(tmp_path):
    model = create_stgcn_nucla()
    ckpt = tmp_path / "orbax_checkpoints"
    ckpt.mkdir()
    with pytest.raises(ValueError, match="tools/export_flax_npz.py"):
        load_weights(str(ckpt), "stgcn", model)
    mixed = dict(reference_stgcn_state(0))
    mixed["params/fcn/bias"] = mixed.pop("fcn.bias")
    np.savez(tmp_path / "mixed.npz", **mixed)
    with pytest.raises(ValueError, match="mixes"):
        load_weights(str(tmp_path / "mixed.npz"), "stgcn", model)
    with pytest.raises(ValueError, match=".pt or a .npz"):
        load_weights(str(tmp_path / "w.ckpt"), "stgcn", model)


def test_orbax_checkpoint_through_the_bridge(tmp_path):
    """tools/export_flax_npz.py on a JAX training checkpoint: the port's
    logits on the exported .npz within rtol 1e-5 of the JAX model's (f32)."""
    from test_torch_model import perturbed_variables

    jm = jax_create(use_pallas=False, base_channel=BC)
    x = np.random.RandomState(0).randn(4, 3, 16, 20, 1).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    variables = perturbed_variables(jm, init, seed=3)
    ckptr = Checkpointer(str(tmp_path / "checkpoints"))
    ckptr.save("epoch3", {"params": variables["params"],
                          "batch_stats": variables["batch_stats"],
                          "step": np.array(12, np.int32)})
    out = str(tmp_path / "exported.npz")
    rc = export_flax_npz.main([str(tmp_path / "checkpoints"), "-c", SMOKE, "-o", out,
                               "--model_args", f"base_channel={BC}", "use_pallas=False"])
    assert rc == 0
    with np.load(out) as f:
        assert all(k.split("/")[0] in ("params", "batch_stats") for k in f.files)
    model = create_ctrgcn_nucla(base_channel=BC)
    assert read_weights(out)[0] == "flax npz"
    model.load_state_dict(load_weights(out, "ctrgcn", model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    # the tree the bridge wrote is the checkpoint's, leaf for leaf
    tree = flax_tree(dict(np.load(out)))
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[col])[0]:
            node = tree[col]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
