"""The two faults of the port against the reference that this slice repairs.

  * --weights with a `.pt` of reference tensor names (what the reference
    saves, `torch.save(model.state_dict())`, `module.` prefixes allowed) is
    imported as the reference `.npz` is, for CTR-GCN and ST-GCN: the same
    state; a load that would leave most of the model at its init raises and
    names what it did not load (--ignore_weights' tensors aside); a
    directory of the port's checkpoints loads its best.pt, else its latest
    epoch{n}.pt, as the JAX trainer takes its checkpoint directory;
  * --data_parallel takes -1 and 1 on one rank and raises on anything
    else, naming the flag, as the JAX mesh does (a grid larger than one
    rank needs a process group); configs/ntu60.yaml as shipped
    (distributed: true) raises without the launcher, naming --distributed.
"""
import os

import numpy as np
import pytest
import torch

from _weight_forms import reference_ctrgcn_state, reference_stgcn_state
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, create_stgcn_nucla
from tamgcn_tpu_torch.train.checkpoint import (Checkpoints, load_weights, partial_update,
                                               read_weights)
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.parallel.mesh import make_mesh
from tamgcn_tpu_torch.train.config import check_supported, load_config
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8

CASES = {
    "ctrgcn": (lambda: reference_ctrgcn_state(11, base_channel=BC),
               lambda: create_ctrgcn_nucla(base_channel=BC),
               ["--model_args", f"base_channel={BC}"]),
    "stgcn": (lambda: reference_stgcn_state(12), create_stgcn_nucla,
              ["--model", "stgcn", "--model_args", "edge_importance_weighting=True"]),
}


def _trainer(tmp_path, weights, extra, *more):
    argv = ["-c", SMOKE, "--phase", "test", "--use_gpu", "false", "--weights", str(weights),
            "--work_dir", str(tmp_path / "run"), "--num_worker", "1", *extra, *more]
    return RecognitionTrainer(load_config(argv))


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("model_name", sorted(CASES))
def test_reference_named_pt_loads_as_the_reference_npz(model_name, prefix, tmp_path):
    ref, make, extra = CASES[model_name]
    sd = ref()
    np.savez(tmp_path / "ref.npz", **sd)
    torch.save({f"{prefix}{k}": torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "ref.pt")
    model = make()
    want = load_weights(str(tmp_path / "ref.npz"), model_name, model)
    assert read_weights(str(tmp_path / "ref.pt"))[0] == "reference pt"
    got = load_weights(str(tmp_path / "ref.pt"), model_name, model)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    trainer = _trainer(tmp_path, tmp_path / "ref.pt", extra)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with open(tmp_path / "run" / "log.txt") as f:
        assert "(reference pt)" in f.read()


def test_a_load_that_leaves_most_of_the_model_at_init_raises(tmp_path):
    # ST-GCN weights for a CTR-GCN: no name in common
    torch.save(create_stgcn_nucla().state_dict(), tmp_path / "stgcn.pt")
    with pytest.raises(ValueError, match="leave the rest at init .first not loaded: l1"):
        _trainer(tmp_path, tmp_path / "stgcn.pt", CASES["ctrgcn"][2])
    # a CTR-GCN's with two thirds of its tensors dropped
    state = create_ctrgcn_nucla(base_channel=BC).state_dict()
    keep = {k: v for i, (k, v) in enumerate(state.items()) if i % 3 == 0}
    model = create_ctrgcn_nucla(base_channel=BC)
    with pytest.raises(ValueError, match=f"load {len(keep)} of the {len(state)} tensors"):
        partial_update(model, keep)
    # tensors --ignore_weights drops on purpose are not counted
    ignored = ["gcn1", "tcn1"]
    kept = {k: v for k, v in state.items() if not any(ig in k for ig in ignored)}
    assert len(kept) < len(state) / 4
    partial_update(model, kept, log=lambda line: None, ignore_keys=ignored)
    with pytest.raises(ValueError):
        partial_update(model, kept)


def test_checkpoint_directory_loads_best_else_latest_epoch(tmp_path):
    ckpts = Checkpoints(str(tmp_path / "checkpoints"))
    models = {name: create_ctrgcn_nucla(base_channel=BC,
                                        generator=torch.Generator().manual_seed(i))
              for i, name in enumerate(("epoch2", "epoch10", "best"))}
    for name in ("epoch2", "epoch10"):
        ckpts.save(name, models[name], step=3, optimizer={"state": {}, "param_groups": []})
    extra = CASES["ctrgcn"][2]
    for name in ("epoch10", "best"):
        if name == "best":
            ckpts.save("best", models["best"], step=4)
        trainer = _trainer(tmp_path, ckpts.directory, extra)
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(v, models[name].state_dict()[k]), (name, k)
        with open(tmp_path / "run" / "log.txt") as f:
            assert f"({ckpts.path(name)}) (pt)" in f.read()


@pytest.mark.parametrize("value,ok", [("-1", True), ("1", True), ("2", False),
                                      ("8", False), ("0", False)])
def test_data_parallel_takes_one_device(value, ok):
    arg = load_config(["-c", SMOKE, "--data_parallel", value])
    check_supported(arg)
    if ok:
        assert make_mesh(arg.data_parallel, arg.model_parallel).size == 1
    else:
        with pytest.raises(ValueError, match="data_parallel"):
            make_mesh(arg.data_parallel, arg.model_parallel)


def test_ntu60_as_shipped_names_distributed(monkeypatch):
    ntu = os.path.join(REPO, "configs", "ntu60.yaml")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="--distributed true needs the launcher"):
        main(["recognition", "-c", ntu])
    check_supported(load_config(["-c", ntu]))
    check_supported(load_config(["-c", ntu, "--distributed", "false"]))
