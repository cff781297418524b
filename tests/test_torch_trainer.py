"""The port's test phase end to end, on the CPU.

`python -m tamgcn_tpu_torch recognition -c configs/nucla/smoke.yaml --phase
test --use_gpu false` on weights converted from a JAX CTR-GCN (base_channel
8, with alpha, the TAM offset convs, gcn1/bn and the running stats perturbed
as in test_torch_model.py) writes a score pickle whose logits equal the JAX
model's on the same synthetic val samples, within rtol 1e-4 and atol
1e-4 * max|JAX| (f32, sum order differs). The flag values the JAX package
rejects raise, naming the flag, and so does --use_gpu true without CUDA.

--profile_dir writes a Chrome trace of the train phase. --debug_nans leaves
a clean run's losses, scores and weights as they are, and stops at a NaN
planted in one block's weight with FloatingPointError naming that block, in
the train phase and in the test phase, where the JAX trainer with
jax_debug_nans raises FloatingPointError on the same weights (ST-GCN, whose
reference .npz the JAX trainer imports at its shipped widths).
"""
import glob
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu.data.synthetic import SyntheticSkeletonFeeder as JaxSynthetic
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from test_torch_model import perturbed_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
SMOKE_RESNET = os.path.join(REPO, "configs", "nucla", "smoke_resnet.yaml")
BC = 8
N_VAL = 12  # two batches of 8, the second ragged


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(path of the converted .pt, the JAX model, its variables)."""
    jm = jax_create(use_pallas=False, base_channel=BC)
    x = np.zeros((2, 3, 52, 20, 1), np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    variables = perturbed_variables(jm, init, seed=5)
    model = create_ctrgcn_nucla(base_channel=BC)
    path = str(tmp_path_factory.mktemp("weights") / "converted.pt")
    torch.save(from_flax(variables, model), path)
    return path, jm, variables


def _argv(work_dir, weights_path, *extra):
    return [
        "recognition", "-c", SMOKE, "--phase", "test", "--use_gpu", "false",
        "--weights", weights_path, "--work_dir", str(work_dir),
        "--model_args", f"base_channel={BC}", "--save_result", "true",
        "--test_feeder_args", f"num_samples={N_VAL}", "--test_batch_size", "8",
        "--num_worker", "2", *extra,
    ]


def test_test_phase_scores_match_jax(weights, tmp_path):
    path, jm, variables = weights
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tamgcn_tpu_torch", *_argv(tmp_path, path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Evaluation Acc" in proc.stdout
    with open(tmp_path / "test_result.pkl", "rb") as f:
        scores = pickle.load(f)
    # the trainer keys the synthetic feeder on --seed (default 1)
    feeder = JaxSynthetic(num_samples=N_VAL, split="val", seed=1)
    assert list(scores) == feeder.sample_name
    x = np.stack([feeder[i][0] for i in range(N_VAL)])
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = np.stack([scores[name] for name in feeder.sample_name])
    assert got.shape == (N_VAL, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_use_gpu_without_cuda_raises(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    argv = _argv(tmp_path, weights[0])
    argv[argv.index("--use_gpu") + 1] = "true"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


# a flag the JAX package rejects in this setting (one process, no process
# group), with what completes the rejected combination, and the error
_REJECTED = {
    "data_parallel": (("--data_parallel", "2"), ValueError),
    "distributed": (("--distributed", "true"), RuntimeError),
    "graph_partition": (("--graph_partition", "ring", "--sequence_parallel", "true"),
                        ValueError),
    "model_parallel": (("--model_parallel", "2"), ValueError),
    "sequence_parallel": (("--sequence_parallel", "true", "--fast_eval", "true"),
                          ValueError),
    "use_pallas": (("--use_pallas", "true"), NotImplementedError),
}


@pytest.mark.parametrize("flag", sorted(_REJECTED))
def test_flag_of_a_later_slice_raises(flag, tmp_path, monkeypatch):
    """Each parallel flag runs (tests/test_torch_parallel_*.py); what the
    JAX package rejects raises, naming the flag: a grid larger than one rank
    without a process group, --distributed without the launcher, the
    mutually exclusive pairs; --use_pallas has no meaning in the port."""
    monkeypatch.delenv("RANK", raising=False)
    extra, error = _REJECTED[flag]
    argv = _argv(tmp_path, "unused.pt", *extra)
    with pytest.raises(error, match=flag):
        main(argv)


@pytest.mark.parametrize("weights_path,error", [
    ("w.npz", ValueError), ("ckpt_dir", ValueError),
])
def test_weights_other_than_pt_raise(weights_path, error, tmp_path):
    """Of the forms other than .pt, a directory (an orbax checkpoint) raises
    naming the bridge script, and a .npz that mixes the reference's tensor
    names with Flax paths raises; tests/test_torch_import.py loads the
    .npz forms."""
    path = tmp_path / weights_path
    if weights_path == "ckpt_dir":
        path.mkdir()
        match = "tools/export_flax_npz.py"
    else:
        np.savez(path, **{"fc.weight": np.zeros((10, 32), np.float32),
                          "params/fc/bias": np.zeros(10, np.float32)})
        match = "mixes"
    with pytest.raises(error, match=match):
        main(_argv(tmp_path, str(path)))


def test_test_phase_needs_weights(tmp_path):
    argv = _argv(tmp_path, "x.pt")
    i = argv.index("--weights")
    del argv[i:i + 2]
    with pytest.raises(ValueError, match="--weights"):
        main(argv)


def test_rgb_entry_points_raise(tmp_path):
    """The RGB entry point runs (tests/test_torch_cross_modal.py), block
    dropout in training included: its masks come from the seeded stream."""
    assert main(["recognition_rgb_only", "-c", SMOKE_RESNET, "--use_gpu", "false",
                 "--work_dir", str(tmp_path), "--num_worker", "1", "--batch_size", "2",
                 "--num_epoch", "1", "--print_log", "false",
                 "--train_feeder_args", "num_samples=2", "image_size=32",
                 "--test_feeder_args", "num_samples=2", "image_size=32",
                 "--model_args", "block_dropout=0.1"]) == 0
    tree = torch.load(tmp_path / "checkpoints" / "epoch1.pt", weights_only=True)
    assert tree["step"] == 1


def _train_argv(work_dir, *extra):
    return ["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir", str(work_dir),
            "--model_args", f"base_channel={BC}", "--num_epoch", "1", "--batch_size", "8",
            "--test_batch_size", "8", "--train_feeder_args", "num_samples=16",
            "--test_feeder_args", "num_samples=8", "--num_worker", "1",
            "--save_interval", "1", *extra]


def test_profile_dir_writes_a_trace(tmp_path):
    assert main(_train_argv(tmp_path / "run", "--profile_dir", str(tmp_path / "prof"))) == 0
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::convolution_backward" in names  # the train steps ran inside


def test_debug_nans_leaves_a_clean_run_unchanged(tmp_path):
    runs = {}
    for flag in ("false", "true"):
        work = tmp_path / flag
        assert main(_train_argv(work, "--debug_nans", flag, "--save_result", "true")) == 0
        runs[flag] = (np.loadtxt(work / "progress_info.csv", delimiter=",", ndmin=2),
                      torch.load(work / "checkpoints" / "epoch1.pt", weights_only=True))
    np.testing.assert_array_equal(runs["true"][0], runs["false"][0])
    for k, v in runs["false"][1]["model"].items():
        assert torch.equal(runs["true"][1]["model"][k], v), k


def test_debug_nans_names_the_block_of_a_planted_nan_in_training(weights, tmp_path):
    state = torch.load(weights[0], weights_only=True)
    state["l5.tcn1.pw_conv.weight"][0, 0] = float("nan")
    path = str(tmp_path / "nan.pt")
    torch.save(state, path)
    with pytest.raises(FloatingPointError,
                       match=r"module l5\.tcn1\.pw_conv, train step 0 \(epoch 1\)"):
        main(_train_argv(tmp_path / "run", "--weights", path, "--debug_nans", "true"))
    # without the flag the NaN trains on
    assert main(_train_argv(tmp_path / "off", "--weights", path)) == 0


def test_debug_nans_in_the_test_phase_raises_where_jax_does(tmp_path):
    from _weight_forms import reference_stgcn_state
    from tamgcn_tpu.train.config import load_config as jax_load_config
    from tamgcn_tpu.train.trainer import RecognitionTrainer as JaxTrainer

    state = reference_stgcn_state(8)
    state["st_gcn_networks.3.tcn.2.weight"][0, 0, 0, 0] = np.nan
    path = str(tmp_path / "nan.npz")
    np.savez(path, **state)
    argv = ["-c", SMOKE, "--phase", "test", "--model", "stgcn", "--weights", path,
            "--test_feeder_args", "num_samples=4", "--test_batch_size", "4",
            "--num_worker", "1", "--debug_nans", "true"]
    with pytest.raises(FloatingPointError, match=r"module blocks_3\.tcn_conv, eval batch 0"):
        main(["recognition", *argv, "--use_gpu", "false", "--work_dir", str(tmp_path / "port")])
    try:
        with pytest.raises(FloatingPointError):
            JaxTrainer(jax_load_config(argv + ["--work_dir", str(tmp_path / "jax")])).start()
    finally:
        jax.config.update("jax_debug_nans", False)
