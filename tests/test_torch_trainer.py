"""The port's test phase end to end, on the CPU.

`python -m tamgcn_tpu_torch recognition -c configs/nucla/smoke.yaml --phase
test --use_gpu false` on weights converted from a JAX CTR-GCN (base_channel
8, with alpha, the TAM offset convs, gcn1/bn and the running stats perturbed
as in test_torch_model.py) writes a score pickle whose logits equal the JAX
model's on the same synthetic val samples, within rtol 1e-4 and atol
1e-4 * max|JAX| (f32, sum order differs). The flags of what the slice lacks
raise, and so does --use_gpu true without CUDA.
"""
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
from tamgcn_tpu_torch.train.config import _NOT_PORTED
from test_torch_model import perturbed_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
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


_OTHER_VALUE = {
    "use_pallas": "true", "sequence_parallel": "true", "graph_partition": "ring",
    "model_parallel": "2", "profile_dir": "/nonexistent", "debug_nans": "true",
    "distributed": "true",
}


@pytest.mark.parametrize("flag", sorted(_NOT_PORTED))
def test_flag_of_a_later_slice_raises(flag, tmp_path):
    argv = _argv(tmp_path, "unused.pt", f"--{flag}", _OTHER_VALUE[flag])
    with pytest.raises(NotImplementedError, match=flag):
        main(argv)


@pytest.mark.parametrize("weights_path,error", [
    ("w.npz", NotImplementedError), ("ckpt_dir", NotImplementedError),
])
def test_weights_other_than_pt_raise(weights_path, error, tmp_path):
    with pytest.raises(error, match="weight importers"):
        main(_argv(tmp_path, weights_path))


def test_test_phase_needs_weights(tmp_path):
    argv = _argv(tmp_path, "x.pt")
    i = argv.index("--weights")
    del argv[i:i + 2]
    with pytest.raises(ValueError, match="--weights"):
        main(argv)


def test_rgb_entry_points_raise():
    with pytest.raises(NotImplementedError, match="RGB slice"):
        main(["recognition_rgb_only", "-c", SMOKE])
