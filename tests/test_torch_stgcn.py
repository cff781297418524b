"""The port's ST-GCN against the JAX package's, on the CPU.

A `create_stgcn_nucla()` of the JAX package (full width: 10 blocks, 64 ->
256 channels) is initialised, moved off its init values (edge importance
1 + 0.2 N(0, 1), BatchNorm scale and bias perturbed) and its running
statistics calibrated to the batch statistics of a train-mode pass, then
converted with `convert.from_flax`. Inputs are made with numpy from a seed.
  * `ops.stgcn_aggregate` against the JAX einsum: f32 within rtol 1e-6 and
    atol 1e-6 * max, f64 within 1e-12;
  * f32 eval: the logits, every block's output and both maps of
    `extract_feature` within rtol 1e-4 and atol 1e-4 * max |JAX|;
  * train mode in f64 (JAX x64; its value_and_grad jitted once, at one
    shape): the loss, the gradient of every parameter (edge importance
    included) and every BatchNorm statistic within 1e-9 relative;
  * bf16 compute (f32 parameters): the logits within one bf16 rounding
    (2^-8) of max |JAX bf16 logit| of the JAX bf16 model's;
  * `edge_importance_per_joint` equal to the JAX function's, exactly;
  * `python -m tamgcn_tpu_torch recognition -c configs/nucla/stgcn.yaml`
    with the synthetic feeder and `--use_gpu false` trains, evaluates and
    writes checkpoints; --fast_eval on ST-GCN warns and evaluates normally.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.models import create_stgcn_nucla as jax_create
from tamgcn_tpu.models import edge_importance_per_joint as jax_edge_per_joint
from tamgcn_tpu.ops.aggregation import stgcn_aggregate as jax_aggregate
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_stgcn_nucla, edge_importance_per_joint, get_model
from tamgcn_tpu_torch.models.stgcn import STGCN
from tamgcn_tpu_torch.ops import dropout
from tamgcn_tpu_torch.ops.aggregation import stgcn_aggregate

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STGCN_YAML = os.path.join(REPO, "configs", "nucla", "stgcn.yaml")
T = 16


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v)) for k, v in tree.items()}


def _variables(jm, seed=0):
    """Init, perturbed and calibrated f32 variables of the JAX model."""
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 3, T, 20, 1).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False))

    def perturb(path, v):
        if path[-1].startswith("edge_importance"):
            return (v + 0.2 * rs.randn(*v.shape)).astype(np.float32)
        if path[-1] in ("scale", "bias") and "bn" in path[-2]:
            return (v + 0.1 * rs.randn(*v.shape)).astype(np.float32)
        return v

    params = _map(init["params"], perturb)
    # a train-mode pass from zeroed statistics leaves 0.1 x the batch
    # statistics (momentum 0.9): the running statistics become the batch's
    zero = _map(init["batch_stats"], lambda p, v: np.zeros_like(v))
    _, new = jm.apply({"params": params, "batch_stats": zero}, jnp.asarray(x),
                      train=True, mutable=["batch_stats"])
    stats = _map(jax.device_get(new["batch_stats"]), lambda p, v: 10.0 * v)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def f32():
    jm = jax_create()
    variables = _variables(jm)
    model = create_stgcn_nucla()
    model.load_state_dict(from_flax(variables, model))
    return jm, variables, model.eval()


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_stgcn_aggregate_matches_jax(dtype, rtol):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 20, 3, 8).astype(dtype)
    A = rs.rand(3, 20, 20).astype(dtype)
    with jax.enable_x64(bool(dtype == np.float64)):
        want = np.asarray(jax_aggregate(jnp.asarray(x), jnp.asarray(A)))
    got = stgcn_aggregate(torch.from_numpy(x), torch.from_numpy(A))
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got.numpy(), want, rtol)
    # bf16 activations with the f32 adjacency sum and return in f32
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    assert stgcn_aggregate(xb, torch.from_numpy(A.astype(np.float32))).dtype == torch.float32


def test_eval_logits_blocks_and_features_match_jax(f32):
    jm, variables, model = f32
    x = np.random.RandomState(2).randn(3, 3, T, 20, 1).astype(np.float32)
    want, inter = jm.apply(variables, jnp.asarray(x), train=False,
                           capture_intermediates=True)
    outs = {}
    hooks = [blk.register_forward_hook(lambda m, a, o, i=i: outs.__setitem__(i, o))
             for i, blk in enumerate(model.blocks)]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    _close(got, want, 1e-4, "logits")
    for i in range(10):
        ref = inter["intermediates"][f"blocks_{i}"]["__call__"][0]
        _close(outs[i].numpy(), ref, 1e-4, f"blocks_{i}")
    w_out, w_feat = jm.apply(variables, jnp.asarray(x), train=False,
                             method=jm.extract_feature)
    with torch.no_grad():
        g_out, g_feat = model.extract_feature(torch.from_numpy(x))
    assert g_out.shape == (3, 10, T // 4, 20, 1) and g_feat.shape == (3, 256, T // 4, 20, 1)
    _close(g_out.numpy(), w_out, 1e-4, "extract_feature output")
    _close(g_feat.numpy(), w_feat, 1e-4, "extract_feature feature")


def _jax_loss(jm, params, stats, x, y):
    out, mutated = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
    return optax.softmax_cross_entropy_with_integer_labels(out, y).mean(), \
        mutated["batch_stats"]


def test_train_grads_and_stats_match_jax_in_f64(f32):
    jm, variables, _ = f32
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3, T, 20, 1)
    y = rs.randint(0, 10, size=4)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        value_and_grad = jax.jit(jax.value_and_grad(functools.partial(_jax_loss, jm),
                                                    has_aux=True))
        (loss, stats), grads = value_and_grad(v64["params"], v64["batch_stats"],
                                              jnp.asarray(x), jnp.asarray(y))
        model = create_stgcn_nucla().double()
        model.load_state_dict(from_flax(v64, model))
        want = from_flax(jax.device_get({"params": grads, "batch_stats": stats}), model)
    model.train()
    got = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-12)
    # biases that feed a train-mode BatchNorm have rounding-size gradients:
    # a floor of 1e-9 x the largest gradient
    floor = 1e-9 * max(float(want[n].abs().max()) for n, _ in model.named_parameters())
    bad = []
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w)
        if (err > 1e-9 * np.abs(w) + 1e-9 * np.abs(w).max() + floor).any():
            bad.append(f"{name}: max err {err.max():.3e}, max|jax| {np.abs(w).max():.3e}")
    assert not bad, bad
    for name, b in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            _close(b.numpy(), want[name].numpy(), 1e-9, name)
    assert all(float(getattr(model, f"edge_importance_{i}").grad.abs().max()) > 0
               for i in range(10))


def test_bf16_logits_within_one_rounding(f32):
    _, variables, _ = f32
    jm = jax_create(dtype=jnp.bfloat16)
    model = create_stgcn_nucla(dtype="bfloat16")
    model.load_state_dict(from_flax(variables, model))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = np.random.RandomState(4).randn(3, 3, T, 20, 1).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    gap = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert gap <= 2.0 ** -8, gap


def test_edge_importance_per_joint_is_the_jax_functions(f32):
    _, variables, model = f32
    masks = [variables["params"][f"edge_importance_{i}"] for i in range(10)]
    want = jax_edge_per_joint(masks)
    np.testing.assert_array_equal(edge_importance_per_joint(masks), want)
    np.testing.assert_array_equal(edge_importance_per_joint(model.edge_importance), want)
    assert want.max() == 1.0


def test_init_follows_pytorch_defaults():
    model = create_stgcn_nucla(generator=torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        if name.endswith("tcn_conv.weight"):
            bound = 1 / math.sqrt(p.shape[1] * 9)
        elif name.endswith(("gcn.conv.weight", "res_conv.weight", "fcn.weight")):
            bound = 1 / math.sqrt(p.shape[1])
        else:
            continue
        m = float(p.detach().abs().max())
        assert 0.9 * bound < m <= bound, name
    assert all(torch.equal(model.edge_importance[i], torch.ones(3, 20, 20)) for i in range(10))
    again = create_stgcn_nucla(generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    assert isinstance(get_model("models.stgcn.Model", graph="ucla"), STGCN)
    assert "A" not in model.state_dict()


def test_what_the_slice_leaves_out_raises():
    # graph_partition="ring" builds, and raises until the model has a ring
    # (parallel/sharded.py:parallelize; the ring's step is held to JAX in
    # tests/test_torch_parallel_train.py)
    ring = create_stgcn_nucla(graph_partition="ring")
    with pytest.raises(ValueError, match="requires a mesh"):
        ring(torch.randn(2, 3, 8, 20, 1))
    # dropout and block_dropout train from the seeded stream (ops/dropout.py)
    x = torch.randn(2, 3, 8, 20, 1)
    for kw, sites in ((dict(dropout=0.5), 1), (dict(block_dropout=0.5), 10)):
        model = create_stgcn_nucla(**kw)
        with torch.no_grad():
            model.eval()(x)  # eval mode runs
            with pytest.raises(RuntimeError, match="seeded stream"):
                model.train()(x)
            with dropout.stream(1, 3) as s:
                assert torch.isfinite(model(x)).all()
            assert s.sites == sites


def _argv(work_dir, *extra):
    return ["recognition", "-c", STGCN_YAML, "--use_gpu", "false", "--feeder",
            "synthetic_gcn", "--train_feeder_args", "num_samples=16",
            "--test_feeder_args", "num_samples=8", "--batch_size", "8",
            "--test_batch_size", "8", "--num_epoch", "2", "--num_worker", "1",
            "--work_dir", str(work_dir), *extra]


def test_stgcn_config_trains_evaluates_and_writes_checkpoints(tmp_path):
    assert main(_argv(tmp_path)) == 0
    for name in ("epoch2.pt", "best.pt"):
        assert os.path.isfile(tmp_path / "checkpoints" / name)
    rows = np.loadtxt(tmp_path / "progress_info.csv", delimiter=",", comments="#", ndmin=2)
    assert rows.shape == (2, 4) and np.isfinite(rows).all()
    with open(tmp_path / "log.txt") as f:
        log = f.read()
    assert "model: stgcn (3.08M params" in log and "Evaluation Acc" in log
    # the test phase on the written weights, with --fast_eval: a warning and
    # the ordinary eval path
    test_dir = tmp_path / "test"
    assert main(_argv(test_dir, "--phase", "test", "--weights",
                      str(tmp_path / "checkpoints" / "best.pt"), "--fast_eval", "true",
                      "--save_result", "true")) == 0
    with open(test_dir / "log.txt") as f:
        log = f.read()
    assert "WARNING: --fast_eval only applies to CTRGCN models" in log
    assert os.path.isfile(test_dir / "test_result.pkl")
