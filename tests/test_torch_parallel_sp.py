"""Sequence parallelism beyond the CTR-GCN, extract_feature of a
time-sharded model and --debug_nans on a grid, on gloo CPU ranks.

  * The SP (1, 2) train step of ST-GCN, the RGB ResNetOnly and the
    cross-modal fusion model in f64 against JAX's `make_train_step` on the
    matching CPU mesh with the JAX trainer's `_sp_put` placement: every 5-D
    skeleton input's frames over the model axis (P('data', None, 'model')),
    every other input over the data axis alone (P('data')); GSPMD then
    computes the single-device step. The port's ranks run
    parallel/drive.py:train_on_grid (launched while the JAX step compiles),
    held as tests/test_torch_parallel_train.py holds the CTR-GCN's: the
    loss within 1e-9 relative, the reduced gradients, the parameters and
    the BatchNorm statistics after the step within rtol 1e-7 and atol 1e-9
    (the fusion's ResNet-50 carries the split layers' other sum order back
    to its first layer, so each of its tensors' atol adds 1e-9 of its max,
    as the tensor-parallel fusion test allows). T = 20 frames split 10 + 10
    (ST-GCN: 5 + 5 after its first stride, 3 + 2 after its second; the
    fusion's CTR-GCN at T = 12: 6 + 6, 3 + 3, 2 + 1). The fusion model
    runs with freeze_gcn_bn=False, so its CTR-GCN's BatchNorms take batch
    statistics over both ranks' frames.
  * extract_feature of a time-sharded CTR-GCN (train mode, f64): the whole
    clip's features on every rank (T = 52 over two ranks: 7 + 6 frames after
    the strides, gathered), and the gradient of a weighted sum of them, the
    input frames' scattered back to each rank and the parameters' summed
    over the ranks, against the dense model within rtol 1e-7 and atol 1e-9.
  * `python -m tamgcn_tpu_torch recognition --debug_nans true` on two ranks
    under --sequence_parallel --model_parallel 2, a NaN planted in the last
    frame of every clip (the second rank's frames alone): both ranks raise
    FloatingPointError naming the same module, inside the launch's timeout.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _weight_forms import to_flax_arrays
from tamgcn_tpu.models import create_stgcn_nucla as jax_stgcn
from tamgcn_tpu.models.resnet_gcn_attention import ResNetGCNAttention as JaxFusion
from tamgcn_tpu.models.resnet_only import ResNetOnly as JaxResNetOnly
from tamgcn_tpu.parallel.mesh import make_mesh as jax_mesh
from tamgcn_tpu.parallel.mesh import replicated
from tamgcn_tpu.parallel.sharded import (DEFAULT_TP_RULES, SharedTrainState,
                                         make_train_step, param_shardings)
from tamgcn_tpu.train import optim as jax_optim
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, create_stgcn_nucla, get_model
from tamgcn_tpu_torch.parallel.launch import run_ranks
from tamgcn_tpu_torch.train.checkpoint import flax_tree
from test_torch_parallel_train import _check, _Inputs, _keeping_gradient

torch.set_num_threads(2)
UCLA = dict(num_class=10, num_point=20, num_person=1, graph="ucla",
            graph_args={"labeling_mode": "spatial"})
BATCH, LR, WD = 4, 0.1, 1e-4
DRIVE = "tamgcn_tpu_torch.parallel.drive:train_on_grid"
WORKER = "tests._torch_dist_worker"
ENV = {"OMP_NUM_THREADS": "1"}
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "nucla", "smoke.yaml")


def _sp_spec(a):
    """The JAX trainer's _sp_put placement of one input."""
    return P("data", None, "model") if a.ndim == 5 else P("data", "model") if a.ndim == 3 \
        else P("data")


def _reference(port, jm, xs, y, mesh):
    """JAX's make_train_step on `mesh` with _sp_put's placement, from the
    port model's f64 weights (x64 on): (loss, {parameter: reduced gradient},
    the state after the step), as port state dicts."""
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       flax_tree(to_flax_arrays(port.state_dict(), port)))
    tx = _keeping_gradient(jax_optim.make_optimizer("SGD", LR, steps_per_epoch=1,
                                                    weight_decay=WD, nesterov=True))
    params = jax.device_put(variables["params"],
                            param_shardings(mesh, variables["params"], DEFAULT_TP_RULES))
    with mesh:
        state = SharedTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=jax.device_put(variables["batch_stats"],
                                                            replicated(mesh)),
                                 opt_state=jax.jit(tx.init)(params))
        state, loss, _ = jax.jit(make_train_step(_Inputs(jm), tx))(
            state, tuple(jax.device_put(jnp.asarray(a), NamedSharding(mesh, _sp_spec(a)))
                         for a in xs),
            jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data"))),
            jax.random.PRNGKey(1))
    grads, after = jax.device_get((state.opt_state[0], {"params": state.params,
                                                        "batch_stats": state.batch_stats}))
    names = {n for n, _ in port.named_parameters()}
    want_grads = {k: v for k, v in from_flax(
        {"params": grads, "batch_stats": after["batch_stats"]}, port).items() if k in names}
    return float(loss), want_grads, from_flax(after, port)


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _grid_spec(name, model_args, port, xs, y):
    """train_on_grid's arguments of the port's SP (1, 2) step in f64; xs
    the tuple of the model's inputs."""
    return dict(model=name, model_args=model_args,
                weights={k: v.double() for k, v in port.state_dict().items()},
                batches=[(xs, y)], model_parallel=2, sequence_parallel=True, lr=LR,
                weight_decay=WD, dtype=torch.float64)


def _sp_step(name, model_args, port, jm, xs, y, **check):
    """The port's SP (1, 2) step on two gloo ranks against JAX's."""
    spec = _grid_spec(name, model_args, port, xs, y)
    mesh = jax_mesh(1, 2, devices=jax.devices()[:2])
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, DRIVE, 2, spec, timeout=240, env=ENV)
        ref = _reference(port.double(), jm, xs, y, mesh)
        _check_sp(ranks.result(), ref, **check)


def _check_sp(results, ref, **check):
    _check(results, *ref, **check)
    # the ranks' copies of every parameter bit for bit alike
    for k, v in results[0]["states"][1].items():
        assert torch.equal(v, results[1]["states"][1][k]), k


@pytest.fixture(scope="module")
def stgcn_sp(x64):
    """(train_on_grid's arguments of ST-GCN's SP (1, 2) step, JAX's step
    on the matching mesh), computed once for the module."""
    port = create_stgcn_nucla(generator=torch.Generator().manual_seed(2))
    rs = np.random.RandomState(3)
    with torch.no_grad():  # edge importance off its init of ones
        for i in range(10):
            getattr(port, f"edge_importance_{i}").mul_(
                torch.from_numpy(1 + 0.2 * rs.randn(3, 20, 20)).float())
    x, y = rs.randn(BATCH, 3, 20, 20, 1), rs.randint(0, 10, BATCH)
    spec = _grid_spec("stgcn", dict(UCLA, in_channels=3), port, (x,), y)
    mesh = jax_mesh(1, 2, devices=jax.devices()[:2])
    return spec, _reference(port.double(), jax_stgcn(), (x,), y, mesh)


def test_stgcn_sequence_parallel_step_matches_jax(stgcn_sp):
    spec, ref = stgcn_sp
    _check_sp(run_ranks(DRIVE, 2, spec, timeout=240, env=ENV), ref)


def _worst_share(result, ref, rtol=1e-7, atol=1e-9) -> float:
    """The largest share of _check's tolerance that a rank's loss, reduced
    gradients or state after the step takes: max |got - want| / (atol +
    rtol |want|) over every tensor's elements (the loss by its 1e-9)."""
    loss, grads, after = ref
    worst = abs(result["losses"][0] - loss) / (1e-9 * abs(loss))
    for got, want in ([(result["grads"][k], v) for k, v in grads.items()]
                      + [(result["states"][1][k], v) for k, v in after.items()]):
        got, want = got.double().numpy(), want.double().numpy()
        worst = max(worst, float((np.abs(got - want) / (atol + rtol * np.abs(want))).max()))
    return worst


@pytest.mark.parametrize("fault", ["halo_zeroed", "shares_averaged"])
def test_stgcn_sequence_parallel_step_with_a_planted_fault_leaves_jax(stgcn_sp, fault):
    """The unfaulted step's agreement with JAX can fail: with each SP fault
    of tests/_torch_dist_worker.py:sp_fault planted in both ranks (the
    halo frames zeroed; the time-sharded gradient shares averaged instead
    of summed), every rank's worst tensor leaves its tolerance by at least
    1e3 times."""
    spec, ref = stgcn_sp
    ranks = run_ranks(f"{WORKER}:faulted_step", 2, dict(fault=fault, spec=spec),
                      timeout=240, env=ENV)
    for r in ranks:
        assert _worst_share(r, ref) >= 1e3, (fault, r["rank"], _worst_share(r, ref))


def test_resnet_only_sequence_parallel_step_matches_jax(x64):
    """No input of the RGB model is time-sharded: every rank of the model
    group computes on the whole batch slice, its BatchNorms over the data
    group and its replicated gradients averaged (summed, the step would
    take twice the gradient)."""
    port = get_model("resnet_only", generator=torch.Generator().manual_seed(1))
    rs = np.random.RandomState(5)
    x, y = rs.randn(BATCH, 3, 32, 32), rs.randint(0, 10, BATCH)
    _sp_step("resnet_only", {}, port, JaxResNetOnly(), (x,), y, share=1e-9)


def test_fusion_sequence_parallel_step_matches_jax(x64):
    kw = dict(UCLA, in_channels_rgb=15, freeze_gcn_bn=False)
    port = get_model("resnet_gcn_attention", generator=torch.Generator().manual_seed(0), **kw)
    rs = np.random.RandomState(1)
    xs = (rs.randn(BATCH, 3, 12, 20, 1), rs.randn(BATCH, 15, 32, 32))
    y = rs.randint(0, 10, BATCH)
    _sp_step("resnet_gcn_attention", kw, port, JaxFusion(use_pallas=False, **kw), xs, y,
             share=1e-9)


def test_extract_feature_of_a_time_sharded_ctrgcn_matches_the_dense_one():
    from _torch_dist_worker import sp_features

    port = create_ctrgcn_nucla(base_channel=8, generator=torch.Generator().manual_seed(4))
    weights = {k: v.double() for k, v in port.state_dict().items()}
    rs = np.random.RandomState(8)
    x = rs.randn(2, 3, 52, 20, 1)
    cot = rs.randn(2, 32, 13, 20, 1)
    args = dict(weights=weights, x=x, cot=cot)
    ranks = run_ranks(f"{WORKER}:sp_features", 2, args, timeout=180, env=ENV)
    feat, dx, grads = sp_features(**args)
    assert feat.shape == (2, 32, 13, 20, 1)
    for r, (f, _, _) in enumerate(ranks):
        np.testing.assert_allclose(f.numpy(), feat.numpy(), rtol=1e-7, atol=1e-9,
                                   err_msg=f"features, rank {r}")
    np.testing.assert_allclose(torch.cat([d for _, d, _ in ranks], dim=2).numpy(),
                               dx.numpy(), rtol=1e-7, atol=1e-9, err_msg="input gradient")
    assert set(grads) == set(ranks[0][2]) and "l1.gcn1.alpha" in grads
    for k, g in grads.items():
        np.testing.assert_allclose((ranks[0][2][k] + ranks[1][2][k]).numpy(), g.numpy(),
                                   rtol=1e-7, atol=1e-9, err_msg=k)


def test_debug_nans_on_two_ranks_raises_on_both_naming_one_module(tmp_path):
    argv = ["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir", str(tmp_path),
            "--model_args", "base_channel=8", "--num_epoch", "1", "--num_worker", "1",
            "--print_log", "false", "--model_parallel", "2", "--sequence_parallel", "true",
            "--debug_nans", "true", "--train_feeder_args", "num_samples=8",
            "--batch_size", "4"]
    messages = run_ranks(f"{WORKER}:debug_nans_cli", 2, {"argv": argv}, timeout=180, env=ENV)
    assert all(m is not None for m in messages), messages
    assert messages[0] == messages[1], messages
    assert "non-finite value in the output of module data_bn, train step 0 (epoch 1)" \
        in messages[0], messages[0]
