"""The port's distributed train step against the JAX package's sharded
train step, in f64.

The JAX reference is `parallel/sharded.py:make_train_step` jitted on the
matching (data, model) CPU mesh, as the JAX trainer runs a grid with a
model axis: the model built for the mesh (its joint ring over the model
axis), DEFAULT_TP_RULES on its parameters where the model axis is larger
than 1 (the trainer applies them in every mode), the batch over the data
axis and, under SP, the frames over the model axis; GSPMD inserts the
collectives. Its optimiser is make_optimizer's SGD with a first transform
that keeps the gradient it is handed, so the reduced gradient before the
optimiser is compared too. The port's step runs in k gloo CPU processes
(parallel/drive.py:train_on_grid through parallel/launch.py:run_ranks,
while the JAX step compiles): the packed step with the flat gradient
summed over the grid. On every rank the loss is held within 1e-9
relative, and the reduced gradient, the updated parameters and the
BatchNorm running stats within rtol 1e-7, atol 1e-9 (the tolerances of
tests/test_sharding.py:372-382), for

  * CTR-GCN (base_channel 8, T = 20, V = 20, batch 4) under DP (2, 1), the
    joint ring (1, 2) and (2, 2), TP (1, 2) (the head split) and SP (1, 2)
    and (2, 2) (T = 20 as 10 + 10 frames, 5 + 5 after l5, 3 + 2 after l8);
  * ST-GCN with the joint ring (1, 2);
  * the cross-modal fusion model under TP (1, 2) (its head and attention MLP
    split; 32 x 32 images, T = 8, batch 4);
  * a model with dropout under DP (2, 1): the ranks draw the single-process
    masks.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _weight_forms import to_flax_arrays
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_ctrgcn
from tamgcn_tpu.models import create_stgcn_nucla as jax_stgcn
from tamgcn_tpu.models.resnet_gcn_attention import ResNetGCNAttention as JaxFusion
from tamgcn_tpu.parallel.mesh import make_mesh as jax_mesh
from tamgcn_tpu.parallel.mesh import replicated
from tamgcn_tpu.parallel.sharded import (DEFAULT_TP_RULES, SharedTrainState,
                                         make_train_step, param_shardings)
from tamgcn_tpu.train import optim as jax_optim
from tamgcn_tpu_torch import serving
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, create_stgcn_nucla, get_model
from tamgcn_tpu_torch.parallel.drive import train_on_grid
from tamgcn_tpu_torch.parallel.launch import run_ranks
from tamgcn_tpu_torch.train.checkpoint import flax_tree

torch.set_num_threads(2)
UCLA = dict(num_class=10, num_point=20, num_person=1, graph="ucla",
            graph_args={"labeling_mode": "spatial"})
BC, T, BATCH, LR, WD = 8, 20, 4, 0.1, 1e-4
DRIVE = "tamgcn_tpu_torch.parallel.drive:train_on_grid"
ENV = {"OMP_NUM_THREADS": "1"}


def _perturbed(model, seed):
    """serving.py's perturbation (alpha, the TAM offset convs and gcn1/bn
    off their init, so the gradients are not degenerate), in f64."""
    return {k: v.double() for k, v in serving._perturbed(model, seed).items()}


def _keeping_gradient(tx):
    """`tx` after a transform whose state keeps the gradient it was last
    handed: the reduced gradient make_train_step gives the optimiser."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


class _Inputs:
    """A model as make_train_step calls it, `data` the tuple of its inputs."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, data, **kwargs):
        return self.model.apply(variables, *data, **kwargs)


def _reference(port, jm, xs, y, mesh, sp=False):
    """JAX's make_train_step on `mesh` (module docstring) from the port
    model's f64 weights (x64 on), as port state dicts: (loss, {parameter:
    gradient}, the state after the step)."""
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       flax_tree(to_flax_arrays(port.state_dict(), port)))
    tx = _keeping_gradient(jax_optim.make_optimizer("SGD", LR, steps_per_epoch=1,
                                                    weight_decay=WD, nesterov=True))
    rules = DEFAULT_TP_RULES if mesh.shape["model"] > 1 else ()
    params = jax.device_put(variables["params"],
                            param_shardings(mesh, variables["params"], rules))
    frames = NamedSharding(mesh, P("data", None, "model") if sp else P("data"))
    with mesh:
        state = SharedTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=jax.device_put(variables["batch_stats"],
                                                            replicated(mesh)),
                                 opt_state=jax.jit(tx.init)(params))
        state, loss, _ = jax.jit(make_train_step(_Inputs(jm), tx))(
            state, tuple(jax.device_put(jnp.asarray(a), frames) for a in xs),
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


def _grid(dp, mp):
    return jax_mesh(dp, mp, devices=jax.devices()[:dp * mp])


def _port_and_reference(spec, n, port, jm, xs, y, mesh, sp=False):
    """The port's ranks (run while the JAX step compiles) and the reference."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, DRIVE, n, spec, timeout=240, env=ENV)
        ref = _reference(port, jm, xs, y, mesh, sp)
        return (ranks.result(), *ref)


def _check(results, loss, grads, after, rel=1e-9, rtol=1e-7, share=0.0):
    """Every rank's loss within `rel`, its gradients and its state after the
    step within `rtol` and an atol of 1e-9 + `share` x max |want| of the
    tensor."""
    for r in results:
        rank = r["rank"]
        assert r["losses"][0] == pytest.approx(loss, rel=rel), rank
        for what, got, want in ([(f"grad {k}", r["grads"][k], v) for k, v in grads.items()]
                                + [(f"{k} after the step", r["states"][1][k], v)
                                   for k, v in after.items()]):
            want = want.double().numpy()
            np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                                       atol=1e-9 + share * float(np.abs(want).max()),
                                       err_msg=f"{what}, rank {rank}")


@pytest.fixture(scope="module")
def ctrgcn(x64):
    """(f64 port model, its weights, a batch)."""
    port = create_ctrgcn_nucla(base_channel=BC, generator=torch.Generator().manual_seed(4))
    weights = _perturbed(port, 5)
    port = port.double()
    port.load_state_dict(weights)
    rs = np.random.RandomState(7)
    return port, weights, (rs.randn(BATCH, 3, T, 20, 1), rs.randint(0, 10, BATCH))


@pytest.mark.parametrize("grid", [
    (2, 1, "none", False), (1, 2, "ring", False), (2, 2, "ring", False),
    (1, 2, "none", False), (1, 2, "none", True), (2, 2, "none", True),
], ids=["dp_2x1", "ring_1x2", "ring_2x2", "tp_1x2", "sp_1x2", "sp_2x2"])
def test_ctrgcn_step_matches_jax(ctrgcn, grid):
    port, weights, (x, y) = ctrgcn
    dp, mp, partition, sp = grid
    mesh = _grid(dp, mp)
    jm = jax_ctrgcn(use_pallas=False, base_channel=BC,
                    **(dict(graph_partition="ring", mesh=mesh) if partition == "ring" else {}))
    spec = dict(model="ctrgcn", model_args=dict(UCLA, base_channel=BC), weights=weights,
                batches=[(x, y)], data_parallel=dp, model_parallel=mp,
                graph_partition=partition, sequence_parallel=sp, lr=LR, weight_decay=WD,
                dtype=torch.float64)
    _check(*_port_and_reference(spec, dp * mp, port, jm, (x,), y, mesh, sp))


def test_stgcn_ring_step_matches_jax(x64):
    """JAX's ST-GCN ring accumulates each step in float32 whatever the
    dtype (tamgcn_tpu/parallel/graph_parallel.py:112-115, :168-171), the
    port's in the wider of the input's and float32; so the port is held to
    JAX's dense f64 step (the math every sharded step computes) at the f64
    tolerances, and to JAX's ring on the (1, 2) mesh within float32
    rounding: 2^-20 relative, 2^-20 of each tensor's max."""
    port = create_stgcn_nucla(generator=torch.Generator().manual_seed(2))
    rs = np.random.RandomState(3)
    with torch.no_grad():  # edge importance off its init of ones
        for i in range(10):
            getattr(port, f"edge_importance_{i}").mul_(
                torch.from_numpy(1 + 0.2 * rs.randn(3, 20, 20)).float())
    weights = {k: v.double() for k, v in port.state_dict().items()}
    port = port.double()
    x, y = rs.randn(BATCH, 3, 16, 20, 1), rs.randint(0, 10, BATCH)
    mesh = _grid(1, 2)
    spec = dict(model="stgcn", model_args=dict(UCLA, in_channels=3), weights=weights,
                batches=[(x, y)], model_parallel=2, graph_partition="ring", lr=LR,
                weight_decay=WD, dtype=torch.float64)
    results, *ring = _port_and_reference(spec, 2, port, jax_stgcn(graph_partition="ring",
                                                                  mesh=mesh), (x,), y, mesh)
    _check(results, *_reference(port, jax_stgcn(), (x,), y, _grid(1, 1)))
    _check(results, *ring, rel=2.0 ** -20, rtol=2.0 ** -20, share=2.0 ** -20)


def test_fusion_tensor_parallel_step_matches_jax(x64):
    """The split head and attention MLP sum their products in another order
    than JAX's GSPMD partition does; train-mode ResNet-50 carries that
    rounding back to its first layer (7.6e-9 on a gradient of max ~3e2), so
    each tensor's atol adds 1e-9 of its max."""
    kw = dict(UCLA, in_channels_rgb=15, freeze_gcn_bn=False)
    port = get_model("resnet_gcn_attention", generator=torch.Generator().manual_seed(0), **kw)
    weights = {k: v.double() for k, v in port.state_dict().items()}
    port = port.double()
    rs = np.random.RandomState(1)
    xs, y = (rs.randn(BATCH, 3, 8, 20, 1), rs.randn(BATCH, 15, 32, 32)), rs.randint(0, 10, BATCH)
    spec = dict(model="resnet_gcn_attention", model_args=kw, weights=weights,
                batches=[(xs, y)], model_parallel=2, lr=LR, weight_decay=WD,
                dtype=torch.float64)
    _check(*_port_and_reference(spec, 2, port, JaxFusion(use_pallas=False, **kw), xs, y,
                                _grid(1, 2)), share=1e-9)


def test_dropout_under_data_parallel_draws_the_single_process_masks():
    kw = dict(UCLA, base_channel=BC, drop_out=0.5)
    port = create_ctrgcn_nucla(generator=torch.Generator().manual_seed(4), **kw)
    weights = _perturbed(port, 5)
    rs = np.random.RandomState(9)
    batches = [(rs.randn(BATCH, 3, 12, 20, 1), rs.randint(0, 10, BATCH)) for _ in range(2)]
    args = dict(model="ctrgcn", model_args=kw, weights=weights, batches=batches, lr=LR,
                dtype=torch.float64, seed=3)
    want = train_on_grid(**args)
    results = run_ranks(DRIVE, 2, dict(args, data_parallel=2), timeout=240, env=ENV)
    for r in results:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-12)
        np.testing.assert_allclose(r["states"][-1]["fc.weight"].numpy(),
                                   want["states"][-1]["fc.weight"].numpy(), rtol=1e-9,
                                   atol=1e-12)
    # another seed draws other masks: the masks reach the loss
    fresh = train_on_grid(**dict(args, seed=4))
    assert fresh["losses"][0] != want["losses"][0]
