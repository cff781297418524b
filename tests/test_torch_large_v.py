"""The port at a graph larger than the skeletons (V=40, the synthetic random
tree of configs/scene256.yaml), against the JAX package, on the CPU.

V=40 is past what the whole-V unit-op kernels (V <= 32) and the whole-block
kernel K5 (V <= 28) take on the card, so there the model runs the joint-tiled
designs of K1 and K2, and the fast eval sends every block to the folded path.
A CTR-GCN at base_channel 8 with alpha and the TAM offset convs perturbed,
gcn1/bn scales O(1) and BatchNorm running stats calibrated on a random batch
(tests/test_torch_model.py:perturbed_variables, at V=40) is built on the JAX
side and loaded into the port with `from_flax`; inputs are made with numpy
from a seed. Tolerances, f32 on both sides: the logits within rtol 1e-4 and
atol 1e-4 * max|JAX| (products of up to 3*C terms summed in another order,
through ten blocks). The per-block fast-eval rule is read from the shapes,
without a build or a launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _numerics import perturb_offset_convs
from tamgcn_tpu.models import get_model as jax_get_model
from tamgcn_tpu.models.ctrgcn_infer import make_fast_eval_fn as jax_fast_eval_fn
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, ctrgcn_infer, get_model
from tamgcn_tpu_torch.ops.gcn_tcn_block import k5_takes

torch.set_num_threads(1)
BC = 8
V = 40
T = 12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _map_leaves(tree, fn, path=()):
    return {k: _map_leaves(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v)) for k, v in tree.items()}


def _model_args():
    return dict(num_class=10, num_point=V, num_person=1, graph="synthetic",
                graph_args={"labeling_mode": "spatial", "num_node": V},
                base_channel=BC)


def _perturbed(jm, variables, seed=0):
    """As tests/test_torch_model.py:perturbed_variables, with a calibration
    batch of V joints."""
    rs = np.random.RandomState(seed)
    params = jax.device_get(perturb_offset_convs(variables["params"], scale=0.3))
    params = _map_leaves(params, lambda p, v: (
        (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
        if p[-3:] == ("gcn1", "bn", "scale") else v))
    zero = _map_leaves(variables["batch_stats"], lambda p, v: np.zeros_like(v))
    x_cal = rs.randn(4, 3, T, V, 1).astype(np.float32)
    _, new = jm.apply({"params": params, "batch_stats": zero}, jnp.asarray(x_cal),
                      train=True, mutable=["batch_stats"])
    stats = _map_leaves(jax.device_get(new["batch_stats"]), lambda p, v: (
        10.0 * v * (1.0 + (0.1 * rs.randn(*v.shape) if p[-1] == "mean"
                           else 0.25 * np.abs(rs.randn(*v.shape))))
    ).astype(np.float32))
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    jm = jax_get_model("ctrgcn", use_pallas=False, **_model_args())
    x = np.random.RandomState(1).randn(2, 3, T, V, 1).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    variables = _perturbed(jm, init)
    model = get_model("ctrgcn", **_model_args())
    model.load_state_dict(from_flax(variables, model))
    return jm, variables, model.eval(), x


def test_logits_at_v40_match_jax(pair):
    jm, variables, model, x = pair
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    _close(got.numpy(), want)


def test_fast_eval_at_v40_matches_jax(pair, monkeypatch):
    jm, variables, model, x = pair
    want = jax_fast_eval_fn(jm, use_pallas=False)(variables, jnp.asarray(x))

    def k5(*args, **kwargs):
        raise AssertionError("a block took K5 at V=40")

    # the default rule sends no block to K5 at V=40: each runs the folded path
    monkeypatch.setattr(ctrgcn_infer, "gcn_tcn_block_fused", k5)
    with torch.no_grad():
        got = ctrgcn_infer.make_fast_eval(model)(torch.from_numpy(x))
    _close(got.numpy(), want)
    _close(got.numpy(), model(torch.from_numpy(x)).detach().numpy())


@pytest.mark.parametrize("num_point, k5", [(20, True), (28, True), (29, False), (40, False)])
def test_fast_eval_rule_per_block(num_point, k5):
    """Which blocks the default fast eval sends to K5, from the rule alone:
    all ten at the NW-UCLA V=20 (and up to V=28), none past it."""
    model = create_ctrgcn_nucla(base_channel=BC, num_point=num_point,
                                graph="synthetic",
                                graph_args={"labeling_mode": "spatial",
                                            "num_node": num_point})
    folded = ctrgcn_infer.fold_model(model.eval())
    assert [ctrgcn_infer.block_takes_k5(fb) for fb in folded["blocks"]] == [k5] * 10


@pytest.mark.parametrize("V, Cin, C, R, takes", [
    (20, 3, 64, 8, True), (20, 256, 256, 32, True), (25, 128, 128, 16, True),
    (28, 256, 256, 32, True), (29, 64, 64, 8, False), (64, 64, 64, 8, False),
    (256, 256, 256, 32, False), (20, 64, 70, 8, False), (20, 64, 64, 40, False),
])
def test_k5_rule(V, Cin, C, R, takes):
    """K5's rule: V <= 28 at the model's widths; C % 4 and R <= 32 as its
    wrapper checks."""
    assert k5_takes(V, Cin, C, R) is takes


def test_fast_eval_forces_k5_where_asked(pair, monkeypatch):
    """use_kernel=True sends every block to gcn_tcn_block_fused whatever the
    rule says (on the card K5 then raises at V=40)."""
    _, _, model, x = pair
    calls = []
    real = ctrgcn_infer.gcn_tcn_block_fused

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(ctrgcn_infer, "gcn_tcn_block_fused", counting)
    with torch.no_grad():
        ctrgcn_infer.make_fast_eval(model, use_kernel=True)(torch.from_numpy(x))
        assert len(calls) == 10
        ctrgcn_infer.make_fast_eval(model, use_kernel=False)(torch.from_numpy(x))
    assert len(calls) == 10
