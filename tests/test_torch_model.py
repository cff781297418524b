"""The port's CTR-GCN against the JAX CTR-GCN on converted weights (CPU).

A `create_ctrgcn_nucla(use_pallas=False, base_channel=8)` init of the JAX
package is converted with `tamgcn_tpu_torch.convert.from_flax`. Before the
comparison, what hides the aggregation kernel is moved off its init values:
alpha=0 makes the refined adjacency M = A, and the 1e-6 `gcn1/bn` scale
multiplies the aggregation's output by 1e-6 in eval mode; so alpha and the
TAM offset convs are perturbed (tests/_numerics.py), every `gcn1/bn/scale`
is set to O(1) and the running stats are randomized around those of a
calibration batch. Inputs are made with
numpy from a seed. f32 on both sides: the logits, every block's output and
`extract_feature` agree within rtol 1e-4 and atol 1e-4 * max|JAX| (the sum
order differs, through 10 blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _numerics import perturb_offset_convs
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.models.ctrgcn import TCNGCNUnit
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, get_model
from tamgcn_tpu_torch.ops import dropout
from tamgcn_tpu_torch.ops.cuda import ctr_gc

torch.set_num_threads(1)
BC = 8


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4,
        atol=1e-4 * float(np.abs(want).max()), err_msg=err_msg,
    )


def _map_leaves(tree, fn, path=()):
    return {k: _map_leaves(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v)) for k, v in tree.items()}


def perturbed_variables(jm, variables, seed=0):
    """alpha and the offset convs perturbed, gcn1/bn/scale O(1), and random
    running stats near those of a calibration batch: with the init's stats
    (mean 0, var 1) the eval activations grow by orders of magnitude through
    the ten blocks, and the comparison would test conditioning."""
    rs = np.random.RandomState(seed)
    params = jax.device_get(perturb_offset_convs(variables["params"], scale=0.3))
    params = _map_leaves(params, lambda p, v: (
        (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
        if p[-3:] == ("gcn1", "bn", "scale") else v))
    # a train-mode pass from zeroed stats leaves 0.1 x the batch stats
    zero = _map_leaves(variables["batch_stats"], lambda p, v: np.zeros_like(v))
    x_cal = rs.randn(4, 3, 16, 20, 1).astype(np.float32)
    _, new = jm.apply({"params": params, "batch_stats": zero}, jnp.asarray(x_cal),
                      train=True, mutable=["batch_stats"])
    stats = _map_leaves(jax.device_get(new["batch_stats"]), lambda p, v: (
        10.0 * v * (1.0 + (0.1 * rs.randn(*v.shape) if p[-1] == "mean"
                           else 0.25 * np.abs(rs.randn(*v.shape))))
    ).astype(np.float32))
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    jm = jax_create(use_pallas=False, base_channel=BC)
    x = np.random.RandomState(0).randn(2, 3, 16, 20, 1).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    variables = perturbed_variables(jm, init)
    model = create_ctrgcn_nucla(base_channel=BC)
    model.load_state_dict(from_flax(variables, model))
    return jm, init, variables, model.eval(), x


def test_from_flax_consumes_every_leaf_of_an_init(pair):
    _, init, _, _, _ = pair
    own = create_ctrgcn_nucla(base_channel=BC)
    state = from_flax(init, own)  # raises on any unconsumed leaf / unset tensor
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in own.state_dict().items()
    }
    n_leaves = len(jax.tree_util.tree_leaves(init))
    assert n_leaves == len(state)


def test_from_flax_rejects_extra_and_missing_leaves(pair):
    _, init, _, _, _ = pair
    model = create_ctrgcn_nucla(base_channel=BC)
    extra = {"params": dict(init["params"], bogus={"kernel": np.zeros((1, 1, 2, 2))}),
             "batch_stats": init["batch_stats"]}
    with pytest.raises(KeyError, match="bogus"):
        from_flax(extra, model)
    params = dict(init["params"])
    del params["fc"]
    with pytest.raises(KeyError, match="fc"):
        from_flax({"params": params, "batch_stats": init["batch_stats"]}, model)


def test_logits_match_jax(pair):
    jm, _, variables, model, x = pair
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    _close(got.numpy(), want)
    assert ctr_gc.launches == 0  # the CPU path never launches the kernel


def test_every_block_matches_jax(pair):
    jm, _, variables, model, x = pair
    _, state = jm.apply(
        variables, jnp.asarray(x), train=False,
        capture_intermediates=lambda mdl, name: isinstance(mdl, TCNGCNUnit),
        mutable=["intermediates"],
    )
    inter = state["intermediates"]
    outs = {}
    hooks = [
        blk.register_forward_hook(
            lambda m, i, o, name=f"l{k}": outs.__setitem__(name, o.numpy())
        )
        for k, blk in enumerate(model.blocks, start=1)
    ]
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    for k in range(1, 11):
        name = f"l{k}"
        _close(outs[name], inter[name]["__call__"][0], err_msg=name)


def test_extract_feature_matches_jax(pair):
    jm, _, variables, model, x = pair
    want, _ = jm.apply(variables, jnp.asarray(x), train=False, method="extract_feature")
    with torch.no_grad():
        got, got2 = model.extract_feature(torch.from_numpy(x))
    assert got.shape == (2, 4 * BC, 4, 20, 1)
    assert got2 is got
    _close(got.numpy(), want)


def test_flat_input_layout_matches_5d(pair):
    _, _, _, model, x = pair
    flat = np.transpose(x[..., 0], (0, 2, 3, 1)).reshape(2, 16, 20 * 3)
    with torch.no_grad():
        a = model(torch.from_numpy(x))
        b = model(torch.from_numpy(flat))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_init_schemes_at_full_width():
    """The port builds a model with no JAX: seeded, and with the JAX
    package's init distributions (ops/inits.py)."""
    a = create_ctrgcn_nucla(generator=torch.Generator().manual_seed(3))
    b = create_ctrgcn_nucla(generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    g = a.l9.gcn1
    assert torch.all(g.alpha == 0) and torch.all(g.offset_conv.weight == 0)
    assert torch.all(g.bn.weight == 1e-6)
    C, R = 256, 32
    # packed conv3: per-subset fan-out C; conv4 (S,R,C): fan-out C
    assert abs(g.conv3.weight.std().item() - np.sqrt(2 / C)) < 0.1 * np.sqrt(2 / C)
    assert abs(g.conv12.weight.std().item() - np.sqrt(2 / R)) < 0.1 * np.sqrt(2 / R)
    assert abs(g.conv4_kernel.std().item() - np.sqrt(2 / C)) < 0.1 * np.sqrt(2 / C)
    assert abs(a.fc.weight.std().item() - np.sqrt(2 / 10)) < 0.15 * np.sqrt(2 / 10)
    assert a.fc.bias.abs().max().item() <= 1 / np.sqrt(256)
    assert abs(a.l9.tcn1.prefix_bn.weight.mean().item() - 1.0) < 0.01
    assert 0.01 < a.l9.tcn1.prefix_bn.weight.std().item() < 0.03


def test_get_model_rejects_what_the_slice_lacks():
    # dropout in training draws from the seeded stream (ops/dropout.py): a
    # training forward outside one raises, inside one it drops
    model = get_model("ctrgcn", drop_out=0.5, graph="ucla", num_point=20, num_person=1,
                      base_channel=8)
    x = torch.randn(2, 3, 8, 20, 1)
    with pytest.raises(RuntimeError, match="seeded stream"):
        model.train()(x)
    pooled = []
    model.dropout.register_forward_hook(lambda m, a, out: pooled.append((a[0], out)))
    with torch.no_grad(), dropout.stream(0, 0):
        model(x)
    h, out = pooled[0]
    keep = dropout.keep_mask(h.shape, 0.5, 0, 0, 0)
    assert torch.equal(out, torch.where(keep, h / 0.5, 0.0)) and not keep.all()
    with pytest.raises(NotImplementedError, match="float16"):
        get_model("ctrgcn", dtype="float16", graph="ucla")
    with pytest.raises(KeyError):
        get_model("nope")
