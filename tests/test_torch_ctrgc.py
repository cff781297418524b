"""The port's standalone CTRGC module and its single-subset op (K4's path)
against the JAX package's, on the CPU.

  * `ctr_gc_fused_plain` and `CtrGcFused` (the plain route, the one a CPU
    tensor takes) against `ctr_gc_fused_xla` and `ctr_gc_fused_pallas` (K4
    in interpret mode, as tests/test_pallas.py runs it), forward at the
    shapes of test_pallas.py and the VJP, with and without b4, at
    test_pallas.py's tolerances (rtol/atol 1e-5 forward, 1e-4 gradients);
  * the port `CTRGC` with weights from `convert.from_flax` against the JAX
    `CTRGC` (use_pallas False and True): the output and the gradients of
    every parameter and of x, A and alpha, with alpha != 0, conv4_bias != 0
    and a non-symmetric A, so that a transposed M fails.
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu.models.ctrgcn import CTRGC as JaxCTRGC
from tamgcn_tpu.ops.aggregation import ctr_gc_fused_xla
from tamgcn_tpu.ops.pallas.ctr_gc import ctr_gc_fused_pallas
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import CTRGC
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops.cuda import ctr_gc as port_cuda

torch.set_num_threads(1)
NAMES = ("x1", "x2", "x3", "w4", "b4", "alpha", "A")


def _inputs(n=2, t=8, v=20, c=64, r=8, seed=0):
    """test_pallas.py:_make_inputs's operands, from numpy: a random A (not
    symmetric) and alpha != 0."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    return [rs.randn(n, v, r).astype(f32), rs.randn(n, v, r).astype(f32),
            rs.randn(n, t, v, c).astype(f32), (rs.randn(r, c) * 0.1).astype(f32),
            (rs.randn(c) * 0.1).astype(f32), np.asarray([0.7], f32),
            rs.rand(v, v).astype(f32)]


def _drop_b4(args, with_b4):
    return args if with_b4 else args[:4] + [None] + args[5:]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad) for a in args]


@pytest.mark.parametrize("shape", [
    dict(n=2, t=52, v=20, c=64, r=8),    # NW-UCLA layer 1
    dict(n=2, t=13, v=20, c=256, r=32),  # NW-UCLA layer 9-10
    dict(n=2, t=16, v=25, c=128, r=16),  # NTU mid layers
    dict(n=1, t=7, v=20, c=96, r=12),    # non-aligned channels
], ids=["l1", "l9", "ntu", "ragged"])
@pytest.mark.parametrize("with_b4", [True, False], ids=["b4", "no_b4"])
def test_forward_matches_xla_and_pallas(shape, with_b4):
    args = _drop_b4(_inputs(**shape), with_b4)
    plain = port.ctr_gc_fused_plain(*_torch(args)).numpy()
    with torch.no_grad():
        fused = port.ctr_gc_fused(*_torch(args)).numpy()
    np.testing.assert_array_equal(fused, port.CtrGcFused.apply(*_torch(args)).detach().numpy())
    want_xla = np.asarray(ctr_gc_fused_xla(*_jax(args)))
    for got in (plain, fused):
        np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    want_pallas = np.asarray(ctr_gc_fused_pallas(*_jax(args)))
    np.testing.assert_allclose(fused, want_pallas, rtol=1e-5, atol=1e-5)
    assert port_cuda.launches == 0


@pytest.mark.parametrize("with_b4", [True, False], ids=["b4", "no_b4"])
def test_vjp_matches_xla_and_pallas(with_b4):
    """test_pallas.py:test_vjp_matches_xla's shape and loss, sum(sin(out)):
    the gradients of the plain forward (autograd) and of CtrGcFused against
    jax.grad through ctr_gc_fused_xla and ctr_gc_fused_pallas."""
    args = _drop_b4(_inputs(n=2, t=8, v=20, c=64, r=8), with_b4)
    idx = [i for i, a in enumerate(args) if a is not None]
    wants = []
    for fn in (ctr_gc_fused_xla, ctr_gc_fused_pallas):
        def loss(*a, fn=fn):
            full = list(_jax(args))
            for i, v in zip(idx, a):
                full[i] = v
            return jnp.sum(jnp.sin(fn(*full)))
        wants.append(jax.grad(loss, argnums=tuple(range(len(idx))))(
            *[jnp.asarray(args[i]) for i in idx]))
    for fn in (port.ctr_gc_fused_plain, port.ctr_gc_fused):
        targs = _torch(args, grad=True)
        got = torch.autograd.grad(torch.sin(fn(*targs)).sum(), [targs[i] for i in idx])
        for want in wants:
            for i, a, b in zip(idx, got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                           err_msg=f"{fn.__name__}: {NAMES[i]}")
    assert port_cuda.launches == port_cuda.bwd_dx3_launches == 0


def test_fused_op_honours_needs_input_grad_and_is_once_differentiable():
    args = _inputs(n=1, t=4, v=20, c=16, r=8)
    targs = _torch(args)
    targs[2].requires_grad_()
    out = port.ctr_gc_fused(*targs)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (dx3,) = torch.autograd.grad(out, targs[2], g)
    m = port.ctr_gc_dynamic_adjacency(targs[0], targs[1], targs[3], targs[4], targs[5], targs[6])
    torch.testing.assert_close(dx3, torch.einsum("nuvc,ntuc->ntvc", m, g), rtol=1e-6, atol=1e-6)
    targs = _torch(args, grad=True)
    (dx3,) = torch.autograd.grad(port.ctr_gc_fused(*targs).square().sum(), targs[2],
                                 create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx3.sum().backward()


def _jax_ctrgc(cin, cout, seed=3):
    """The JAX CTRGC's variables with conv4_bias moved off zero."""
    jm = JaxCTRGC(in_channels=cin, out_channels=cout, use_pallas=False)
    x = jnp.zeros((1, 4, 20, cin), jnp.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed), x, jnp.eye(20), jnp.ones(1)))
    rs = np.random.RandomState(seed)
    params = dict(variables["params"])
    params["conv4_bias"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return {"params": params}


def test_from_flax_fills_a_port_ctrgc():
    variables = _jax_ctrgc(16, 24)
    model = CTRGC(16, 24)
    state = from_flax(variables, model)
    assert set(state) == set(model.state_dict())
    p = variables["params"]
    np.testing.assert_array_equal(state["conv1.weight"].numpy(), p["conv1"]["kernel"][0, 0].T)
    np.testing.assert_array_equal(state["conv4_kernel"].numpy(), p["conv4_kernel"])
    assert state["conv4_kernel"].shape == (1, 1, 2, 24)  # R = 16 // 8


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_ctrgc_module_matches_jax(use_pallas):
    """Output and every gradient (parameters, x, A, alpha) of the port CTRGC
    against the JAX CTRGC, f32 at rtol/atol 1e-4 x max|jax| (the gradients of
    the 1x1 convs sum over N*T*V)."""
    cin, cout, n, t, v = 16, 24, 2, 8, 20
    variables = _jax_ctrgc(cin, cout)
    rs = np.random.RandomState(5)
    x = rs.randn(n, t, v, cin).astype(np.float32)
    A = rs.rand(v, v).astype(np.float32)
    alpha = np.asarray([0.6], np.float32)
    g = rs.randn(n, t, v, cout).astype(np.float32)
    jm = JaxCTRGC(in_channels=cin, out_channels=cout, use_pallas=use_pallas)
    out, vjp = jax.vjp(lambda p, x, A, alpha: jm.apply({"params": p}, x, A, alpha),
                       variables["params"], jnp.asarray(x), jnp.asarray(A), jnp.asarray(alpha))
    dparams, dx, dA, dalpha = vjp(jnp.asarray(g))

    model = CTRGC(cin, cout)
    model.load_state_dict(from_flax(variables, model))
    tx, tA, talpha = (torch.from_numpy(a).requires_grad_() for a in (x, A, alpha))
    got = model(tx, tA, talpha)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(out)).max())
    got.backward(torch.from_numpy(g))
    want = from_flax(jax.device_get({"params": dparams}), model)
    checks = [(k, p.grad, want[k]) for k, p in model.named_parameters()]
    checks += [("x", tx.grad, dx), ("A", tA.grad, dA), ("alpha", talpha.grad, dalpha)]
    for name, a, b in checks:
        b = np.asarray(b)
        assert np.abs(b).max() > 1e-3, f"{name}: a zero gradient hides the check"
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)
    # alpha and the transposed orientation of M matter at these inputs
    with torch.no_grad():
        assert (model(tx, tA, talpha * 0) - got).abs().max() > 1e-2
        assert (model(tx, tA.t(), talpha) - got).abs().max() > 1e-2
