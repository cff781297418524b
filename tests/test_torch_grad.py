"""The port's unit CTR-GC backward against the JAX package's, on the CPU.

The plain versions of K2 (`unit_ctr_gc_dx3_plain`) and K3
(`unit_ctr_gc_param_grads_plain`) give all seven cotangents of the unit op;
they are held against `jax.vjp` of the XLA path `unit_ctr_gc_xla` and against
the Pallas backward `unit_ctr_gc_bwd_pallas` in interpret mode (as
tests/test_pallas.py runs it on the CPU), f32 at rtol/atol 2e-4 (the
tolerance test_pallas.py uses for the unit op's gradients), on inputs made
with numpy from a seed with alpha != 0, b4 != 0 and a random non-symmetric A.
`UnitCtrGc`, the autograd Function around the unit op, passes gradcheck in
f64 and honours `needs_input_grad`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu.ops.aggregation import unit_ctr_gc_xla
from tamgcn_tpu.ops.pallas.ctr_gc import unit_ctr_gc_bwd_pallas
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops.cuda import ctr_gc as port_cuda
from test_torch_ops import SHAPES, _unit_inputs

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("x1s", "x2s", "x3s", "w4s", "b4s", "alpha", "As")


def _cotangent(n, t, v, c, seed=1, **_):
    return np.random.RandomState(seed).randn(n, t, v, c).astype(np.float32)


def _port_grads(args, g):
    """The seven cotangents from the plain versions of K2 and K3, in the
    order of NAMES."""
    x1s, x2s, x3s, w4s, b4s, alpha, As = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(g)
    dx3s = port.unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
    dx1s, dx2s, dw4s, db4s, dalpha, dAs = port.unit_ctr_gc_param_grads_plain(
        x1s, x2s, g, x3s, w4s, b4s, alpha)
    return [d.numpy() for d in (dx1s, dx2s, dx3s, dw4s, db4s, dalpha, dAs)]


def _assert_grads(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_plain_backward_matches_jax_vjp(shape):
    args = _unit_inputs(**shape)
    g = _cotangent(**shape)
    _, vjp = jax.vjp(unit_ctr_gc_xla, *(jnp.asarray(a) for a in args))
    _assert_grads(_port_grads(args, g), vjp(jnp.asarray(g)), "jax.vjp")


@pytest.mark.parametrize(
    "shape",
    [dict(n=2, t=13, v=20, c=128, r=16), dict(n=1, t=13, v=20, c=128, r=16),
     dict(n=2, t=13, v=20, c=64, r=8)],
    ids=["tile", "tile_flat", "bcast"],
)
def test_plain_backward_matches_pallas_interpret(shape):
    """S*C = 384 takes the tile forms (ctr_gc.py:_default_form), and with a
    sample block of one (n=1, _unit_bwd_blocks) the flat parameter
    schedule, the production one; S*C = 192 (C=64) takes the bcast forms."""
    args = _unit_inputs(**shape)
    g = _cotangent(**shape)
    x1s, x2s, x3s, w4s, b4s, alpha, As = (jnp.asarray(a) for a in args)
    dx1s, dx2s, dx3s, dw4s, db4s, dalpha, dAs = unit_ctr_gc_bwd_pallas(
        x1s, x2s, jnp.asarray(g), x3s, w4s, b4s, alpha, As)
    _assert_grads(_port_grads(args, g),
                  (dx1s, dx2s, dx3s, dw4s, db4s, dalpha, dAs), "pallas")


def test_every_cotangent_is_nonzero():
    """alpha = 0 would zero dx1, dx2, dw4 and db4, and the checks above
    would pass for a backward that forgot them: at the test inputs each of
    the seven cotangents is far from zero."""
    shape = dict(n=2, t=9, v=20, c=64, r=8)
    for name, d in zip(NAMES, _port_grads(_unit_inputs(**shape), _cotangent(**shape))):
        assert np.abs(d).max() > 1e-2, name


def test_function_gradcheck_f64():
    rs = np.random.RandomState(4)
    n, t, v, c, r, s = 2, 3, 5, 4, 3, 3
    args = [rs.randn(n, s, v, r), rs.randn(n, s, v, r), rs.randn(n, t, v, s * c),
            rs.randn(s, r, c), rs.randn(s, c), np.array([0.7]), rs.rand(s, v, v)]
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in args]
    assert torch.autograd.gradcheck(port.UnitCtrGc.apply, args)


def test_function_honours_needs_input_grad(monkeypatch):
    """Only x3s requires grad (as when A is a buffer and the rest frozen):
    the backward returns dx3s alone and never runs K3's plain version; the
    incoming gradient may be non-contiguous."""
    args = [torch.from_numpy(a) for a in _unit_inputs(n=1, t=4, v=20, c=16, r=8)]
    args[2].requires_grad_()
    called = []
    monkeypatch.setattr(port, "unit_ctr_gc_param_grads_plain",
                        lambda *a: called.append(1))
    out = port.unit_ctr_gc(*args)
    g = torch.randn(out.shape[::-1]).permute(3, 2, 1, 0)
    assert not g.is_contiguous()
    (dx3s,) = torch.autograd.grad(out, args[2], g)
    assert called == [] and port_cuda.bwd_param_launches == 0
    want = port.unit_ctr_gc_dx3_plain(*args[:2], g.contiguous(), *args[3:])
    torch.testing.assert_close(dx3s, want, rtol=0, atol=0)


def test_autograd_through_dispatcher_matches_plain_versions():
    """unit_ctr_gc's autograd on CPU tensors is the plain backward, exactly."""
    shape = dict(n=2, t=5, v=20, c=24, r=8)
    args = [torch.from_numpy(a).requires_grad_() for a in _unit_inputs(**shape)]
    g = torch.from_numpy(_cotangent(**shape))
    grads = torch.autograd.grad(port.unit_ctr_gc(*args), args, g)
    want = _port_grads([a.detach().numpy() for a in args], g.numpy())
    for name, a, b in zip(NAMES, grads, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert port_cuda.bwd_dx3_launches == port_cuda.bwd_param_launches == 0


def test_second_order_gradient_raises():
    """The backward is once-differentiable on every device: a second-order
    gradient through the unit op raises on the CPU too, rather than being
    silently incomplete on the card, where the kernels' outputs have no graph."""
    args = [torch.from_numpy(a).requires_grad_()
            for a in _unit_inputs(n=1, t=3, v=20, c=8, r=4)]
    (dx3s,) = torch.autograd.grad(port.unit_ctr_gc(*args).square().sum(), args[2],
                                  create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx3s.sum().backward()
