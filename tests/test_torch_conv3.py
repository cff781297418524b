"""The port's conv3-fused unit op (K6's path) against the JAX package's, on
the CPU.

With the JAX package's switch TAMGCN_FUSE_CONV3=1 (set per test, as
tests/test_pallas.py does) `unit_ctr_gc_conv3` takes the op whose backward is
K6 on the card; on the CPU it runs K6's plain version:
  * `unit_ctr_gc_bwd_conv3_plain` against `jax.vjp` of conv3_matmul +
    unit_ctr_gc_xla, f32 at rtol 1e-5 and atol 1e-5 * max|ref|;
  * the port's fused op, forward and all nine gradients, against the JAX
    `unit_ctr_gc_conv3(..., use_pallas=True)`, which runs the Pallas K6 in
    interpret mode, at test_pallas.py's tolerances (rtol/atol 2e-5 for the
    output, 5e-4 for the gradients);
  * the dispatcher takes the fused op only where the JAX package does;
  * `UnitCtrGcConv3` honours `needs_input_grad` and is once differentiable;
  * a full-width CTR-GCN (base_channel 64) in f64 takes the same train step
    with the switch on as off (the unfused path is held against JAX in
    test_torch_train.py).
Inputs are made with numpy from a seed, with alpha != 0, b4 != 0 and a
random non-symmetric A.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.ops.aggregation import conv3_matmul as jax_conv3_matmul
from tamgcn_tpu.ops.aggregation import unit_ctr_gc_conv3 as jax_unit_ctr_gc_conv3
from tamgcn_tpu.ops.aggregation import unit_ctr_gc_xla
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops.cuda import ctr_gc as port_cuda

torch.set_num_threads(1)
NAMES = ("x", "w3", "b3", "x1s", "x2s", "w4s", "b4s", "alpha", "As")


def _inputs(n, t, v, c, r, cin, s=3, seed=0):
    """(x, w3, b3, x1s, x2s, w4s, b4s, alpha, As) and a cotangent g."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    args = (
        (rs.randn(n, t, v, cin) * 0.3).astype(f32),
        (rs.randn(cin, s * c) * 0.1).astype(f32),
        (rs.randn(s * c) * 0.1).astype(f32),
        (rs.randn(n, s, v, r) * 0.3).astype(f32),
        (rs.randn(n, s, v, r) * 0.3).astype(f32),
        (rs.randn(s, r, c) * 0.1).astype(f32),
        (rs.randn(s, c) * 0.1).astype(f32),
        np.asarray([0.7], f32),
        rs.rand(s, v, v).astype(f32),
    )
    return args, rs.randn(n, t, v, c).astype(f32)


@pytest.mark.parametrize("shape", [
    dict(n=2, t=8, v=20, c=128, r=16, cin=64),
    dict(n=1, t=7, v=25, c=40, r=10, cin=27),  # NTU joints, odd T and Cin
], ids=["v20", "v25-ragged"])
def test_plain_k6_matches_jax_vjp(shape):
    (x, w3, b3, x1s, x2s, w4s, b4s, alpha, As), g = _inputs(**shape)

    def f(x, w3, b3):
        return unit_ctr_gc_xla(jnp.asarray(x1s), jnp.asarray(x2s),
                               jax_conv3_matmul(x, w3, b3), *map(jnp.asarray, (w4s, b4s, alpha, As)))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, w3, b3)))
    want = vjp(jnp.asarray(g))
    got = port.unit_ctr_gc_bwd_conv3_plain(*map(torch.from_numpy, (
        x1s, x2s, g, x, w3, w4s, b4s, alpha, As)))
    for name, a, b in zip(("dx", "dw3", "db3"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_fused_op_matches_jax_pallas_interpret(monkeypatch):
    """test_pallas.py:test_unit_ctr_gc_conv3_fused_matches_xla's shape, which
    takes the tile form: the Pallas K6 (interpret mode) in the JAX backward."""
    monkeypatch.setenv("TAMGCN_FUSE_CONV3", "1")
    args, g = _inputs(n=2, t=8, v=20, c=128, r=16, cin=64)
    out, vjp = jax.vjp(lambda *a: jax_unit_ctr_gc_conv3(*a, use_pallas=True),
                       *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got_out = port.UnitCtrGcConv3.apply(*targs)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(got_out, targs, torch.from_numpy(g))
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(b).max() > 1e-3, f"{name}: a zero gradient hides the check"
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("switch,c,s,v,fused", [
    ("1", 128, 3, 20, True),   # l5-l10 of NW-UCLA
    ("1", 128, 3, 25, True),   # NTU joints
    ("1", 64, 3, 20, False),   # C < 128 (l1-l4)
    ("1", 128, 2, 20, False),  # S*C < 384
    ("1", 128, 3, 33, False),  # V > 32
    ("0", 128, 3, 20, False),
    (None, 128, 3, 20, False),
], ids=["on", "on-v25", "on-c64", "on-sc256", "on-v33", "off", "unset"])
def test_dispatcher_takes_the_fused_op_inside_the_jax_gate(monkeypatch, switch, c, s, v, fused):
    if switch is None:
        monkeypatch.delenv("TAMGCN_FUSE_CONV3", raising=False)
    else:
        monkeypatch.setenv("TAMGCN_FUSE_CONV3", switch)
    calls = {"fused": 0, "unit": 0, "k6": 0, "k2": 0}
    fused_apply, unit_apply = port.UnitCtrGcConv3.apply, port.UnitCtrGc.apply
    k6, k2 = port.unit_ctr_gc_bwd_conv3_plain, port.unit_ctr_gc_dx3_plain

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(port.UnitCtrGcConv3, "apply", count("fused", fused_apply))
    monkeypatch.setattr(port.UnitCtrGc, "apply", count("unit", unit_apply))
    monkeypatch.setattr(port, "unit_ctr_gc_bwd_conv3_plain", count("k6", k6))
    monkeypatch.setattr(port, "unit_ctr_gc_dx3_plain", count("k2", k2))
    args, _ = _inputs(n=1, t=3, v=v, c=c, r=4, cin=8, s=s)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    port.unit_ctr_gc_conv3(*targs).sum().backward()
    want = ({"fused": 1, "unit": 0, "k6": 1, "k2": 1} if fused
            else {"fused": 0, "unit": 1, "k6": 0, "k2": 1})
    assert calls == want
    assert port_cuda.bwd_conv3_launches == 0


def test_fused_op_honours_needs_input_grad(monkeypatch):
    """Only x requires grad: K6's plain version runs and K3's never; only w4s:
    K3's and never K6's. The incoming gradient may be non-contiguous."""
    calls = []
    k6, k3 = port.unit_ctr_gc_bwd_conv3_plain, port.unit_ctr_gc_param_grads_plain
    monkeypatch.setattr(port, "unit_ctr_gc_bwd_conv3_plain",
                        lambda *a: calls.append("K6") or k6(*a))
    monkeypatch.setattr(port, "unit_ctr_gc_param_grads_plain",
                        lambda *a: calls.append("K3") or k3(*a))
    args, g = _inputs(n=1, t=4, v=20, c=16, r=8, cin=12)
    g = torch.from_numpy(np.ascontiguousarray(g.transpose(3, 2, 1, 0))).permute(3, 2, 1, 0)
    assert not g.is_contiguous()
    for i, want_calls in ((0, ["K6"]), (5, ["K3"])):
        targs = [torch.from_numpy(a) for a in args]
        targs[i].requires_grad_()
        calls.clear()
        (grad,) = torch.autograd.grad(port.UnitCtrGcConv3.apply(*targs), targs[i], g)
        assert calls == want_calls
        plain = (k6(*targs[3:5], g.contiguous(), targs[0], targs[1], *targs[5:])[0] if i == 0
                 else k3(*targs[3:5], g.contiguous(), port.conv3_matmul(*targs[:3]),
                         *targs[5:8])[2])
        torch.testing.assert_close(grad, plain, rtol=0, atol=0)


def test_fused_op_second_order_gradient_raises():
    args, _ = _inputs(n=1, t=3, v=20, c=8, r=4, cin=6)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (dx,) = torch.autograd.grad(port.UnitCtrGcConv3.apply(*targs).square().sum(),
                                targs[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


def _full_width_model():
    model = create_ctrgcn_nucla(base_channel=64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # what hides the aggregation at init
        g = torch.Generator().manual_seed(4)
        for blk in model.blocks:
            blk.gcn1.alpha.fill_(0.5)
            blk.gcn1.bn.weight.fill_(1.0)
            blk.gcn1.offset_conv.weight.normal_(0.0, 0.02, generator=g)
    return model.double().train()


def test_full_width_train_step_is_the_same_with_the_switch_on(monkeypatch):
    """One train-mode forward and backward of CTR-GCN at full NW-UCLA width
    (base_channel 64, ten blocks), f64, batch 2, T=16: with
    TAMGCN_FUSE_CONV3=1 (K6's plain version at l5-l10) the loss, every
    parameter gradient and every BatchNorm running stat equal those with the
    switch off within 1e-10 relative (atol 1e-10 x the tensor's max)."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 16, 20, 1))
    y = torch.tensor([1, 7])
    k6 = port.unit_ctr_gc_bwd_conv3_plain
    k6_calls = []
    monkeypatch.setattr(port, "unit_ctr_gc_bwd_conv3_plain",
                        lambda *a: k6_calls.append(1) or k6(*a))
    base = _full_width_model()
    runs = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("TAMGCN_FUSE_CONV3", switch)
        model = copy.deepcopy(base)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        runs[switch] = (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                        dict(model.named_buffers()))
    assert len(k6_calls) == 6  # l5-l10
    (loss_off, grads_off, bufs_off), (loss_on, grads_on, bufs_on) = runs["0"], runs["1"]
    np.testing.assert_allclose(loss_on, loss_off, rtol=1e-10)
    for what, on, off in (("grad", grads_on, grads_off), ("buffer", bufs_on, bufs_off)):
        for k, want in off.items():
            if not want.is_floating_point():
                assert torch.equal(on[k], want), k
                continue
            torch.testing.assert_close(on[k], want, rtol=1e-10,
                                       atol=1e-10 * want.abs().max().item(),
                                       msg=f"{what} {k}")
    for blk in list(base.blocks)[4:]:  # the fused blocks' gradients are real
        name = [k for k, p in base.named_parameters() if p is blk.gcn1.conv3.weight][0]
        assert grads_on[name].abs().max() > 1e-6, name
