"""The bf16 forms of K6 and K4 against the JAX package's, on the CPU.

K6-bf16 runs where a bf16 model (`--model_args dtype=bfloat16`) trains with
the JAX package's switch TAMGCN_FUSE_CONV3=1 (set per test by monkeypatch,
as tests/test_pallas.py does); K4-bf16 in the standalone `CTRGC(dtype=
"bfloat16")`. On the CPU the port runs their plain versions. Inputs come
from numpy seeds (bf16-valued activations, f32 parameters, alpha != 0,
b4 != 0, a random non-symmetric A). Tolerances:
  * K6-bf16 (UnitCtrGcConv3's backward: K6 and K3 plain) against the JAX
    Pallas body in interpret mode (`unit_ctr_gc_conv3(use_pallas=True)`,
    the tile form at C = 128, S = 3): the output and dx, dw3, db3, dx1s,
    dx2s in bf16 within 2^-7 of their max |value| and equal to JAX's in all
    but 1% of their elements (f32 sums taken in another order flip a
    rounding only at a near-tie); dw4s, db4s and dAs in f32 within rtol
    1e-4 and atol 1e-4 * max, dalpha (one sum of every term) within rtol
    1e-3, as tests/test_torch_bf16.py holds K3-bf16;
  * K4-bf16's forward against `ctr_gc_fused_pallas` in interpret mode: f32
    within 1e-4 * max |ref| (measured 1.9e-7; a bf16 tie flip in D would
    move one term by up to 2^-8 |w4| alpha |x3|); its x3 gradient (bf16)
    against the JAX VJP's f32 dx3 rounded to bf16, as the bf16 outputs
    above;
  * the port `CTRGC(dtype="bfloat16")` against the JAX `CTRGC(dtype=
    bfloat16, use_pallas=False)` through `convert.from_flax`: the f32
    output within 1e-4 * max and, to show that the port rounds where JAX
    rounds, within half the distance of the JAX f32 module from JAX bf16
    (measured: equal); the gradients of the op's f32 parameters (conv4,
    alpha, A) within rtol 1e-4 and atol 1e-4 * max; the gradients that pass
    through bf16 convs (conv1-conv3, x) within 4x the distance of the JAX
    f32 module's from JAX bf16 (bf16 rounding noise, which the port's
    `_bwd` math and JAX's autodiff take at other points; measured up to
    1.55x) plus 1e-4 * max;
  * the JAX `CTRGC(dtype=bfloat16, use_pallas=True)` backward raises
    TypeError (a reference defect: the Pallas VJP hands back f32 cotangents
    for bf16 primals); if a later JAX fixes it, that test says so;
  * a bf16 CTR-GCN (base_channel 32, so l8-l10 have C = 128 and take the
    switch) takes one train-mode step with the switch on as with it off:
    the logits bitwise equal (the forward is the same), every gradient
    within 4x the distance of the f32 model's gradient from the bf16 one
    (bf16 noise: the switch sums db3 from the unrounded x3 gradient) plus
    1e-4 of the largest f32 gradient, the alphas as one vector within half
    that distance (measured: worst tensor 0.57 of its limit, alphas 0.09).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.models.ctrgcn import CTRGC as JaxCTRGC
from tamgcn_tpu.ops.aggregation import unit_ctr_gc_conv3 as jax_unit_ctr_gc_conv3
from tamgcn_tpu.ops.pallas.ctr_gc import ctr_gc_fused_pallas
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import CTRGC, create_ctrgcn_nucla
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops.cuda import ctr_gc

torch.set_num_threads(1)
BF16_TOL = 2.0 ** -7
BF16_SHARE = 0.01
NOISE_TIMES = 4
HALF = 0.5
NAMES = ("x", "w3", "b3", "x1s", "x2s", "w4s", "b4s", "alpha", "As")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(got, want, what):
    """A bf16 result within 2^-7 of the reference's max |value| and equal to
    it in all but BF16_SHARE of its elements."""
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all(), what
    rel = np.abs(got - want).max() / np.abs(want).max()
    share = float((got != want).mean())
    assert rel <= BF16_TOL and share <= BF16_SHARE, (what, rel, share)


def _bf16(rs, *shape, scale=1.0):
    a = torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))
    return a.bfloat16().float().numpy()


# ---- K6-bf16 -----------------------------------------------------------------------

def _conv3_inputs(n, t, v, c, r, cin, s=3, seed=0):
    """(x, w3, b3, x1s, x2s, g) bf16-valued f32 arrays and (w4s, b4s, alpha,
    As) f32."""
    rs = np.random.RandomState(seed)
    acts = (_bf16(rs, n, t, v, cin, scale=0.3), _bf16(rs, cin, s * c, scale=0.1),
            _bf16(rs, s * c, scale=0.1), _bf16(rs, n, s, v, r, scale=0.3),
            _bf16(rs, n, s, v, r, scale=0.3), _bf16(rs, n, t, v, c))
    params = ((rs.randn(s, r, c) * 0.1).astype(np.float32),
              (rs.randn(s, c) * 0.1).astype(np.float32),
              np.asarray([0.7], np.float32), rs.rand(s, v, v).astype(np.float32))
    return acts, params


@pytest.mark.parametrize("shape", [
    dict(n=2, t=4, v=20, c=128, r=16, cin=64),   # l5-l10's gate: C >= 128, S*C >= 384
    dict(n=1, t=3, v=25, c=128, r=8, cin=40),    # NTU joints, Cin not a multiple of 8
], ids=["v20", "v25"])
def test_k6_bf16_matches_pallas_interpret(monkeypatch, shape):
    """UnitCtrGcConv3 on bf16 activations (on the CPU: K1-bf16's, K6-bf16's
    and K3-bf16's plain versions) against the JAX switch path, whose
    backward runs the Pallas K6 body in interpret mode. Every result in the
    JAX dtype: bf16 for x, w3, b3, x1s, x2s and the output, f32 for the
    unit op's parameters."""
    monkeypatch.setenv("TAMGCN_FUSE_CONV3", "1")
    (x, w3, b3, x1s, x2s, g), params = _conv3_inputs(**shape)
    acts = (x, w3, b3, x1s, x2s)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in acts] + [jnp.asarray(p) for p in params]
    out, vjp = jax.vjp(lambda *a: jax_unit_ctr_gc_conv3(*a, use_pallas=True), *jargs)
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    targs = ([torch.from_numpy(a).bfloat16().requires_grad_() for a in acts]
             + [torch.from_numpy(p).requires_grad_() for p in params])
    got_out = port.unit_ctr_gc_conv3(*targs)
    assert out.dtype == jnp.bfloat16 and got_out.dtype == torch.bfloat16
    _bf16_close(got_out, out, "out")
    got = torch.autograd.grad(got_out, targs, torch.from_numpy(g).bfloat16())
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        if name in ("x", "w3", "b3", "x1s", "x2s"):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
            assert np.abs(_f32(b)).max() > 1e-3, f"{name}: a zero gradient hides the check"
            _bf16_close(a, b, f"d{name}")
            continue
        assert a.dtype == torch.float32 and b.dtype == jnp.float32, name
        w = _f32(b)
        rtol, atol = (1e-3, 0.0) if name == "alpha" else (1e-4, 1e-4 * np.abs(w).max())
        np.testing.assert_allclose(_f32(a), w, rtol=rtol, atol=atol, err_msg=f"d{name}")
    assert ctr_gc.bwd_conv3_launches_bf16 == ctr_gc.bwd_conv3_launches == 0


def test_k6_bf16_plain_rounds_where_the_jax_kernel_rounds():
    """The plain K6-bf16 takes the f32 x3 gradient into db3 unrounded and
    into the products rounded once: db3 summed from the rounded gradient,
    or dx from the unrounded one, moves more than BF16_SHARE of the
    elements, so the checks above see where the rounding happens."""
    (x, w3, _, x1s, x2s, g), params = _conv3_inputs(n=2, t=4, v=20, c=128, r=16, cin=64)
    b = [torch.from_numpy(a).bfloat16() for a in (x1s, x2s, g, x, w3)]
    p = [torch.from_numpy(a) for a in params]
    dx, dw3, db3 = port.unit_ctr_gc_bwd_conv3_plain(*b, *p)
    dx3 = port.unit_ctr_gc_dx3_plain(b[0], b[1], b[2].float(), *p)  # f32, unrounded
    assert dx3.dtype == torch.float32
    rounded_db3 = dx3.bfloat16().float().sum(dim=(0, 1, 2)).bfloat16()
    unrounded_dx = torch.matmul(dx3, b[4].float().t()).bfloat16()
    for name, got, other in (("db3", db3, rounded_db3), ("dx", dx, unrounded_dx)):
        assert float((_f32(got) != _f32(other)).mean()) > BF16_SHARE, name
    assert dx.dtype == dw3.dtype == db3.dtype == torch.bfloat16


# ---- K4-bf16 -----------------------------------------------------------------------

def _fused_inputs(n, t, v, c, r, seed=0):
    """(x1, x2, x3) bf16-valued, (w4, b4, alpha, A) f32 and an f32 g."""
    rs = np.random.RandomState(seed)
    acts = (_bf16(rs, n, v, r), _bf16(rs, n, v, r), _bf16(rs, n, t, v, c))
    params = ((rs.randn(r, c) * 0.1).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32),
              np.asarray([0.7], np.float32), rs.rand(v, v).astype(np.float32))
    return acts, params, rs.randn(n, t, v, c).astype(np.float32)


@pytest.mark.parametrize("shape", [dict(n=2, t=8, v=20, c=64, r=8),
                                   dict(n=2, t=16, v=25, c=128, r=16)], ids=["v20", "v25"])
def test_k4_bf16_matches_pallas_interpret(shape):
    """CtrGcFused on bf16 x1, x2, x3 (on the CPU, K4-bf16's plain forward and
    transpose) against ctr_gc_fused_pallas in interpret mode: the f32
    output, and the x3 gradient in x3's dtype against the JAX VJP's f32 one
    rounded to bf16."""
    acts, params, g = _fused_inputs(**shape)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in acts] + [jnp.asarray(p) for p in params]
    out, vjp = jax.vjp(ctr_gc_fused_pallas, *jargs)
    want_dx3 = vjp(jnp.asarray(g))[2]
    assert out.dtype == want_dx3.dtype == jnp.float32
    x1, x2, x3 = (torch.from_numpy(a).bfloat16() for a in acts)
    x3.requires_grad_()
    got = port.ctr_gc_fused(x1, x2, x3, *map(torch.from_numpy, params))
    assert got.dtype == torch.float32
    want = np.asarray(out)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=1e-4 * np.abs(want).max())
    (dx3,) = torch.autograd.grad(got, x3, torch.from_numpy(g))
    assert dx3.dtype == torch.bfloat16
    _bf16_close(dx3, want_dx3.astype(jnp.bfloat16), "dx3")
    assert ctr_gc.k4_launches_bf16 == ctr_gc.k4_t_launches_bf16 == 0


def _jax_ctrgc(cin, cout, seed=3):
    """The JAX CTRGC's f32 variables with conv4_bias moved off zero."""
    jm = JaxCTRGC(in_channels=cin, out_channels=cout, use_pallas=False)
    x = jnp.zeros((1, 4, 20, cin), jnp.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed), x, jnp.eye(20), jnp.ones(1)))
    rs = np.random.RandomState(seed)
    params = dict(variables["params"])
    params["conv4_bias"] = (rs.randn(cout) * 0.1).astype(np.float32)
    return {"params": params}


def test_ctrgc_bf16_module_matches_jax():
    """The port CTRGC(dtype="bfloat16") against the JAX module with
    dtype=bfloat16 and use_pallas=False: the output and every gradient
    (parameters, x, A, alpha), with the JAX f32 module as the yardstick of
    bf16 noise."""
    cin, cout, n, t, v = 16, 24, 2, 8, 20
    variables = _jax_ctrgc(cin, cout)
    rs = np.random.RandomState(5)
    x = rs.randn(n, t, v, cin).astype(np.float32)
    A = rs.rand(v, v).astype(np.float32)
    alpha = np.asarray([0.6], np.float32)
    g = rs.randn(n, t, v, cout).astype(np.float32)
    jax_runs = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", None)):
        jm = JaxCTRGC(in_channels=cin, out_channels=cout, use_pallas=False, dtype=dtype)
        out, vjp = jax.vjp(lambda p, x, A, al, jm=jm: jm.apply({"params": p}, x, A, al),
                           variables["params"], jnp.asarray(x), jnp.asarray(A),
                           jnp.asarray(alpha))
        jax_runs[name] = (out, *vjp(jnp.asarray(g)))

    model = CTRGC(cin, cout, dtype="bfloat16")
    model.load_state_dict(from_flax(variables, model))
    tx, tA, talpha = (torch.from_numpy(a).requires_grad_() for a in (x, A, alpha))
    got = model(tx, tA, talpha)
    assert got.dtype == torch.float32 and jax_runs["bf16"][0].dtype == jnp.float32
    want, want32 = (np.asarray(jax_runs[k][0]) for k in ("bf16", "f32"))
    gap = np.abs(_f32(got) - want).max()
    assert gap <= 1e-4 * np.abs(want).max(), gap
    assert gap <= HALF * np.abs(want - want32).max(), gap
    got.backward(torch.from_numpy(g))

    def grads(run):
        _, dparams, dx, dA, dalpha = run
        out = dict(from_flax(jax.device_get({"params": dparams}), model))
        out.update(x=dx, A=dA, alpha=dalpha)
        return {k: np.asarray(v) for k, v in out.items()}

    wants, wants32 = grads(jax_runs["bf16"]), grads(jax_runs["f32"])
    ours = {k: p.grad for k, p in model.named_parameters()}
    ours.update(x=tx.grad, A=tA.grad, alpha=talpha.grad)
    assert set(ours) == set(wants)
    for name, a in ours.items():
        w, w32 = wants[name], wants32[name]
        assert a.dtype == torch.float32 and np.abs(w).max() > 1e-3, name
        if name in ("conv4_kernel", "conv4_bias", "A", "alpha"):
            rtol, atol = 1e-4, 1e-4 * np.abs(w).max()
        else:
            rtol, atol = 0.0, NOISE_TIMES * np.abs(w - w32).max() + 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(_f32(a), w, rtol=rtol, atol=atol, err_msg=name)


def test_jax_ctrgc_bf16_pallas_backward_is_a_reference_defect():
    """The JAX CTRGC(dtype=bfloat16, use_pallas=True) runs forward, but its
    backward raises TypeError: the custom VJP of ctr_gc_fused_pallas hands
    back f32 cotangents for the bf16 x1, x2 and x3, which conv1-conv3's VJPs
    refuse. The port follows the XLA path's dtypes instead. If this test
    fails, a later JAX (or package) fixed the defect, and the port's module
    test can be held to the Pallas path too."""
    jm = JaxCTRGC(in_channels=16, out_channels=24, use_pallas=True, dtype=jnp.bfloat16)
    x = jnp.asarray(np.random.RandomState(1).randn(2, 4, 20, 16), jnp.float32)
    variables = _jax_ctrgc(16, 24)
    out, vjp = jax.vjp(lambda p: jm.apply({"params": p}, x, jnp.eye(20), jnp.ones(1)),
                       variables["params"])
    assert out.dtype == jnp.float32
    with pytest.raises(TypeError, match="same dtypes"):
        vjp(jnp.ones_like(out))


def test_fused_op_refuses_mixed_dtypes():
    acts, params, _ = _fused_inputs(n=1, t=4, v=20, c=16, r=8)
    x1, x2, x3 = map(torch.from_numpy, acts)
    p = [torch.from_numpy(a) for a in params]
    with pytest.raises(TypeError, match="all in bfloat16"):
        port.ctr_gc_fused(x1.bfloat16(), x2.bfloat16(), x3, *p)
    with pytest.raises(TypeError, match="all in bfloat16"):
        port.ctr_gc_fused_plain(x1, x2, x3.bfloat16(), *p)


# ---- the switch in a bf16 model -------------------------------------------------------

def _model(dtype):
    model = create_ctrgcn_nucla(base_channel=32, generator=torch.Generator().manual_seed(2),
                                dtype=dtype)
    with torch.no_grad():  # what hides the aggregation at init
        g = torch.Generator().manual_seed(4)
        for blk in model.blocks:
            blk.gcn1.alpha.fill_(0.5)
            blk.gcn1.bn.weight.fill_(1.0)
            blk.gcn1.offset_conv.weight.normal_(0.0, 0.02, generator=g)
    return model.train()


def test_bf16_train_step_with_the_switch(monkeypatch):
    """One train-mode forward and backward of a bf16 CTR-GCN (base_channel
    32, batch 2, T=16) with TAMGCN_FUSE_CONV3=1 (K6-bf16's plain version at
    l8-l10) against the same model with the switch off, and the f32 model
    as the yardstick of bf16 noise."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 16, 20, 1).astype(np.float32))
    y = torch.tensor([1, 7])
    k6 = port.unit_ctr_gc_bwd_conv3_plain
    calls = []
    monkeypatch.setattr(port, "unit_ctr_gc_bwd_conv3_plain",
                        lambda *a: calls.append(a[3].dtype) or k6(*a))
    base = {"bfloat16": _model("bfloat16"), None: _model(None)}
    runs = {}
    for dtype, switch in (("bfloat16", "0"), ("bfloat16", "1"), (None, "0")):
        monkeypatch.setenv("TAMGCN_FUSE_CONV3", switch)
        model = copy.deepcopy(base[dtype])
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        runs[dtype, switch] = logits.detach(), {k: p.grad for k, p in model.named_parameters()}
    assert calls == [torch.bfloat16] * 3  # l8-l10
    (logits_off, off), (logits_on, on), (_, f32) = (
        runs["bfloat16", "0"], runs["bfloat16", "1"], runs[None, "0"])
    assert torch.equal(logits_on, logits_off)
    floor = 1e-4 * max(t.abs().max().item() for t in f32.values())
    alphas = [k for k in off if k.endswith("gcn1.alpha")]
    for k, want in off.items():
        if k in alphas:
            continue
        noise = (want - f32[k]).abs().max().item()
        torch.testing.assert_close(on[k], want, rtol=0, atol=NOISE_TIMES * noise + floor,
                                   msg=k)
    for blk in list(base["bfloat16"].blocks)[7:]:  # the fused blocks' gradients are real
        name = [k for k, p in base["bfloat16"].named_parameters() if p is blk.gcn1.conv3.weight][0]
        assert on[name].abs().max() > 1e-6, name

    def vec(grads):
        return torch.cat([grads[k] for k in alphas])

    assert (vec(on) - vec(off)).norm() <= HALF * (vec(off) - vec(f32)).norm()
