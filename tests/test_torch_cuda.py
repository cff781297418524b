"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel against its plain PyTorch version on the same inputs, f32 with
TF32 off: K1 and K2 within rtol 1e-5 and atol 1e-5 * max|plain| (the sum
order differs); K3's gradients are sums of up to N*T*V*V terms taken in
another order, so within rtol 1e-4 and atol 1e-4 * max|plain| (dalpha, one
sum over all N*S*V*V*C terms, within rtol 1e-3). K6's dx within rtol 1e-5
and atol 1e-4 * max|plain| (two products in a row), its dw3 and db3 (sums
over N*T*V rows) within rtol 1e-4 and atol 1e-4 * max|plain|. Also the
wrappers' checks and launch counts, two K3 (and two K6) launches bitwise
equal, a small CTR-GCN on the card against the same model on the CPU,
forward and gradients, and the standalone CTRGC module through K1 and K2 at
S = 1 against its plain route. This file imports no JAX, so it runs where
the port runs.
"""
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.ops.aggregation import (
    unit_ctr_gc, unit_ctr_gc_dx3_plain, unit_ctr_gc_param_grads_plain,
    unit_ctr_gc_plain)
from tamgcn_tpu_torch.ops.cuda import ctr_gc

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n, t, v, c, r, device, s=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(n, s, v, r), (n, s, v, r), (n, t, v, s * c), (s, r, c), (s, c)]
    scales = [1.0, 1.0, 1.0, 0.1, 0.1]
    args = [torch.randn(sh, generator=g) * k for sh, k in zip(shapes, scales)]
    args += [torch.rand(1, generator=g) + 0.5, torch.rand((s, v, v), generator=g)]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("shape", [
    (2, 16, 20, 64, 8), (2, 13, 20, 256, 32), (3, 9, 25, 128, 16),
    (1, 7, 20, 80, 10), (2, 5, 20, 4, 3), (2, 6, 28, 64, 32),
], ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_unit_kernel_matches_plain(device, shape):
    args = _inputs(*shape, device=device)
    before = ctr_gc.launches
    with torch.no_grad():
        got = unit_ctr_gc(*args)
        want = unit_ctr_gc_plain(*args)
    torch.cuda.synchronize()
    assert ctr_gc.launches == before + 1
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_unit_kernel_rejects_what_it_does_not_take(device):
    args = _inputs(1, 4, 20, 64, 8, device=device)
    with pytest.raises(TypeError, match="float32"):
        ctr_gc.unit_ctr_gc_fwd(*[a.double() for a in args])
    bad = list(args)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ctr_gc.unit_ctr_gc_fwd(*bad)
    with pytest.raises(ValueError, match="R <= 32"):
        ctr_gc.unit_ctr_gc_fwd(*_inputs(1, 4, 20, 64, 40, device=device))
    with pytest.raises(ValueError, match="C % 4"):
        ctr_gc.unit_ctr_gc_fwd(*_inputs(1, 4, 20, 70, 8, device=device))
    with pytest.raises(ValueError, match="shared memory"):
        ctr_gc.unit_ctr_gc_fwd(*_inputs(1, 2, 64, 64, 8, device=device))
    # K2 and K3 refuse what they do not take, and count no launch for it
    x1s, x2s, x3s, w4s, b4s, alpha, As = args
    g = torch.randn((1, 4, 20, 64), device=device)
    before = (ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches)
    with pytest.raises(ValueError, match="contiguous"):
        ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g.transpose(1, 2).contiguous()
                                   .transpose(1, 2), w4s, b4s, alpha, As)
    with pytest.raises(TypeError, match="float32"):
        ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g.double(), x3s, w4s, b4s, alpha)
    with pytest.raises(ValueError, match="shape"):
        ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g[:, :3], x3s, w4s, b4s, alpha)
    with pytest.raises(ValueError, match="CUDA"):
        ctr_gc.unit_ctr_gc_bwd_dx3(*[a.cpu() for a in (x1s, x2s, g, w4s, b4s, alpha, As)])
    big = _inputs(1, 2, 64, 64, 8, device=device)
    g_big = torch.randn((1, 2, 64, 64), device=device)
    with pytest.raises(ValueError, match="shared memory"):
        ctr_gc.unit_ctr_gc_bwd_dx3(*big[:2], g_big, *big[3:])
    with pytest.raises(ValueError, match="shared memory"):
        ctr_gc.unit_ctr_gc_bwd_param(*big[:2], g_big, *big[2:6])
    assert (ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches) == before


BWD_SHAPES = [
    (16, 52, 20, 64, 8), (16, 52, 20, 128, 8), (16, 26, 20, 128, 16),
    (16, 26, 20, 256, 16), (16, 13, 20, 256, 32), (4, 26, 25, 128, 16),
    (4, 13, 25, 256, 32), (3, 7, 20, 80, 10), (1, 13, 20, 256, 32),
]


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_dx3_kernel_matches_plain(device, shape):
    x1s, x2s, _, w4s, b4s, alpha, As = _inputs(*shape, device=device)
    n, t, v, c, _ = shape
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    before = ctr_gc.bwd_dx3_launches
    got = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
    want = unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
    torch.cuda.synchronize()
    assert ctr_gc.bwd_dx3_launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


# K3 reads channels one at a time and takes any C
@pytest.mark.parametrize("shape", BWD_SHAPES + [(2, 7, 20, 70, 10)],
                         ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_param_kernel_matches_plain(device, shape):
    x1s, x2s, x3s, w4s, b4s, alpha, _ = _inputs(*shape, device=device)
    n, t, v, c, _ = shape
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    before = ctr_gc.bwd_param_launches
    got = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
    again = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
    want = unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)
    torch.cuda.synchronize()
    assert ctr_gc.bwd_param_launches == before + 2
    names = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
    for name, a, b, w in zip(names, got, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


def _small_model():
    model = create_ctrgcn_nucla(base_channel=16,
                                generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for blk in model.blocks:  # what hides the kernels at init
            blk.gcn1.alpha.fill_(0.5)
            blk.gcn1.bn.weight.fill_(1.0)
            blk.gcn1.offset_conv.weight.normal_(
                0.0, 0.02, generator=torch.Generator().manual_seed(4))
    return model


def test_model_on_card_matches_cpu(device):
    model = _small_model().eval()
    x = torch.randn((4, 3, 52, 20, 1), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        before = ctr_gc.launches
        got = model.to(device)(x.to(device)).cpu()
    assert ctr_gc.launches == before + 10
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def _grads(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    return loss.detach().double().cpu(), {
        k: p.grad.double().cpu() for k, p in model.named_parameters()}


def _batch():
    x = torch.randn((4, 3, 52, 20, 1), generator=torch.Generator().manual_seed(3))
    return x, torch.tensor([1, 4, 7, 2])


def test_model_grads_on_card_match_cpu(device):
    """One train-mode forward and backward of a small CTR-GCN: the loss and
    every parameter gradient on the card (K1-K3, f32) against the CPU in
    float64. The loss within rtol 1e-5. The gradients within 5e-2 x the
    largest gradient of the model: relu and max-pool decisions at near-ties
    flip under rounding-size changes of the forward, and each flip moves some
    gradients (measured on the CPU with the plain path: a relative noise of
    4e-7 on the unit op's output moves the offset convs' gradients by up to
    1e-2 x the largest gradient). The test below holds the kernels
    themselves to their plain versions inside such a backward."""
    x, y = _batch()
    want_loss, want = _grads(_small_model().double().train(), x.double(), y)
    model = _small_model().train().to(device)
    before = (ctr_gc.launches, ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches)
    loss, got = _grads(model, x.to(device), y.to(device))
    torch.cuda.synchronize()
    assert (ctr_gc.launches, ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches) == tuple(
        b + 10 for b in before)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    gmax = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        if k.split(".")[-1] in ("alpha", "conv4_kernel", "conv4_bias", "PA"):
            assert w.abs().max() > 1e-3 * gmax, f"{k}: a zero gradient hides the check"
        torch.testing.assert_close(got[k], w, rtol=0, atol=5e-2 * gmax, msg=k)


def test_unit_kernels_inside_a_model_backward_match_plain(device, monkeypatch):
    """Inside a train-mode forward and backward of the small CTR-GCN on the
    card, every launch of K1, K2 and K3 is held against its plain version on
    the very same inputs, with the tolerances of the tests above."""
    from tamgcn_tpu_torch.ops import aggregation as agg

    kernels = agg._kernels(device)
    checked = []

    def close(name, got, want, rtol, atol_frac):
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=atol_frac * want.abs().max().item(), msg=name)

    def k1(*a):
        out = kernels[0](*a)
        close("K1", out, unit_ctr_gc_plain(*a), 1e-5, 1e-5)
        checked.append("K1")
        return out

    def k2(*a):
        out = kernels[1](*a)
        close("K2", out, unit_ctr_gc_dx3_plain(*a), 1e-5, 1e-5)
        checked.append("K2")
        return out

    def k3(*a):
        out = kernels[2](*a)
        names = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
        for name, got, want in zip(names, out, unit_ctr_gc_param_grads_plain(*a)):
            close(name, got, want, *((1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4)))
        checked.append("K3")
        return out

    monkeypatch.setattr(agg, "_kernels", lambda d: (k1, k2, k3))
    x, y = _batch()
    _grads(_small_model().train().to(device), x.to(device), y.to(device))
    assert sorted(checked) == ["K1"] * 10 + ["K2"] * 10 + ["K3"] * 10


def _block_inputs(n, t, v, cin, c, r, device, seed=0):
    """K5's inputs (as keywords) with alpha != 0, b4 != 0, a random
    non-symmetric A, a BN affine gy far from (1, 0) and, where Cin != C, a
    down conv; P = 3C/4 and BC = C/4 as in the model."""
    g = torch.Generator().manual_seed(seed)
    S, P, BC = 3, 3 * c // 4, c // 4

    def w(*shape, fan=4):
        return torch.randn(shape, generator=g) / fan ** 0.5

    args = dict(
        x=torch.randn((n, t, v, cin), generator=g), x1s=torch.randn((n, S, v, r), generator=g),
        x2s=torch.randn((n, S, v, r), generator=g), w3=w(cin, S * c, fan=cin), b3=w(S * c),
        w4s=w(S, r, c, fan=r), b4s=w(S, c), alpha=torch.tensor([0.7]),
        As=torch.rand((S, v, v), generator=g),
        gy=torch.stack([1.0 + 0.5 * torch.randn(c, generator=g), 0.3 * torch.randn(c, generator=g)]),
        wo=w(c, c, fan=c), bo=w(c), wp=w(c, P, fan=c), bp=w(P), wpw=w(c, BC, fan=c), bpw=w(BC),
        wd=None if cin == c else w(cin, c, fan=cin), bd=None if cin == c else w(c),
    )
    return {k: None if a is None else a.to(device) for k, a in args.items()}


# (N, T, V, Cin, C, R): the ten blocks' shapes at a small batch, V=25, ragged
BLOCK_SHAPES = [
    (4, 52, 20, 3, 64, 8), (4, 52, 20, 64, 64, 8), (4, 52, 20, 64, 128, 8),
    (4, 26, 20, 128, 128, 16), (4, 26, 20, 128, 256, 16), (4, 13, 20, 256, 256, 32),
    (4, 26, 25, 128, 128, 16), (3, 7, 20, 80, 64, 10),
]


@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*s))
def test_block_kernel_matches_plain(device, shape):
    """K5 against its plain version within rtol 1e-5 and atol 1e-4 *
    max|plain|: four products in a row, each summing up to 3*C terms in
    another order."""
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_fused, gcn_tcn_block_plain

    args = _block_inputs(*shape, device=device)
    before = (k5.launches, ctr_gc.launches)
    with torch.no_grad():
        got = gcn_tcn_block_fused(**args)
        want = gcn_tcn_block_plain(**args)
    torch.cuda.synchronize()
    assert (k5.launches, ctr_gc.launches) == (before[0] + 1, before[1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4 * b.abs().max().item())


def test_block_kernel_rejects_what_it_does_not_take(device):
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5

    args = _block_inputs(2, 4, 20, 64, 64, 8, device=device)
    before = k5.launches
    with pytest.raises(TypeError, match="float32"):
        k5.gcn_tcn_block_fwd(**{k: v.double() for k, v in args.items() if v is not None})
    with pytest.raises(ValueError, match="CUDA"):
        k5.gcn_tcn_block_fwd(**{k: v.cpu() for k, v in args.items() if v is not None})
    bad = dict(args, x=args["x"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        k5.gcn_tcn_block_fwd(**bad)
    with pytest.raises(ValueError, match="shape"):
        k5.gcn_tcn_block_fwd(**dict(args, wo=args["wo"][:, :60].contiguous()))
    with pytest.raises(ValueError, match="both"):
        k5.gcn_tcn_block_fwd(**dict(args, wd=torch.zeros((64, 64), device=device)))
    with pytest.raises(ValueError, match="Cin == C"):
        k5.gcn_tcn_block_fwd(**_block_inputs(2, 4, 20, 32, 64, 8, device=device) | dict(wd=None, bd=None))
    with pytest.raises(ValueError, match="R <= 32"):
        k5.gcn_tcn_block_fwd(**_block_inputs(1, 4, 20, 64, 64, 40, device=device))
    with pytest.raises(ValueError, match="shared memory"):
        k5.gcn_tcn_block_fwd(**_block_inputs(1, 2, 64, 64, 64, 8, device=device))
    assert k5.launches == before


def test_fast_eval_on_card_matches_cpu(device):
    """make_fast_eval on the card (K5 in every block) against the unfused
    model on the CPU, within rtol 1e-4 and atol 1e-4 * max|logit|."""
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5

    model = _small_model().eval()
    with torch.no_grad():  # BN stats away from mean 0, var 1
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.running_mean.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(5))
                m.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(6))
    x = torch.randn((4, 3, 52, 20, 1), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        before = (k5.launches, ctr_gc.launches)
        got = make_fast_eval(model.to(device))(x.to(device)).cpu()
    assert (k5.launches, ctr_gc.launches) == (before[0] + 10, before[1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


# (N, T, V, Cin, C, R): l5-l10 at a small batch, V=25, and a ragged shape
CONV3_SHAPES = [
    (4, 52, 20, 64, 128, 8), (4, 26, 20, 128, 128, 16), (4, 26, 20, 128, 256, 16),
    (4, 13, 20, 256, 256, 32), (3, 9, 25, 128, 128, 16), (2, 13, 25, 256, 256, 32),
    (3, 7, 20, 30, 40, 10),
]


def _conv3_inputs(n, t, v, cin, c, r, device, seed=0):
    """K6's inputs: x1s, x2s, g, x, w3, w4s, b4s, alpha, As, with w3 the
    transposed view of a contiguous (S*C, Cin) weight, as in the model."""
    x1s, x2s, _, w4s, b4s, alpha, As = _inputs(n, 1, v, c, r, device=device, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn((n, t, v, c), generator=gen).to(device)
    x = torch.randn((n, t, v, cin), generator=gen).to(device)
    w3 = (torch.randn((3 * c, cin), generator=gen) / cin ** 0.5).to(device).t()
    return x1s, x2s, g, x, w3, w4s, b4s, alpha, As


@pytest.mark.parametrize("shape", CONV3_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*s))
def test_conv3_kernel_matches_plain(device, shape):
    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_bwd_conv3_plain

    args = _conv3_inputs(*shape, device=device)
    before = ctr_gc.bwd_conv3_launches
    got = ctr_gc.unit_ctr_gc_bwd_conv3(*args)
    again = ctr_gc.unit_ctr_gc_bwd_conv3(*args)
    want = unit_ctr_gc_bwd_conv3_plain(*args)
    torch.cuda.synchronize()
    assert ctr_gc.bwd_conv3_launches == before + 2
    for name, a, b, w in zip(("dx", "dw3", "db3"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two launches differ"
        rtol = 1e-5 if name == "dx" else 1e-4
        torch.testing.assert_close(a, w, rtol=rtol, atol=1e-4 * w.abs().max().item(), msg=name)


def test_conv3_kernel_rejects_what_it_does_not_take(device):
    args = list(_conv3_inputs(1, 4, 20, 64, 128, 8, device=device))
    before = ctr_gc.bwd_conv3_launches
    with pytest.raises(ValueError, match="CUDA"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*[a.cpu() for a in args])
    bad = list(args)
    bad[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*bad)
    with pytest.raises(ValueError, match="shape"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*args[:4], args[4][:, :-3], *args[5:])
    with pytest.raises(TypeError, match="float32"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="shared memory"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*_conv3_inputs(1, 4, 20, 4096, 128, 8, device=device))
    assert ctr_gc.bwd_conv3_launches == before


def test_fused_conv3_op_on_card_matches_plain(device, monkeypatch):
    """TAMGCN_FUSE_CONV3=1: the dispatcher takes UnitCtrGcConv3 (K1, K6, K3)
    at C=128, and its output and nine gradients match the same op's plain
    versions on the card."""
    from tamgcn_tpu_torch.ops import aggregation as agg

    monkeypatch.setenv("TAMGCN_FUSE_CONV3", "1")
    x1s, x2s, g, x, w3, w4s, b4s, alpha, As = _conv3_inputs(4, 26, 20, 128, 128, 16, device)
    args = [x, w3, torch.randn(384, device=device) * 0.1,
            x1s, x2s, w4s, b4s, alpha, As]

    def run():
        leaves = [a.detach().clone().requires_grad_() for a in args]
        out = agg.unit_ctr_gc_conv3(*leaves)
        grads = torch.autograd.grad(out, leaves, g)
        return [out.detach(), *grads]

    before = (ctr_gc.launches, ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches,
              ctr_gc.bwd_conv3_launches)
    got = run()
    torch.cuda.synchronize()
    assert (ctr_gc.launches, ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches,
            ctr_gc.bwd_conv3_launches) == (before[0] + 1, before[1], before[2] + 1, before[3] + 1)
    monkeypatch.setattr(agg, "_kernels", lambda d: (
        agg.unit_ctr_gc_plain, agg.unit_ctr_gc_dx3_plain, agg.unit_ctr_gc_param_grads_plain))
    monkeypatch.setattr(agg, "_conv3_kernel", lambda d: agg.unit_ctr_gc_bwd_conv3_plain)
    want = run()
    names = ("out", "x", "w3", "b3", "x1s", "x2s", "w4s", "b4s", "alpha", "As")
    for name, a, w in zip(names, got, want):
        rtol, atol = (1e-3, 0.0) if name == "alpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("shape", [(4, 52, 20, 64, 128), (3, 9, 25, 32, 64)],
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}".format(*s))
def test_ctrgc_module_on_card_matches_plain_route(device, shape, monkeypatch):
    """The standalone CTRGC through K1 and K2 at S = 1 against the same
    module with the plain single-subset op, on the card: the output within
    rtol 1e-5 and atol 1e-5 * max, every gradient within rtol 1e-4 and atol
    1e-4 * max (alpha's, one sum over every term, within rtol 1e-3)."""
    from tamgcn_tpu_torch.models import CTRGC, ctrgcn
    from tamgcn_tpu_torch.ops.aggregation import ctr_gc_fused_plain

    n, t, v, cin, c = shape
    gen = torch.Generator().manual_seed(8)
    module = CTRGC(cin, c, generator=gen)
    with torch.no_grad():
        module.conv4_bias.normal_(0.0, 0.1, generator=gen)
    module.to(device)
    x = torch.randn((n, t, v, cin), generator=gen).to(device)
    A = torch.rand((v, v), generator=gen).to(device)
    g = torch.randn((n, t, v, c), generator=gen).to(device)

    def run():
        leaves = [x.clone().requires_grad_(), A.clone().requires_grad_(),
                  torch.tensor([0.7], device=device, requires_grad=True)]
        module.zero_grad(set_to_none=True)
        out = module(*leaves)
        out.backward(g)
        grads = {k: p.grad for k, p in module.named_parameters()}
        grads.update(zip(("x", "A", "alpha"), (a.grad for a in leaves)))
        return out.detach(), grads

    before = (ctr_gc.launches, ctr_gc.bwd_dx3_launches)
    out, grads = run()
    torch.cuda.synchronize()
    assert (ctr_gc.launches, ctr_gc.bwd_dx3_launches) == (before[0] + 1, before[1] + 1)
    monkeypatch.setattr(ctrgcn, "ctr_gc_fused", ctr_gc_fused_plain)
    want_out, want = run()
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5 * want_out.abs().max().item())
    for k, w in want.items():
        rtol, atol = (1e-3, 0.0) if k == "alpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(grads[k], w, rtol=rtol, atol=atol, msg=k)


# T1 (N, T, V, bc, stride): the fast-eval blocks' branch halves at batch 64,
# exp_ms_tcn's NTU-shaped block, and a ragged shape (odd T at stride 2, bc=5)
T1_SHAPES = [
    (64, 52, 20, 16, 1), (64, 52, 20, 32, 2), (64, 26, 20, 32, 1), (64, 26, 20, 64, 2),
    (64, 13, 20, 64, 1), (32, 64, 25, 16, 1), (3, 7, 20, 5, 2),
]


def _t1_inputs(n, t, v, bc, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [a.to(device) for a in (
        torch.randn((n, t, v, 3 * bc), generator=g),
        torch.randn((2, 5, bc, bc), generator=g) / (5 * bc) ** 0.5,
        0.1 * torch.randn((2, bc), generator=g),
        torch.stack([1.0 + 0.5 * torch.randn(bc, generator=g), 0.3 * torch.randn(bc, generator=g)]))]


@pytest.mark.parametrize("shape", T1_SHAPES, ids=lambda s: "N{}-T{}-V{}-bc{}-s{}".format(*s))
def test_ms_tcn_kernel_matches_plain(device, shape):
    """T1 against its plain version (cuDNN convolutions) within rtol 1e-5 and
    atol 1e-4 * max|plain|: each output sums up to 5*bc terms in another
    order; two launches bitwise equal."""
    from tamgcn_tpu_torch.ops.cuda import ms_tcn as t1
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_fused, ms_tcn_plain

    args, stride = _t1_inputs(*shape[:4], device=device), shape[4]
    before = t1.launches
    with torch.no_grad():
        got = ms_tcn_fused(*args, stride)
        again = ms_tcn_fused(*args, stride)
        want = ms_tcn_plain(*args, stride)
    torch.cuda.synchronize()
    assert t1.launches == before + 2
    assert got.shape == want.shape and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * want.abs().max().item())


def test_ms_tcn_kernel_rejects_what_it_does_not_take(device):
    from tamgcn_tpu_torch.ops.cuda import ms_tcn as t1

    prefix, w, b, mp = _t1_inputs(2, 8, 20, 16, device)
    before = t1.launches
    with pytest.raises(ValueError, match="CUDA"):
        t1.ms_tcn_fwd(prefix.cpu(), w.cpu(), b.cpu(), mp.cpu(), 1)
    with pytest.raises(TypeError, match="float32"):
        t1.ms_tcn_fwd(prefix.double(), w, b, mp, 1)
    with pytest.raises(ValueError, match="contiguous"):
        t1.ms_tcn_fwd(prefix.transpose(1, 2).contiguous().transpose(1, 2), w, b, mp, 1)
    with pytest.raises(ValueError, match="w has shape"):
        t1.ms_tcn_fwd(prefix, w[:, :, :8], b, mp, 1)
    with pytest.raises(ValueError, match="shared memory"):
        t1.ms_tcn_fwd(*_t1_inputs(1, 4, 20, 512, device), 1)
    assert t1.launches == before


# T2 (N, T, V, C, S): the stage-2 tools' shape, V=25 and a ragged shape;
# the cases (form, subset sum, dtype)
T2_SHAPES = [(64, 13, 20, 256, 3), (8, 13, 25, 256, 3), (3, 5, 7, 10, 3)]
T2_CASES = [("tile", False, torch.float32), ("tile", False, torch.bfloat16),
            ("win", False, torch.float32), ("floor", False, torch.float32),
            ("flat", False, torch.float32), ("flat", True, torch.float32),
            ("floor", True, torch.bfloat16)]


@pytest.mark.parametrize("case", T2_CASES,
                         ids=lambda c: f"{c[0]}{'-ss' if c[1] else ''}-{str(c[2])[6:]}")
@pytest.mark.parametrize("shape", T2_SHAPES, ids=lambda s: "N{}-T{}-V{}-C{}-S{}".format(*s))
def test_stage2_kernel_matches_plain(device, shape, case):
    """T2 against its plain version: f32 within rtol 1e-5 and atol 1e-5 *
    max|plain| (sums of V terms, S*V with the subset sum, in another order);
    bf16 within one rounding of the output (rtol 2^-7, a bf16 ulp); two
    launches bitwise equal."""
    from tamgcn_tpu_torch.ops.cuda import stage2 as t2
    from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain

    form, subset_sum, dtype = case
    n, t, v, c, s = shape
    g = torch.Generator().manual_seed(7)
    m = (0.05 * torch.randn((v, v, s * c), generator=g)).to(device, dtype)
    x3 = torch.randn((n, t, v, s * c), generator=g).to(device, dtype)
    if form == "flat":
        m, x3 = m.reshape(v, -1), x3.reshape(n, t, -1)
    before = t2.launches
    with torch.no_grad():
        got = stage2_aggregate(m, x3, form, s, subset_sum)
        again = stage2_aggregate(m, x3, form, s, subset_sum)
        want = stage2_plain(m, x3, form, s, subset_sum)
    torch.cuda.synchronize()
    assert t2.launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, again)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * want.float().abs().max().item())


def test_stage2_kernel_rejects_what_it_does_not_take(device):
    from tamgcn_tpu_torch.ops.cuda import stage2 as t2

    g = torch.Generator().manual_seed(7)
    m = torch.randn((20, 20, 48), generator=g).to(device)
    x3 = torch.randn((2, 3, 20, 48), generator=g).to(device)
    before = t2.launches
    with pytest.raises(ValueError, match="CUDA"):
        t2.stage2_aggregate_fwd(m.cpu(), x3.cpu(), "tile")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t2.stage2_aggregate_fwd(m.double(), x3.double(), "tile")
    with pytest.raises(TypeError, match="same"):
        t2.stage2_aggregate_fwd(m.bfloat16(), x3, "tile")
    with pytest.raises(ValueError, match="contiguous"):
        t2.stage2_aggregate_fwd(m, x3.transpose(0, 1).contiguous().transpose(0, 1), "diag")
    with pytest.raises(ValueError, match="m has shape"):
        t2.stage2_aggregate_fwd(m[:, :, :40].contiguous(), x3, "floor")
    with pytest.raises(ValueError, match="L % S"):
        t2.stage2_aggregate_fwd(m, x3, "tile", subsets=5)
    big = torch.randn((40, 40, 8), device=device)
    with pytest.raises(ValueError, match="V <= 32"):
        t2.stage2_aggregate_fwd(big, torch.randn((1, 1, 40, 8), device=device), "tile")
    assert t2.launches == before
