"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel against its plain PyTorch version on the same inputs, f32 with
TF32 off, K1 and K2 in both of their designs (whole-V and joint-tiled, up to
V=256; the whole-V design also in bf16, two launches bitwise equal, its
block counts against ops/cuda/ctr_gc.py:whole_v_blocks), with the designs'
variant queries and K5's shape rule held to what the launchers run and take: K1 and K2 within rtol 1e-5 and atol 1e-5 * max|plain| (the sum
order differs); K3's gradients are sums of up to N*T*V*V terms taken in
another order, so within rtol 1e-4 and atol 1e-4 * max|plain| (dalpha, one
sum over all N*S*V*V*C terms, within rtol 1e-3). K6's dx within rtol 1e-5
and atol 1e-4 * max|plain| (two products in a row), its dw3 and db3 (sums
over N*T*V rows) within rtol 1e-4 and atol 1e-4 * max|plain|. Also the
wrappers' checks and launch counts, two K3 (and two K5, two K6) launches
bitwise equal, a small CTR-GCN on the card against the same model on the CPU,
forward and gradients, and the standalone CTRGC module through K1 and K2 at
S = 1 against its plain route. The bf16 forms of K1, K2 and K3 (bf16
activations, f32 parameters; both designs of K1 and K2) against their bf16
plain versions: bf16 outputs within 2^-7 of their max |value| (they differ
in f32 sum order before one rounding), K3's f32 outputs at the f32
tolerances, each launch on its own bf16 counter (K3-bf16's also on the
count its C launcher keeps); and the dtypes the wrappers refuse (float16,
mixed activations, bf16 parameters). The bf16 forms of K6 (bf16
activations, its x3 gradient rounded once inside) and of K4 (bf16 x1, x2,
x3, f32 output) against their plain versions: K6-bf16's outputs as
the bf16 outputs above, K4-bf16's f32 outputs within 1e-4 * max|plain|,
two launches of each bitwise equal, each launch on its own counter; and the
standalone CTRGC in bf16 on the card against its plain route. The designs'
variant queries are held to the launches the C launchers count per design
where they launch a kernel (a witness that cannot miss a launch).
The trainer's steps as CUDA graphs (train/graphs.py): the graphed fused
train step equals the eager one bit for bit (deterministic cuDNN), a second
input shape captures a second graph (each capture and replay a span under
a profiler, utils/spans.py), weights written after a capture are
the ones the next replay uses, and a host read inside a step makes the
capture raise; ST-GCN's graphed step equals its eager one bit for bit, and
--debug_nans' finiteness flag replays inside the train step's graph.
ResNet-50 (the RGB family, no port kernel) graphed equals eager bit for bit;
the cross-modal fusion model with its GCN frozen launches K1 10 times per
train step and per eval forward and never K2 or K3, and the GCN's
parameters and BatchNorm statistics stay bit for bit where they were.
The custom ops `tamgcn::unit_ctr_gc` and `tamgcn::gcn_tcn_block` launch K1
and K5; a serving artifact (tools/export_serving.py) launches them at each
call; a graphed train step with dropout draws each replay's mask from the
device step counter. The parallel layer in two gloo processes sharing the
card: the joint ring of the unit op (K1 in every ring step) against the
dense op, and a DP step against the single-rank step with its launches.
The bf16 forms of K5 and T1 (a bf16 x or prefix, bf16 outputs) against
their plain bf16 versions: at least 95% of each output's elements bit for
bit equal and every element within 2^-7 of max |plain|, two launches
bitwise equal, each launch on its bf16 counter; also at their copy edges
(x or the prefix 8-byte but not 16-byte aligned, Cin and bc not multiples
of 8, K5's epilogue at 16 rows with 64-column passes).
This file imports no JAX, so it runs where the port runs.
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
    n, t, v, c, r = shape
    # the counter of the design the launcher takes (whole-V up to V = 24)
    counter = "launches" if ctr_gc.fwd_variant(3, v, r) == "whole" else "launches_tiled"
    before = getattr(ctr_gc, counter)
    with torch.no_grad():
        got = unit_ctr_gc(*args)
        want = unit_ctr_gc_plain(*args)
    torch.cuda.synchronize()
    assert getattr(ctr_gc, counter) == before + 1
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
    assert (ctr_gc.bwd_dx3_launches, ctr_gc.bwd_param_launches) == before
    # V = 64, once refused for shared memory, runs (the joint-tiled designs
    # of K1 and K2) and matches the plain versions
    big = _inputs(1, 2, 64, 64, 8, device=device)
    g_big = torch.randn((1, 2, 64, 64), device=device)
    with torch.no_grad():
        out = ctr_gc.unit_ctr_gc_fwd(*big)
        dx3 = ctr_gc.unit_ctr_gc_bwd_dx3(*big[:2], g_big, *big[3:])
        grads = ctr_gc.unit_ctr_gc_bwd_param(*big[:2], g_big, *big[2:6])
    want = unit_ctr_gc_plain(*big)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    want = unit_ctr_gc_dx3_plain(*big[:2], g_big, *big[3:])
    torch.testing.assert_close(dx3, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    for name, a, w in zip(K3_OUTPUTS, grads,
                          unit_ctr_gc_param_grads_plain(*big[:2], g_big, *big[2:6])):
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


K3_OUTPUTS = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
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
    # the counter of the design the launcher takes (whole-V up to V = 24)
    counter = ("bwd_dx3_launches" if ctr_gc.dx3_variant(3, v, shape[4]) == "whole"
               else "bwd_dx3_tiled_launches")
    before = getattr(ctr_gc, counter)
    got = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
    want = unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
    torch.cuda.synchronize()
    assert getattr(ctr_gc, counter) == before + 1
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
    for name, a, b, w in zip(K3_OUTPUTS, got, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


# the whole-V K1 and K2 (csrc/unit_ctr_gc_whole.cuh), (N, T, V, C, R, S): every
# NW-UCLA block at the training batch 16 and the eval batch 64 (the main
# paths), one subset (the standalone CTRGC's, K4), V = 24 (the design's last
# V; V = 25 takes the joint-tiled one: LARGE_V_SHAPES), the ragged shape
# (odd T, C not a multiple of the 16-channel tile, R < 16) and N = 1
NUCLA_BLOCKS = [(52, 20, 64, 8), (52, 20, 128, 8), (26, 20, 128, 16), (26, 20, 256, 16),
                (13, 20, 256, 32)]
WHOLE_MAIN = [(n,) + b + (3,) for n in (16, 64) for b in NUCLA_BLOCKS]
WHOLE_SHAPES = WHOLE_MAIN + [(16, 52, 20, 128, 8, 1), (4, 26, 24, 128, 16, 3),
                             (3, 7, 20, 80, 10, 3), (1, 13, 20, 256, 32, 3)]
WHOLE_COUNTERS = {torch.float32: ("launches", "bwd_dx3_launches"),
                  torch.bfloat16: ("launches_bf16", "bwd_dx3_launches_bf16")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WHOLE_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-C{}-R{}-S{}".format(*s))
def test_whole_v_kernels_match_plain(device, shape, dtype):
    """K1 and K2 in their whole-V design against their plain versions (f32
    within rtol 1e-5 and atol 1e-5 * max|plain|; bf16 as _bf16_close says),
    two launches of each bitwise equal, each launch on the whole-V counter of
    its form."""
    n, t, v, c, r, s = shape
    x1s, x2s, x3s, w4s, b4s, alpha, As = _inputs(n, t, v, c, r, device=device, s=s)
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    x1s, x2s, x3s, g = (a.to(dtype) for a in (x1s, x2s, x3s, g))
    assert ctr_gc.fwd_variant(s, v, r) == ctr_gc.dx3_variant(s, v, r) == "whole"
    before = _counts()
    with torch.no_grad():
        out = ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)
        out2 = ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)
        dx3 = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        dx3_2 = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        want = unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)
        want_dx3 = unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
    torch.cuda.synchronize()
    moved = {k: m - before[k] for k, m in _counts().items() if m != before[k]}
    assert moved == dict.fromkeys(WHOLE_COUNTERS[dtype], 2), moved
    assert torch.equal(out, out2), "two K1 launches differ"
    assert torch.equal(dx3, dx3_2), "two K2 launches differ"
    for name, got, w in (("out", out, want), ("dx3s", dx3, want_dx3)):
        if dtype == torch.bfloat16:
            _bf16_close(got, w, name)
        else:
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5 * w.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("shape", WHOLE_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-C{}-R{}-S{}".format(*s))
def test_whole_v_blocks_match_the_launchers(device, shape):
    """fwd_blocks and dx3_blocks (the launchers' grids) are
    ops/cuda/ctr_gc.py:whole_v_blocks, at least one block per SM (132) at
    every main-path shape."""
    n, t, v, c, r, s = shape
    k1 = ctr_gc.fwd_blocks(n, s, t, v, r, c)
    k2 = ctr_gc.dx3_blocks(n, s, t, v, r, c)
    assert k1 == ctr_gc.whole_v_blocks(n, s, t, c, fwd=True)
    assert k2 == ctr_gc.whole_v_blocks(n, s, t, c, fwd=False)
    if shape in WHOLE_MAIN:
        assert min(k1, k2) >= 132, (k1, k2)


# past the whole-V designs (V = 25, NTU's joints, the first V they leave to
# the joint-tiled ones), a ragged V (partial joint tiles of 16 and of K3's
# 20), V=64, configs/scene256.yaml's V=256 at its blocks' widths (batch cut
# to 2), and the joint-tiled design's edges: T not a multiple of the frame
# tile (13 of 16; 33 and 40 of 32, a second chunk of 1 and 8 frames), C not
# a multiple of the channel tile (80 of 64, 48 of 32), N = 1
LARGE_V_SHAPES = [
    (4, 26, 25, 128, 16), (2, 7, 37, 80, 10), (2, 9, 64, 64, 8), (2, 32, 256, 64, 8),
    (2, 16, 256, 128, 16), (2, 8, 256, 256, 32),
    (2, 13, 37, 80, 10), (2, 40, 256, 64, 8), (2, 33, 48, 48, 16), (1, 16, 256, 128, 16),
]


@pytest.mark.parametrize("shape", LARGE_V_SHAPES, ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_large_v_kernels_match_plain(device, shape):
    """K1 and K2 take their joint-tiled designs (counted on their own
    counters) and K3 its one design; each within the tolerances above of its
    plain version, and two launches of each bitwise equal."""
    x1s, x2s, x3s, w4s, b4s, alpha, As = args = _inputs(*shape, device=device)
    n, t, v, c, r = shape
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    assert ctr_gc.fwd_variant(3, v, r) == ctr_gc.dx3_variant(3, v, r) == "tiled"
    before = (ctr_gc.launches, ctr_gc.launches_tiled, ctr_gc.bwd_dx3_launches,
              ctr_gc.bwd_dx3_tiled_launches)
    with torch.no_grad():
        out = ctr_gc.unit_ctr_gc_fwd(*args)
        dx3 = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        grads = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
        again = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
    torch.cuda.synchronize()
    assert (ctr_gc.launches, ctr_gc.launches_tiled, ctr_gc.bwd_dx3_launches,
            ctr_gc.bwd_dx3_tiled_launches) == (before[0], before[1] + 1, before[2],
                                               before[3] + 1)
    with torch.no_grad():
        assert torch.equal(ctr_gc.unit_ctr_gc_fwd(*args), out), "two K1t launches differ"
        assert torch.equal(ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As),
                           dx3), "two K2t launches differ"
        want = unit_ctr_gc_plain(*args)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        want = unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
        torch.testing.assert_close(dx3, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        want = unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)
    for name, a, b, w in zip(K3_OUTPUTS, grads, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


# the bf16 forms: the whole-V designs at NW-UCLA and NTU widths, the
# joint-tiled ones at a ragged V, at V=256 and at the design's edges (T of
# 13 and 40, C of 80, N = 1)
BF16_SHAPES = [(4, 13, 20, 256, 32), (4, 52, 20, 64, 8), (3, 9, 25, 128, 16),
               (2, 7, 37, 80, 10), (2, 8, 256, 256, 32), (2, 13, 37, 80, 10),
               (2, 40, 256, 64, 8), (1, 16, 256, 128, 16)]
BF16_COUNTERS = ("launches", "launches_tiled", "bwd_dx3_launches",
                 "bwd_dx3_tiled_launches", "bwd_param_launches", "launches_bf16",
                 "launches_tiled_bf16", "bwd_dx3_launches_bf16",
                 "bwd_dx3_tiled_launches_bf16", "bwd_param_launches_bf16")


def _counts():
    return {k: getattr(ctr_gc, k) for k in BF16_COUNTERS}


def _bf16_close(got, want, name):
    """A bf16 output against its plain version: the two differ only in the
    order of their f32 sums before one rounding, so within 2^-7 of the
    output's max |value|, and equal in all but 1% of the elements (a
    flipped rounding only at a near-tie; a kernel that skips the bf16
    rounding of stage 1's operands changes far more of them)."""
    assert got.dtype == want.dtype == torch.bfloat16, name
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    share = (diff != 0).float().mean().item()
    assert torch.isfinite(got).all() and err <= 2 ** -7 * want.float().abs().max().item(), (
        f"{name}: max |kernel - plain| {err:.3e}")
    assert share <= 0.01, f"{name}: {share:.2%} of the elements differ from plain"


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_bf16_kernels_match_plain(device, shape):
    """K1, K2 and K3 on bf16 activations with f32 parameters (their bf16
    forms, counted on the *_bf16 counters of the design the shape takes and
    on no f32 counter) against the bf16 plain versions: the bf16 outputs
    within 2^-7 of their max |value|, K3's f32 outputs at the f32 tolerances
    above, two K3 launches bitwise equal."""
    x1s, x2s, x3s, w4s, b4s, alpha, As = _inputs(*shape, device=device)
    n, t, v, c, r = shape
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    x1s, x2s, x3s, g = (a.bfloat16() for a in (x1s, x2s, x3s, g))
    tiled = ctr_gc.fwd_variant(3, v, r) == "tiled"
    assert tiled == (ctr_gc.dx3_variant(3, v, r) == "tiled") == (v > 24)
    before = _counts()
    with torch.no_grad():
        out = ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)
        dx3 = ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As)
        grads = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
        again = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in _counts().items() if n != before[k]}
    suffix = "_tiled_bf16" if tiled else "_bf16"
    assert moved == {"launches" + suffix: 1, "bwd_dx3" + ("_tiled" if tiled else "")
                     + "_launches_bf16": 1, "bwd_param_launches_bf16": 2}, moved
    with torch.no_grad():
        if tiled:
            assert torch.equal(ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As),
                               out), "two K1t launches differ"
            assert torch.equal(ctr_gc.unit_ctr_gc_bwd_dx3(x1s, x2s, g, w4s, b4s, alpha, As),
                               dx3), "two K2t launches differ"
        _bf16_close(out, unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As), "out")
        _bf16_close(dx3, unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As), "dx3s")
        want = unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)
    for name, a, b, w in zip(K3_OUTPUTS, grads, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        if name in ("dx1s", "dx2s"):
            _bf16_close(a, w, name)
            continue
        assert a.dtype == torch.float32, name
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


# K3-bf16 (csrc/unit_ctr_gc_bwd_param_bf16.cu, N, T, V, C, R): the NW-UCLA
# train step's blocks at batch 16, and its design's edges: joint tiles of 16
# (one m16 tile of u) and 17 joints, V = 21 in two tiles, 25, 37 and 256;
# C not a multiple of 8 (the staging's one-value loads) and odd; T of one
# frame and past a chunk of 16; N = 1
K3_BF16_SHAPES = [(16, 52, 20, 64, 8), (16, 52, 20, 128, 8), (16, 26, 20, 128, 16),
                  (16, 26, 20, 256, 16), (16, 13, 20, 256, 32), (2, 9, 16, 64, 32),
                  (2, 9, 17, 64, 32), (2, 5, 21, 48, 16), (3, 9, 25, 128, 16),
                  (2, 7, 37, 80, 10), (1, 8, 256, 256, 32), (2, 17, 20, 20, 8),
                  (2, 3, 20, 10, 5), (2, 1, 20, 64, 8), (1, 33, 20, 256, 32)]


@pytest.mark.parametrize("shape", K3_BF16_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_param_bf16_kernel_matches_plain(device, shape):
    """K3-bf16 against its bf16 plain version at the tolerances of
    test_bf16_kernels_match_plain: each call one launch that its C launcher
    counted (ctr_gc.param_bf16_launched) and the wrapper's bf16 counter
    alone; two launches bitwise equal."""
    x1s, x2s, x3s, w4s, b4s, alpha, _ = _inputs(*shape, device=device)
    n, t, v, c, r = shape
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9)).to(device)
    x1s, x2s, x3s, g = (a.bfloat16() for a in (x1s, x2s, x3s, g))
    before, launched = _counts(), ctr_gc.param_bf16_launched()
    with torch.no_grad():
        grads = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
        again = ctr_gc.unit_ctr_gc_bwd_param(x1s, x2s, g, x3s, w4s, b4s, alpha)
        want = unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha)
    torch.cuda.synchronize()
    assert ctr_gc.param_bf16_launched() == launched + 2
    moved = {k: n - before[k] for k, n in _counts().items() if n != before[k]}
    assert moved == {"bwd_param_launches_bf16": 2}, moved
    for name, a, b, w in zip(K3_OUTPUTS, grads, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        if name in ("dx1s", "dx2s"):
            _bf16_close(a, w, name)
            continue
        rtol, atol = (1e-3, 0.0) if name == "dalpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=rtol, atol=atol, msg=name)


def test_bf16_kernels_reject_other_dtypes(device):
    """K1-K3 and K6 take float32 or bfloat16 activations, one dtype for all,
    with float32 parameters; K4's bf16 form bf16 x1, x2 (and x3), an f32 g.
    A refused call counts no launch."""
    x1s, x2s, x3s, w4s, b4s, alpha, As = _inputs(1, 4, 20, 64, 8, device=device)
    g = torch.randn((1, 4, 20, 64), device=device)
    b = [a.bfloat16() for a in (x1s, x2s, x3s, g)]
    before = _counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ctr_gc.unit_ctr_gc_fwd(x1s.half(), x2s.half(), x3s.half(), w4s, b4s, alpha, As)
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc.unit_ctr_gc_fwd(b[0], b[1], x3s, w4s, b4s, alpha, As)
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc.unit_ctr_gc_bwd_dx3(b[0], b[1], g, w4s, b4s, alpha, As)
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc.unit_ctr_gc_bwd_param(b[0], b[1], b[3], x3s, w4s, b4s, alpha)
    with pytest.raises(TypeError, match="w4s .*float32"):
        ctr_gc.unit_ctr_gc_fwd(*b[:3], w4s.bfloat16(), b4s, alpha, As)
    with pytest.raises(TypeError, match="As .*float32"):
        ctr_gc.unit_ctr_gc_bwd_dx3(b[0], b[1], b[3], w4s, b4s, alpha, As.bfloat16())
    with pytest.raises(TypeError, match="alpha .*float32"):
        ctr_gc.unit_ctr_gc_bwd_param(*b[:2], b[3], b[2], w4s, b4s, alpha.bfloat16())
    assert _counts() == before
    args = list(_conv3_inputs(1, 4, 20, 64, 128, 8, device=device))
    conv3_before = ctr_gc.bwd_conv3_launches, ctr_gc.bwd_conv3_launches_bf16
    with pytest.raises(TypeError, match="w4s .*float32"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*[a.bfloat16() for a in args])
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*[a.bfloat16() for a in args[:4]], *args[4:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*[a.half() for a in args[:5]], *args[5:])
    assert (ctr_gc.bwd_conv3_launches, ctr_gc.bwd_conv3_launches_bf16) == conv3_before
    # K4's bf16 form: bf16 x1 and x2, x3 bf16 and g f32, f32 parameters
    x1, x2, w4, b4, A = x1s[:, 0], x2s[:, 0], w4s[0], b4s[0], As[0]
    k4_before = ctr_gc.k4_launches_bf16, ctr_gc.k4_t_launches_bf16
    with pytest.raises(TypeError, match="bfloat16 x1 and x2"):
        ctr_gc.ctr_gc_fused_bf16(x1, x2, g, w4, b4, alpha, A)
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc.ctr_gc_fused_bf16(x1.bfloat16(), x2.bfloat16(), g, w4, b4, alpha, A)
    with pytest.raises(TypeError, match="g .*float32"):
        ctr_gc.ctr_gc_fused_t_bf16(x1.bfloat16(), x2.bfloat16(), b[3], w4, b4, alpha, A)
    with pytest.raises(TypeError, match="w4 .*float32"):
        ctr_gc.ctr_gc_fused_t_bf16(x1.bfloat16(), x2.bfloat16(), g, w4.bfloat16(), b4, alpha,
                                   A)
    assert (ctr_gc.k4_launches_bf16, ctr_gc.k4_t_launches_bf16) == k4_before


@pytest.mark.parametrize("V", [20, 25, 28, 29, 32, 33, 64, 256])
def test_variant_queries_match_the_launchers(device, V):
    """fwd_variant and dx3_variant name the design that K1's and K2's
    launchers (in f32 and bf16) and K4-bf16's (at S = 1) actually launch, at
    every R tier: around a real call, the launches that the C launcher
    counted where it launched a kernel (fwd_launched, dx3_launched,
    fused_launched) move by one for the queried design and not for the
    other, as the wrapper's counter of that design does;
    ops/gcn_tcn_block.py:k5_takes says whether K5's launcher takes the block
    (Cin = C = 16 and 256, P = 3C/4, BC = C/4 as in the model)."""
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
    from tamgcn_tpu_torch.ops.gcn_tcn_block import k5_takes

    for r in (8, 16, 32):
        x1s, x2s, x3s, w4s, b4s, alpha, As = _inputs(1, 2, V, 16, r, device=device)
        g = torch.randn((1, 2, V, 16), device=device)
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            a1, a2, a3, ag = (t.to(dtype) for t in (x1s, x2s, x3s, g))
            for variant, fn, witness, counters in (
                    (ctr_gc.fwd_variant(3, V, r),
                     lambda: ctr_gc.unit_ctr_gc_fwd(a1, a2, a3, w4s, b4s, alpha, As),
                     ctr_gc.fwd_launched, ("launches", "launches_tiled")),
                    (ctr_gc.dx3_variant(3, V, r),
                     lambda: ctr_gc.unit_ctr_gc_bwd_dx3(a1, a2, ag, w4s, b4s, alpha, As),
                     ctr_gc.dx3_launched, ("bwd_dx3_launches", "bwd_dx3_tiled_launches"))):
                counters = dict(zip(("whole", "tiled"), (c + suffix for c in counters)))
                before = {d: (witness(d), getattr(ctr_gc, counters[d])) for d in counters}
                fn()
                torch.cuda.synchronize()
                moved = {d: (witness(d) - w, getattr(ctr_gc, counters[d]) - c)
                         for d, (w, c) in before.items()}
                other = "tiled" if variant == "whole" else "whole"
                assert moved == {variant: (1, 1), other: (0, 0)}, (V, r, dtype, moved)
        # K4-bf16 at S = 1, forward and transpose, on fused_launched
        k1, k2 = (t[:, 0].contiguous().bfloat16() for t in (x1s, x2s))
        k3 = x3s[..., :16].contiguous().bfloat16()
        params = (w4s[0].contiguous(), b4s[0].contiguous(), alpha, As[0].contiguous())
        for transpose, fn, src, counters in (
                (False, ctr_gc.ctr_gc_fused_bf16, k3,
                 ("k4_launches_bf16", "k4_tiled_launches_bf16")),
                (True, ctr_gc.ctr_gc_fused_t_bf16, g,
                 ("k4_t_launches_bf16", "k4_t_tiled_launches_bf16"))):
            variant = (ctr_gc.dx3_variant if transpose else ctr_gc.fwd_variant)(1, V, r)
            counters = dict(zip(("whole", "tiled"), counters))
            before = {d: (ctr_gc.fused_launched(d, transpose), getattr(ctr_gc, counters[d]))
                      for d in counters}
            fn(k1, k2, src, *params)
            torch.cuda.synchronize()
            moved = {d: (ctr_gc.fused_launched(d, transpose) - w, getattr(ctr_gc, counters[d]) - c)
                     for d, (w, c) in before.items()}
            other = "tiled" if variant == "whole" else "whole"
            assert moved == {variant: (1, 1), other: (0, 0)}, (V, r, transpose, moved)
        for C in (16, 256):
            blk = _block_inputs(1, 2, V, C, C, r, device=device)
            if k5_takes(V, C, C, r):
                before = k5.launches
                k5.gcn_tcn_block_fwd(**blk)
                torch.cuda.synchronize()
                assert k5.launches == before + 1
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    k5.gcn_tcn_block_fwd(**blk)


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


# (N, T, V, Cin, C, R): the ten blocks' shapes at a small batch, V=25, ragged,
# and the tensor-core design's edges: N = 1; T not a multiple of the 8-frame
# chunk; Cin not a multiple of the 32-channel x chunk nor of 4 (4-byte
# copies) and C, P not multiples of the 64-column pass (Cin 30, C 48; Cin
# 136, C 144); V = 28; and channel counts whose rows of all channels leave
# the epilogue 32 rows (C 512), 16 rows (C 1024) or the wide design (C 2048)
BLOCK_SHAPES = [
    (4, 52, 20, 3, 64, 8), (4, 52, 20, 64, 64, 8), (4, 52, 20, 64, 128, 8),
    (4, 26, 20, 128, 128, 16), (4, 26, 20, 128, 256, 16), (4, 13, 20, 256, 256, 32),
    (4, 26, 25, 128, 128, 16), (3, 7, 20, 80, 64, 10), (1, 13, 20, 256, 256, 32),
    (3, 7, 20, 30, 48, 10), (2, 9, 20, 136, 144, 16), (2, 13, 28, 64, 128, 16),
    (1, 3, 20, 512, 512, 8), (1, 2, 20, 1024, 1024, 8), (1, 2, 20, 2048, 2048, 8),
]


@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*s))
def test_block_kernel_matches_plain(device, shape):
    """K5 against its plain version within rtol 1e-5 and atol 1e-4 *
    max|plain|: four products in a row, each summing up to 3*C terms in
    another order; two launches bitwise equal."""
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_fused, gcn_tcn_block_plain

    args = _block_inputs(*shape, device=device)
    before = (k5.launches, ctr_gc.launches)
    with torch.no_grad():
        got = gcn_tcn_block_fused(**args)
        again = gcn_tcn_block_fused(**args)
        want = gcn_tcn_block_plain(**args)
    torch.cuda.synchronize()
    assert (k5.launches, ctr_gc.launches) == (before[0] + 2, before[1])
    for name, a, b, w in zip(("prefix", "pw"), got, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4 * w.abs().max().item(), msg=name)


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


# (N, T, V, Cin, C, R): l5-l10 at a small batch, V=25, a ragged shape, and
# the two-phase design's edges: N = 1; rows N*T*V not a multiple of the
# 64-row product tile nor of the 32-row chunk; Cin and S*C not multiples of
# the 64-wide tiles (Cin 136, C 136; Cin 30 takes 4-byte copies); V = 24 at
# R = 32, the whole-V x3 gradient's last V; V = 32 at R = 32, where the x3
# gradient takes the joint-tiled design
CONV3_SHAPES = [
    (4, 52, 20, 64, 128, 8), (4, 26, 20, 128, 128, 16), (4, 26, 20, 128, 256, 16),
    (4, 13, 20, 256, 256, 32), (3, 9, 25, 128, 128, 16), (2, 13, 25, 256, 256, 32),
    (3, 7, 20, 30, 40, 10), (1, 13, 20, 256, 256, 32), (1, 11, 20, 136, 136, 16),
    (2, 9, 32, 64, 128, 32), (2, 9, 24, 64, 128, 32),
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
    with pytest.raises(ValueError, match="R <= 32"):
        ctr_gc.unit_ctr_gc_bwd_conv3(*_conv3_inputs(1, 4, 20, 64, 128, 40, device=device))
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

    # the counters of the designs the launchers take at S = 1 (whole-V up to
    # V = 24)
    r = module.conv4_kernel.shape[2]
    counters = (("launches", "bwd_dx3_launches") if ctr_gc.fwd_variant(1, v, r) == "whole"
                else ("launches_tiled", "bwd_dx3_tiled_launches"))
    assert ctr_gc.dx3_variant(1, v, r) == ctr_gc.fwd_variant(1, v, r)
    before = [getattr(ctr_gc, k) for k in counters]
    out, grads = run()
    torch.cuda.synchronize()
    assert [getattr(ctr_gc, k) for k in counters] == [b + 1 for b in before]
    monkeypatch.setattr(ctrgcn, "ctr_gc_fused", ctr_gc_fused_plain)
    want_out, want = run()
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5 * want_out.abs().max().item())
    for k, w in want.items():
        rtol, atol = (1e-3, 0.0) if k == "alpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(grads[k], w, rtol=rtol, atol=atol, msg=k)


# K6-bf16 besides CONV3_SHAPES: its four train-step blocks at batch 16, a
# Cin that is not a multiple of 8 with S*C = 60 (8-byte copies of the x3
# gradient), in the whole-V and the joint-tiled phase A
K6_BF16_SHAPES = [(16, 52, 20, 64, 128, 8), (16, 26, 20, 128, 128, 16),
                  (16, 26, 20, 128, 256, 16), (16, 13, 20, 256, 256, 32),
                  (2, 9, 20, 61, 20, 8), (2, 9, 25, 61, 20, 8)]


@pytest.mark.parametrize("shape", CONV3_SHAPES + K6_BF16_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*s))
def test_conv3_bf16_kernel_matches_plain(device, shape):
    """K6's bf16 form (bf16 x1s, x2s, g, x, w3; its x3 gradient computed in
    f32 and kept rounded to bf16 for the bf16 products, db3 from the
    unrounded values) against its bf16 plain version: dx, dw3 and db3 in
    bf16 as the bf16 outputs above, two launches bitwise equal, each on the
    bf16 counter alone."""
    from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_bwd_conv3_plain

    x1s, x2s, g, x, w3, w4s, b4s, alpha, As = _conv3_inputs(*shape, device=device)
    args = [a.bfloat16() for a in (x1s, x2s, g, x, w3)] + [w4s, b4s, alpha, As]
    before = ctr_gc.bwd_conv3_launches, ctr_gc.bwd_conv3_launches_bf16
    got = ctr_gc.unit_ctr_gc_bwd_conv3(*args)
    again = ctr_gc.unit_ctr_gc_bwd_conv3(*args)
    want = unit_ctr_gc_bwd_conv3_plain(*args)
    torch.cuda.synchronize()
    assert (ctr_gc.bwd_conv3_launches, ctr_gc.bwd_conv3_launches_bf16) == (
        before[0], before[1] + 2)
    for name, a, b, w in zip(("dx", "dw3", "db3"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, b), f"{name}: two launches differ"
        _bf16_close(a, w, name)


# K4-bf16 (N, T, V, C, R): CTRGC's l5 widths, V = 24 at R = 32 (the whole-V
# design's last V), V = 25 and a ragged V = 37 (the joint-tiled design)
K4_SHAPES = [(4, 52, 20, 128, 8), (2, 13, 24, 64, 32), (3, 9, 25, 64, 16), (1, 7, 37, 40, 10)]


@pytest.mark.parametrize("shape", K4_SHAPES, ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_k4_bf16_kernels_match_plain(device, shape):
    """K4's bf16 form, forward (bf16 x3) and transpose (f32 g), against its
    plain versions: f32 outputs within 1e-4 * max|plain| (an f32 sum order
    apart, or a bf16 tie of D rounded another way), two launches bitwise
    equal, each launch on the counter of its direction and of the design
    the shape takes."""
    from tamgcn_tpu_torch.ops.aggregation import ctr_gc_fused_dx3_plain, ctr_gc_fused_plain

    n, t, v, c, r = shape
    gen = torch.Generator().manual_seed(11)
    x1, x2 = (torch.randn((n, v, r), generator=gen).bfloat16().to(device) for _ in range(2))
    x3 = torch.randn((n, t, v, c), generator=gen).bfloat16().to(device)
    g = torch.randn((n, t, v, c), generator=gen).to(device)
    params = [(torch.randn((r, c), generator=gen) * 0.1).to(device),
              (torch.randn(c, generator=gen) * 0.1).to(device),
              torch.tensor([0.7], device=device), torch.rand((v, v), generator=gen).to(device)]
    tiled = ctr_gc.fwd_variant(1, v, r) == "tiled"
    names = ("k4_launches_bf16", "k4_tiled_launches_bf16", "k4_t_launches_bf16",
             "k4_t_tiled_launches_bf16")
    before = {k: getattr(ctr_gc, k) for k in names}
    for fn, plain, src in ((ctr_gc.ctr_gc_fused_bf16, ctr_gc_fused_plain, x3),
                           (ctr_gc.ctr_gc_fused_t_bf16, ctr_gc_fused_dx3_plain, g)):
        got, again = fn(x1, x2, src, *params), fn(x1, x2, src, *params)
        want = plain(x1, x2, src, *params)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, again), f"{fn.__name__}: two launches differ"
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item(),
                                   msg=fn.__name__)
    moved = {k: getattr(ctr_gc, k) - n for k, n in before.items() if getattr(ctr_gc, k) != n}
    assert moved == ({"k4_tiled_launches_bf16": 2, "k4_t_tiled_launches_bf16": 2} if tiled
                     else {"k4_launches_bf16": 2, "k4_t_launches_bf16": 2}), moved


@pytest.mark.parametrize("shape", [(4, 52, 20, 64, 128), (3, 9, 25, 32, 64)],
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}".format(*s))
def test_ctrgc_bf16_module_on_card_matches_plain_route(device, shape, monkeypatch):
    """CTRGC(dtype="bfloat16") through K4's bf16 form against the same module
    with K4-bf16's plain versions, on the card: the f32 output within 1e-4 *
    max; the gradients behind the kernel's x3 gradient (x, conv3) within
    2^-7 * max (one bf16 rounding of dx3 may flip at a near-tie), the rest
    (plain PyTorch on the same operands in both routes) within rtol 1e-4 and
    atol 1e-4 * max (alpha's within rtol 1e-3)."""
    from tamgcn_tpu_torch.models import CTRGC
    from tamgcn_tpu_torch.ops import aggregation as agg

    n, t, v, cin, c = shape
    gen = torch.Generator().manual_seed(8)
    module = CTRGC(cin, c, generator=gen, dtype="bfloat16")
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

    names = ("k4_launches_bf16", "k4_tiled_launches_bf16", "k4_t_launches_bf16",
             "k4_t_tiled_launches_bf16", "launches", "launches_tiled", "bwd_dx3_launches",
             "bwd_dx3_tiled_launches")
    before = {k: getattr(ctr_gc, k) for k in names}
    out, grads = run()
    torch.cuda.synchronize()
    moved = {k: getattr(ctr_gc, k) - b for k, b in before.items() if getattr(ctr_gc, k) != b}
    design = "_tiled" if ctr_gc.fwd_variant(1, v, module.conv4_kernel.shape[2]) == "tiled" else ""
    assert moved == {f"k4{design}_launches_bf16": 1, f"k4_t{design}_launches_bf16": 1}, moved
    assert out.dtype == torch.float32
    monkeypatch.setattr(agg, "_fused_kernels", lambda device, bf16: (
        agg.ctr_gc_fused_plain, agg.ctr_gc_fused_dx3_plain))
    want_out, want = run()
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-4 * want_out.abs().max().item())
    for k, w in want.items():
        if k in ("x", "conv3.weight", "conv3.bias"):
            rtol, atol = 0.0, 2 ** -7 * w.abs().max().item()
        else:
            rtol, atol = (1e-3, 0.0) if k == "alpha" else (1e-4, 1e-4 * w.abs().max().item())
        torch.testing.assert_close(grads[k], w, rtol=rtol, atol=atol, msg=k)


# T1 (N, T, V, bc, stride): the fast-eval blocks' branch halves at batch 64,
# exp_ms_tcn's NTU-shaped block, and a ragged shape (odd T at stride 2, bc=5);
# the tensor-core design's edges: bc = 128 (two channel slices of 64), odd T
# at stride 2 with bc = 128 and with bc = 5 at stride 1, bc = 200 (slices of
# 32 and blocks of fewer joints than V), V = 600 (joint tiles), T = 1
T1_SHAPES = [
    (64, 52, 20, 16, 1), (64, 52, 20, 32, 2), (64, 26, 20, 32, 1), (64, 26, 20, 64, 2),
    (64, 13, 20, 64, 1), (32, 64, 25, 16, 1), (3, 7, 20, 5, 2),
    (4, 13, 20, 128, 1), (2, 11, 25, 128, 2), (2, 9, 20, 5, 1), (2, 9, 20, 200, 1),
    (1, 7, 600, 16, 2), (3, 1, 20, 24, 2),
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
# the streaming design's edges: V = 32, V = 1, L = C*S = 10 (4-byte copies),
# N*T (21) not a multiple of a warp's row group; the cases (form, subset sum,
# dtype)
T2_SHAPES = [(64, 13, 20, 256, 3), (8, 13, 25, 256, 3), (3, 5, 7, 10, 3),
             (2, 7, 32, 64, 3), (3, 5, 1, 16, 3), (2, 3, 20, 10, 1), (3, 7, 20, 64, 3)]
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


@pytest.mark.parametrize("case", [("tile", torch.float32, 1), ("floor", torch.float32, 1),
                                  ("win", torch.bfloat16, 2), ("floor", torch.bfloat16, 2),
                                  ("tile", torch.bfloat16, 1), ("floor", torch.bfloat16, 1)],
                         ids=lambda c: f"{c[0]}-{str(c[1])[6:]}-offset{c[2]}")
def test_stage2_kernel_takes_unaligned_views(device, case):
    """T2 on m and x3 views whose data_ptr is offset from their storage by
    `offset` elements (4 bytes in f32 and 2 x 2 in bf16: 4-byte but not
    16-byte aligned; 2 bytes in bf16: not even 4-byte aligned), against the
    plain version on the same values and two launches bitwise equal; the
    subset sum on a subset of 12 channels."""
    from tamgcn_tpu_torch.ops.cuda import stage2 as t2
    from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain

    form, dtype, offset = case
    n, t, v, c, s = 3, 5, 20, 12, 3
    g = torch.Generator().manual_seed(11)

    def view(shape, scale):
        numel = 1
        for d in shape:
            numel *= d
        buf = (scale * torch.randn(numel + offset, generator=g)).to(device, dtype)
        return buf[offset:].view(shape)

    m, x3 = view((v, v, s * c), 0.05), view((n, t, v, s * c), 1.0)
    elem = m.element_size()
    assert m.data_ptr() % 16 == x3.data_ptr() % 16 == offset * elem % 16 != 0
    before = t2.launches
    for subset_sum in (False, True):
        with torch.no_grad():
            got = stage2_aggregate(m, x3, form, s, subset_sum)
            again = stage2_aggregate(m, x3, form, s, subset_sum)
            want = stage2_plain(m, x3, form, s, subset_sum)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, again)
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=1e-5 * want.float().abs().max().item())
    assert t2.launches == before + 4


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


# -- the trainer's steps as CUDA graphs (train/graphs.py) ------------------------


def _packed_model(device, seed=4):
    from tamgcn_tpu_torch.train.packing import PackedTrainState

    model = create_ctrgcn_nucla(base_channel=16, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gcn1.alpha"):
                p.fill_(0.5)  # alpha = 0 would hide the aggregation's gradients
    model.to(device).train()
    state = PackedTrainState(model, "SGD")
    state.set_lr(0.05)
    return model, state


def _graph_batch(device, n=4, t=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, 3, t, 20, 1, generator=g).to(device),
            torch.randint(0, 10, (n,), generator=g).to(device))


def test_graphed_train_step_equals_eager_bitwise(device, monkeypatch):
    """Three fused train steps, eager and as a CUDA graph, from the same
    weights on the same batches: losses and every flat buffer (parameters,
    gradients, momentum, BatchNorm statistics) equal bit for bit, with
    cuDNN's deterministic algorithms (with its default ones two eager runs
    differ already)."""
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import make_fused_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = [_graph_batch(device, seed=s) for s in range(3)]
    runs = []
    for capture in (False, True):
        model, state = _packed_model(device)
        step = make_fused_train_step(state)
        if capture:
            step = GraphedStep(step, "train", state.tensors())
        losses = [step(x, y)[0] for x, y in batches]
        runs.append((losses, [t.clone() for t in state.tensors()]))
    (eager_l, eager_t), (graph_l, graph_t) = runs
    assert all(a.equal(b) for a, b in zip(eager_l, graph_l)), (eager_l, graph_l)
    assert all(a.equal(b) for a, b in zip(eager_t, graph_t))


def test_second_input_shape_captures_second_graph(device):
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_eval_step
    from tamgcn_tpu_torch.train import graphs

    model, _ = _packed_model(device)
    model.eval()
    step = graphs.GraphedStep(make_eval_step(model), "eval_shapes")
    with torch.inference_mode():
        for n in (8, 4, 8, 4):
            x, y = _graph_batch(device, n=n, seed=n)
            loss, logits = step(x, y)
            assert logits.shape == (n, 10) and logits.equal(model(x))
    assert len(step.graphs) == 2
    s = graphs.stats["eval_shapes"]
    assert (s.captures, s.replays, s.warmups) == (2, 4, 2 * graphs.WARMUP)


def test_graphed_step_spans_each_capture_and_replay(device):
    """Under a profiler a graphed step marks each capture (its warm-up
    included) and each replay, keyed by the step's name (utils/spans.py)."""
    from torch.profiler import ProfilerActivity, profile

    from tamgcn_tpu_torch.models.ctrgcn_infer import make_eval_step
    from tamgcn_tpu_torch.train import graphs
    from tamgcn_tpu_torch.utils import spans

    model, _ = _packed_model(device)
    model.eval()
    step = graphs.GraphedStep(make_eval_step(model), "eval_spans")
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
            for n in (8, 4, 8):
                step(*_graph_batch(device, n=n, seed=n))
        t = spans.totals()
        assert (t["tamgcn.graph.capture"].count, t["tamgcn.graph.replay"].count) == (2, 3)
        assert {r.ident for r in spans.records()} == {"eval_spans"}
    finally:
        spans.reset()


def test_weights_loaded_after_capture_are_used(device):
    """A graph reads the parameters where they live: load_state_dict (what
    --weights and --resume do) and the optimiser write in place, and the
    next replay computes with what they wrote."""
    from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval, make_fast_eval_step
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import make_fused_train_step

    model, state = _packed_model(device)
    x, y = _graph_batch(device)
    fast = GraphedStep(make_fast_eval_step(model), "fast_eval_weights")
    train = GraphedStep(make_fused_train_step(state), "train_weights", state.tensors())
    other = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    model.eval()
    with torch.inference_mode():
        first = fast(x, y)[1]
    model.train()
    train(x, y)
    model.eval()
    with torch.inference_mode():
        trained = fast(x, y)[1]
        assert trained.equal(make_fast_eval(model)(x)) and not trained.equal(first)
    pointers = [t.data_ptr() for t in state.tensors()]
    model.load_state_dict(other)
    assert [t.data_ptr() for t in state.tensors()] == pointers
    with torch.inference_mode():
        loaded = fast(x, y)[1]
        assert loaded.equal(make_fast_eval(model)(x)) and not loaded.equal(trained)


def test_host_read_in_a_step_raises_at_capture(device):
    """No eager fallback: a step that reads a value back to the host cannot
    be captured, and the capture raises; a good step captures after it."""
    from tamgcn_tpu_torch.train.graphs import GraphedStep

    model, _ = _packed_model(device)
    model.eval()
    x, y = _graph_batch(device)

    def reads_back(x, y):
        logits = model(x)
        if logits.sum().item() > 0:  # a host read
            return (logits,)
        return (-logits,)

    with torch.inference_mode():
        with pytest.raises(RuntimeError):
            GraphedStep(reads_back, "host_read")(x, y)
        torch.cuda.synchronize()
        good = GraphedStep(lambda x, y: (model(x),), "after_host_read")
        assert good(x, y)[0].equal(model(x))


def test_stgcn_graphed_train_step_equals_eager_bitwise(device, monkeypatch):
    """ST-GCN (no port kernel: its aggregation is one einsum) through the
    same packed state and CUDA-graph step: three steps, eager and graphed,
    losses and every flat buffer equal bit for bit with deterministic cuDNN."""
    from tamgcn_tpu_torch.models import create_stgcn_nucla
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = [_graph_batch(device, seed=s) for s in range(3)]
    runs = []
    for capture in (False, True):
        model = create_stgcn_nucla(generator=torch.Generator().manual_seed(2))
        model.to(device).train()
        state = PackedTrainState(model, "SGD")
        state.set_lr(0.05)
        step = make_fused_train_step(state)
        if capture:
            step = GraphedStep(step, "stgcn_train", state.tensors())
        losses = [step(x, y)[0] for x, y in batches]
        runs.append((losses, [t.clone() for t in state.tensors()]))
    (eager_l, eager_t), (graph_l, graph_t) = runs
    assert all(a.equal(b) for a, b in zip(eager_l, graph_l)), (eager_l, graph_l)
    assert all(a.equal(b) for a, b in zip(eager_t, graph_t))


def test_debug_nans_flag_in_a_graphed_step(device):
    """--debug_nans' finiteness flag is part of the graph: true on clean
    weights, false on the replay after a NaN is written into a parameter in
    place; the step without the check returns two outputs."""
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import make_fused_train_step

    model, state = _packed_model(device)
    x, y = _graph_batch(device)
    assert len(make_fused_train_step(state)(x, y)) == 2
    step = GraphedStep(make_fused_train_step(state, check_finite=True), "nan_check",
                       state.tensors())
    assert bool(step(x, y)[2])
    with torch.no_grad():
        model.l3.tcn1.pw_conv.weight[0, 0] = float("nan")
    assert not bool(step(x, y)[2])


def test_resnet_graphed_train_step_equals_eager_bitwise(device, monkeypatch):
    """ResNetOnly (ResNet-50 on cuDNN convs, no port kernel) through the
    packed state and the CUDA-graph step: three steps at 64 x 64, eager and
    graphed, losses and every flat buffer equal bit for bit with
    deterministic cuDNN; no port kernel launched."""
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.cuda import launch_counts
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn(4, 3, 64, 64, generator=g).to(device),
                torch.randint(0, 10, (4,), generator=g).to(device)) for _ in range(3)]
    before = launch_counts()
    runs = []
    for capture in (False, True):
        model = get_model("resnet_only", num_class=10,
                          generator=torch.Generator().manual_seed(2))
        model.to(device).train()
        state = PackedTrainState(model, "SGD")
        state.set_lr(0.05)
        step = make_fused_train_step(state)
        if capture:
            step = GraphedStep(step, "resnet_train", state.tensors())
        losses = [step(x, y)[0] for x, y in batches]
        runs.append((losses, [t.clone() for t in state.tensors()]))
    (eager_l, eager_t), (graph_l, graph_t) = runs
    assert all(a.equal(b) for a, b in zip(eager_l, graph_l)), (eager_l, graph_l)
    assert all(a.equal(b) for a, b in zip(eager_t, graph_t))
    assert launch_counts() == before


def test_cross_modal_frozen_gcn_launches_k1_only(device):
    """The fusion model (full-width CTR-GCN, frozen as configs/nucla/
    cross_modal.yaml freezes it) on the card: a fused train step with the
    `gcn` freeze mask launches K1 10 times and K2, K3 never; so does an eval
    forward; after two steps the GCN's parameters and BatchNorm statistics
    are bit for bit where they started and the rest moved."""
    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.cuda import launch_counts
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    model = get_model("resnet_gcn_attention", num_class=10, num_point=20, num_person=1,
                      graph="ucla", graph_args={"labeling_mode": "spatial"},
                      in_channels_rgb=15, generator=torch.Generator().manual_seed(3))
    model.to(device).train()
    assert not model.gcn.training
    state = PackedTrainState(model, "SGD", freeze_prefixes=("gcn",))
    state.set_lr(0.05)
    step = make_fused_train_step(state)
    gcn0 = {k: v.clone() for k, v in model.gcn.state_dict().items()}
    rest0 = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("gcn.")}
    g = torch.Generator().manual_seed(6)
    keys = ("ctr_gc.launches", "ctr_gc.bwd_dx3_launches", "ctr_gc.bwd_param_launches")
    for _ in range(2):
        x = (torch.randn(4, 3, 52, 20, 1, generator=g).to(device),
             torch.randn(4, 15, 64, 64, generator=g).to(device))
        y = torch.randint(0, 10, (4,), generator=g).to(device)
        before = launch_counts()
        step(*x, y)
        after = launch_counts()
        assert [after[k] - before[k] for k in keys] == [10, 0, 0]
    for k, v in model.gcn.state_dict().items():
        assert v.equal(gcn0[k]), k
    assert any(not v.equal(rest0[k]) for k, v in model.state_dict().items()
               if not k.startswith("gcn."))
    model.eval()
    before = launch_counts()
    with torch.inference_mode():
        model(*x)
    after = launch_counts()
    assert [after[k] - before[k] for k in keys] == [10, 0, 0]


def test_custom_ops_launch_the_kernels(device):
    """tamgcn::unit_ctr_gc and tamgcn::gcn_tcn_block on CUDA tensors launch
    K1 and K5, one count each, bit for bit the wrappers' results; on CPU
    tensors they are the plain versions."""
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_plain

    args = _inputs(2, 16, 20, 64, 8, device)
    before = ctr_gc.launches
    got = torch.ops.tamgcn.unit_ctr_gc(*args)
    assert ctr_gc.launches == before + 1
    assert got.equal(ctr_gc.unit_ctr_gc_fwd(*args))
    cpu = [a.cpu() for a in args]
    assert torch.ops.tamgcn.unit_ctr_gc(*cpu).equal(unit_ctr_gc_plain(*cpu))
    block = _block_inputs(2, 16, 20, 64, 128, 8, device)
    before = gcn_tcn_block.launches
    prefix, pw = torch.ops.tamgcn.gcn_tcn_block(*block.values())
    assert gcn_tcn_block.launches == before + 1
    want = gcn_tcn_block.gcn_tcn_block_fwd(**block)
    assert prefix.equal(want[0]) and pw.equal(want[1])
    cpu = {k: None if a is None else a.cpu() for k, a in block.items()}
    got = torch.ops.tamgcn.gcn_tcn_block(*cpu.values())
    want = gcn_tcn_block_plain(**cpu)
    assert got[0].equal(want[0]) and got[1].equal(want[1])


@pytest.mark.parametrize("extra,counter", [([], "launches"), (["--fast_eval"], None),
                                           (["--poly_batch"], "launches")])
def test_serving_artifact_on_cuda(device, tmp_path, extra, counter):
    """tools/export_serving.py on the card (held on the CPU too, moved there):
    a call of the reloaded artifact launches K1 10 times (K5 with
    --fast_eval) and gives the live model's logits."""
    import os

    from tamgcn_tpu_torch.models import get_model
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block
    from tamgcn_tpu_torch.tools import export_serving
    from tamgcn_tpu_torch.train.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = os.path.join(repo, "configs", "nucla", "smoke.yaml")
    out = str(tmp_path / "a.pt2")
    platforms = "cuda" if extra else "cuda,cpu"
    record = export_serving.run(["--out", out, "--batch", "4", "--time", "16",
                                 "--platforms", platforms, *extra, "-c", smoke,
                                 "--model_args", "base_channel=16"])
    assert record["roundtrip_max_abs_err"] <= 2e-5
    assert set(record["platform_max_abs_err"]) == ({"cpu"} if not extra else set())
    program = torch.export.load(out).module()
    x = torch.randn(4, 3, 16, 20, 1, device=device)
    k1, k5 = ctr_gc.launches, gcn_tcn_block.launches
    with torch.no_grad():
        got = program(x)
    torch.cuda.synchronize()
    if counter:
        assert (ctr_gc.launches - k1, gcn_tcn_block.launches - k5) == (10, 0)
    else:
        assert (ctr_gc.launches - k1, gcn_tcn_block.launches - k5) == (0, 10)
    arg = load_config(["-c", smoke])
    model = get_model(arg.model, generator=torch.Generator().manual_seed(arg.seed),
                      **dict(arg.model_args, base_channel=16)).to(device).eval()
    with torch.no_grad():
        want = model(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_graph_replays_draw_fresh_dropout_masks(device, monkeypatch):
    """The graphed train step of a model with drop_out: each replay's head
    dropout is the seeded mask of the step the device counter holds, two
    replays' masks differ, and the graphed steps equal the eager ones bit
    for bit (deterministic cuDNN)."""
    from tamgcn_tpu_torch.ops.dropout import keep_mask
    from tamgcn_tpu_torch.train.graphs import GraphedStep
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = [_graph_batch(device, seed=s) for s in range(3)]
    runs = []
    for capture in (False, True):
        model = create_ctrgcn_nucla(base_channel=16, drop_out=0.5,
                                    generator=torch.Generator().manual_seed(4))
        model.to(device).train()
        state = PackedTrainState(model, "SGD", seed=9)
        state.set_lr(0.05)
        seen = []

        def hook(module, args, out, seen=seen):
            # buffers made at the first (warm-up) call, written by every call
            # and, inside the capture, by every replay
            if not seen:
                seen.extend([torch.empty_like(args[0]), torch.empty_like(out)])
            seen[0].copy_(args[0].detach())
            seen[1].copy_(out.detach())

        model.dropout.register_forward_hook(hook)
        step = make_fused_train_step(state)
        if capture:
            step = GraphedStep(step, "train", state.tensors())
        losses, masks = [], []
        for k, (x, y) in enumerate(batches):
            losses.append(step(x, y)[0])
            keep = keep_mask(seen[0].shape, 0.5, 9, k, 0, device)
            assert seen[1].equal(torch.where(keep, seen[0] / 0.5, 0.0)), (capture, k)
            masks.append(keep)
        assert int(state.step) == 3 and not masks[0].equal(masks[1])
        runs.append((losses, [t.clone() for t in state.tensors()]))
    (eager_l, eager_t), (graph_l, graph_t) = runs
    assert all(a.equal(b) for a, b in zip(eager_l, graph_l)), (eager_l, graph_l)
    assert all(a.equal(b) for a, b in zip(eager_t, graph_t))


def test_ring_unit_op_on_cuda_in_two_gloo_ranks(device):
    """The joint ring of the unit op (parallel/graph_parallel.py) in two
    gloo processes sharing the card: every ring step is K1 forward and K2, K3
    backward on CUDA tensors (gloo reduces them in place and stages the
    shifts through host memory); the ring's output and VJP against the dense
    plain version (serving.py:UNIT_RTOL: the output within 1e-5 of its max,
    the gradients within 1e-4, alpha's 1e-3) at NW-UCLA block shapes, V = 25
    padded to 26, and scene256's V = 256 (K1t, K2t)."""
    from tamgcn_tpu_torch.parallel.launch import run_ranks
    from tamgcn_tpu_torch.serving import UNIT_RTOL

    shapes = [(8, 52, 20, 64, 8), (8, 13, 20, 256, 32), (4, 16, 25, 128, 16),
              (2, 8, 256, 64, 8)]
    errors = run_ranks("tamgcn_tpu_torch.serving:ring_unit_errors", 2,
                       {"shapes": shapes, "model_axis": 2, "device": "cuda"}, timeout=600)
    for rank_errors in errors:
        for shape, errs in zip(shapes, rank_errors):
            assert all(errs[p] <= UNIT_RTOL[p] for p in errs), (shape, errs)


def test_data_parallel_step_on_cuda_in_two_gloo_ranks(device):
    """One DP (2, 1) train step of a small CTR-GCN on the card in two gloo
    processes equals the single-rank step on the same global batch (loss
    within 1e-5, the updated fc within 1e-4 of its max), and each rank
    launches K1, K2 and K3 10 times on its half of the batch."""
    import numpy as np

    from tamgcn_tpu_torch.parallel.drive import train_on_grid
    from tamgcn_tpu_torch.parallel.launch import run_ranks
    from tamgcn_tpu_torch.serving import UCLA, _perturbed

    args = dict(UCLA, base_channel=16)
    model = create_ctrgcn_nucla(base_channel=16, generator=torch.Generator().manual_seed(1))
    rs = np.random.RandomState(0)
    spec = dict(model="ctrgcn", model_args=args, weights=_perturbed(model, 2),
                batches=[(rs.randn(8, 3, 16, 20, 1).astype(np.float32),
                          rs.randint(0, 10, 8))], device="cuda")
    want = train_on_grid(**spec)
    got = run_ranks("tamgcn_tpu_torch.parallel.drive:train_on_grid", 2,
                    dict(spec, data_parallel=2), timeout=600)
    fc = want["states"][1]["fc.weight"]
    for r in got:
        assert abs(r["losses"][0] - want["losses"][0]) <= 1e-5 * abs(want["losses"][0])
        assert (r["states"][1]["fc.weight"] - fc).abs().max() <= 1e-4 * fc.abs().max()
        for counter in ("ctr_gc.launches", "ctr_gc.bwd_dx3_launches",
                        "ctr_gc.bwd_param_launches"):
            assert r["launches"][counter] == 10, (counter, r["launches"])


def _bf16_criterion(got, want):
    """At least 95% of the elements bit for bit equal, every element within
    2^-7 of max |plain|: the bf16 forms sum in another order than their
    plain versions before one rounding."""
    assert got.dtype == want.dtype == torch.bfloat16
    a, b = got.float(), want.float()
    assert (a == b).float().mean().item() >= 0.95
    assert (a - b).abs().max().item() <= 2.0 ** -7 * b.abs().max().item()


@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*s))
def test_block_kernel_bf16_matches_plain(device, shape):
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_fused, gcn_tcn_block_plain

    args = _block_inputs(*shape, device=device)
    args["x"] = args["x"].to(torch.bfloat16)
    before = (k5.launches, k5.launches_bf16)
    with torch.no_grad():
        got = gcn_tcn_block_fused(**args)
        again = gcn_tcn_block_fused(**args)
        want = gcn_tcn_block_plain(**args)
    torch.cuda.synchronize()
    assert (k5.launches, k5.launches_bf16) == (before[0], before[1] + 2)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _bf16_criterion(a, w)


@pytest.mark.parametrize("shape", T1_SHAPES, ids=lambda s: "N{}-T{}-V{}-bc{}-s{}".format(*s))
def test_ms_tcn_kernel_bf16_matches_plain(device, shape):
    from tamgcn_tpu_torch.ops.cuda import ms_tcn as t1
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_fused, ms_tcn_plain

    args, stride = _t1_inputs(*shape[:4], device=device), shape[4]
    args[0] = args[0].to(torch.bfloat16)
    before = (t1.launches, t1.launches_bf16)
    with torch.no_grad():
        got = ms_tcn_fused(*args, stride)
        again = ms_tcn_fused(*args, stride)
        want = ms_tcn_plain(*args, stride)
    torch.cuda.synchronize()
    assert (t1.launches, t1.launches_bf16) == (before[0], before[1] + 2)
    assert got.shape == want.shape and torch.equal(got, again)
    _bf16_criterion(got, want)


def _misaligned(t, by: int):
    """A contiguous copy of t whose data_ptr lies `by` elements past a
    16-byte boundary of its storage."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = buf[by:].view(t.shape)
    view.copy_(t)
    return view


# the bf16 forms' copy edges: (shape, elements x lies past a 16-byte
# boundary). K5_bf16 pads x in its prologue where its rows are not 16-byte
# copies (8-byte aligned x, Cin = 24 on a down conv); C = 1088 takes the
# epilogue at 16 rows with 64-column passes (one n8 tile a warp)
BF16_EDGE_BLOCKS = [((2, 5, 20, 64, 64, 8), 4), ((2, 7, 20, 24, 64, 8), 4),
                    ((1, 3, 20, 1088, 1088, 8), 0)]
# T1_bf16 stages 8-byte copies at bc = 12, and at bc = 16 on a prefix 8-byte
# but not 16-byte aligned
BF16_EDGE_T1 = [((2, 9, 20, 12, 1), 0), ((2, 9, 20, 16, 2), 4)]


@pytest.mark.parametrize("shape,by", BF16_EDGE_BLOCKS,
                         ids=lambda p: "x{}".format(p) if isinstance(p, int) else
                         "N{}-T{}-V{}-Cin{}-C{}-R{}".format(*p))
def test_block_kernel_bf16_at_its_copy_edges(device, shape, by):
    from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
    from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_plain

    args = _block_inputs(*shape, device=device)
    args["x"] = _misaligned(args["x"].to(torch.bfloat16), by)
    assert args["x"].data_ptr() % 16 == 2 * by
    with torch.no_grad():
        got = k5.gcn_tcn_block_fwd(**args)
        again = k5.gcn_tcn_block_fwd(**args)
        want = gcn_tcn_block_plain(**args)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _bf16_criterion(a, w)


@pytest.mark.parametrize("shape,by", BF16_EDGE_T1,
                         ids=lambda p: "x{}".format(p) if isinstance(p, int) else
                         "N{}-T{}-V{}-bc{}-s{}".format(*p))
def test_ms_tcn_kernel_bf16_at_its_copy_edges(device, shape, by):
    from tamgcn_tpu_torch.ops.cuda import ms_tcn as t1
    from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_plain

    args, stride = _t1_inputs(*shape[:4], device=device), shape[4]
    args[0] = _misaligned(args[0].to(torch.bfloat16), by)
    assert args[0].data_ptr() % 16 == 2 * by
    with torch.no_grad():
        got = t1.ms_tcn_fwd(*args, stride)
        again = t1.ms_tcn_fwd(*args, stride)
        want = ms_tcn_plain(*args, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _bf16_criterion(got, want)
