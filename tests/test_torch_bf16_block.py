"""The bf16 forms of the port's whole eval block (K5's plain version) and
eval multi-scale TCN (T1's) against the JAX Pallas functions, on the CPU.

The JAX side runs `tamgcn_tpu.ops.pallas.gcn_tcn_block.gcn_tcn_block_fused`
and `tools/exp_ms_tcn.py:ms_tcn_fused` in interpret mode on a bfloat16
input (x, the prefix), the other operands float32, all made with numpy from
a seed. Both outputs of each are bfloat16 on both sides, and the port's
plain version is held to the JAX output by the share criterion: at least
99% of each output's elements bit for bit equal, and every element within
2^-8 * max |JAX output| (the plain versions sum in another order than the
interpreter, which flips a bf16 rounding at a near-tie). The criterion can
tell the policy apart: a plain block that rounds x3 to bf16, or one that
leaves the products' operands unrounded, fails it.

The custom op `tamgcn::gcn_tcn_block` takes the bf16 form too: exported by
torch.export, one node of the graph, whose program on the CPU returns the
plain version's bf16 outputs. The JAX tool switches on a persistent XLA
cache and puts a fixed directory first on sys.path when it is imported;
the cache call is patched to a no-op around the import, and sys.path
restored after.
"""
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamgcn_tpu.utils.cache as jax_cache
from tamgcn_tpu.ops.pallas.gcn_tcn_block import gcn_tcn_block_fused as jax_block
from tamgcn_tpu_torch.ops.gcn_tcn_block import (gcn_tcn_block_fused, gcn_tcn_block_plain,
                                                unit_stage1_bf16)
from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_fused, ms_tcn_plain

with mock.patch.object(jax_cache, "enable_compilation_cache", lambda *a, **k: None), \
        mock.patch.object(sys, "path", list(sys.path)):
    from tools import exp_ms_tcn as jax_tool

torch.set_num_threads(1)
SHARE = 0.99  # of the elements bit for bit equal
TOL = 2.0 ** -8  # of max |JAX output|, every element


def _agree(got, want):
    """(share of elements bit for bit equal, max |got - want| / max |want|)
    of two bf16 outputs, got a tensor and want a JAX array."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float((got == want).mean()), float(np.abs(got - want).max() / np.abs(want).max())


def _meets(got, want):
    share, rel = _agree(got, want)
    return share >= SHARE and rel <= TOL


def _block_inputs(n, t, v, cin, c, r, seed):
    """K5's operands in numpy: x rounded to bf16 (as the bf16 model hands
    it), the rest f32; alpha != 0, b4 != 0, a random non-symmetric A, a BN
    affine far from (1, 0), a down conv where cin != c."""
    rs = np.random.RandomState(seed)
    S, P, BC = 3, 3 * c // 4, c // 4

    def w(*shape, fan=4):
        return (rs.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    return dict(
        x=rs.randn(n, t, v, cin).astype(np.float32),
        x1s=rs.randn(n, S, v, r).astype(np.float32),
        x2s=rs.randn(n, S, v, r).astype(np.float32),
        w3=w(cin, S * c, fan=cin), b3=w(S * c), w4s=w(S, r, c, fan=r), b4s=w(S, c),
        alpha=np.asarray([0.7], np.float32), As=rs.rand(S, v, v).astype(np.float32),
        gy=np.stack([1.0 + 0.5 * rs.randn(c), 0.3 * rs.randn(c)]).astype(np.float32),
        wo=w(c, c, fan=c), bo=w(c), wp=w(c, P, fan=c), bp=w(P), wpw=w(c, BC, fan=c),
        bpw=w(BC), wd=None if cin == c else w(cin, c, fan=cin),
        bd=None if cin == c else w(c))


def _torch(args):
    out = {k: None if a is None else torch.from_numpy(a) for k, a in args.items()}
    out["x"] = out["x"].to(torch.bfloat16)
    return out


def _jax(args):
    out = {k: None if a is None else jnp.asarray(a) for k, a in args.items()}
    out["x"] = out["x"].astype(jnp.bfloat16)
    return out


# (N, T, V, Cin, C, R): identity and down residuals at V = 20 and 25
BLOCKS = {
    "identity-V20": (2, 6, 20, 16, 16, 8),
    "down-V20": (2, 6, 20, 8, 16, 4),
    "identity-V25": (2, 4, 25, 16, 16, 8),
    "down-V25": (1, 5, 25, 12, 16, 8),
}


@pytest.fixture(scope="module")
def jax_blocks():
    """{case: (the torch operands, JAX's (prefix, pw))}, each JAX block run
    once in interpret mode."""
    out = {}
    for i, (case, shape) in enumerate(BLOCKS.items()):
        args = _block_inputs(*shape, seed=10 + i)
        out[case] = (_torch(args), jax_block(**_jax(args)))
    return out


@pytest.mark.parametrize("case", list(BLOCKS))
def test_bf16_block_plain_matches_the_jax_kernel(jax_blocks, case):
    args, want = jax_blocks[case]
    got = gcn_tcn_block_plain(**args)
    fused = gcn_tcn_block_fused(**args)  # the custom op on the CPU: the plain version
    for name, g, f, w in zip(("prefix", "pw"), got, fused, want):
        assert g.dtype == f.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert torch.equal(g, f), name
        share, rel = _agree(g, w)
        assert share >= SHARE and rel <= TOL, (name, share, rel)


def _block_unrounded(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp, wpw,
                     bpw, wd=None, bd=None):
    """The block with no product's operands rounded (the f32 block on the
    widened x), its outputs rounded to bf16."""
    prefix, pw = gcn_tcn_block_plain(x.float(), x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy,
                                     wo, bo, wp, bp, wpw, bpw, wd, bd)
    return prefix.to(torch.bfloat16), pw.to(torch.bfloat16)


def _block_x3_rounded(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp, wpw,
                      bpw, wd=None, bd=None):
    """The bf16 form with x3 rounded to bf16 before the aggregation (the
    unit op's bf16 form on a bf16 x3)."""
    def rounded_x3(x1s, x2s, x3, *params):
        return unit_stage1_bf16(x1s, x2s, x3.to(torch.bfloat16).float(), *params)

    return gcn_tcn_block_plain(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wo, bo, wp, bp,
                               wpw, bpw, wd, bd, aggregate=rounded_x3)


@pytest.mark.parametrize("variant", [_block_unrounded, _block_x3_rounded],
                         ids=["products-unrounded", "x3-rounded"])
def test_a_wrong_rounding_policy_fails_the_criterion(jax_blocks, variant):
    """A policy other than the JAX kernel's leaves the share criterion on
    at least one output of the identity block at V = 20."""
    args, want = jax_blocks["identity-V20"]
    got = variant(**args)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert not all(_meets(g, w) for g, w in zip(got, want))


def test_bf16_block_widens_bf16_operands(jax_blocks):
    """x1s, x2s and the parameters in bf16 (exact widening where their
    values are bf16 already) give the outputs of their f32 forms."""
    args, _ = jax_blocks["down-V20"]
    rounded = {k: None if a is None or k == "x" else a.to(torch.bfloat16).float()
               for k, a in args.items()} | {"x": args["x"]}
    halves = {k: None if a is None or k == "x" else a.to(torch.bfloat16)
              for k, a in args.items()} | {"x": args["x"]}
    for a, b in zip(gcn_tcn_block_fused(**rounded), gcn_tcn_block_fused(**halves)):
        assert torch.equal(a, b)


def test_bf16_block_exports_as_one_node():
    """torch.export of a module around the custom op on a bf16 x: one
    tamgcn.gcn_tcn_block node, and its program returns the plain bf16
    outputs."""
    args = _torch(_block_inputs(2, 4, 20, 8, 16, 4, seed=3))

    class Block(torch.nn.Module):
        def forward(self, x):
            return gcn_tcn_block_fused(x, **{k: v for k, v in args.items() if k != "x"})

    program = torch.export.export(Block(), (args["x"],))
    nodes = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert [str(t) for t in nodes if "tamgcn" in str(t)] == ["tamgcn.gcn_tcn_block.default"]
    got = program.module()(args["x"])
    for g, w in zip(got, gcn_tcn_block_plain(**args)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def _t1_operands(n, t, v, bc, seed):
    rs = np.random.RandomState(seed)
    prefix = rs.randn(n, t, v, 3 * bc)
    w = rs.randn(2, 5, bc, bc) * 0.2
    b = rs.randn(2, bc) * 0.1
    mp = np.stack([1.0 + 0.5 * rs.randn(bc), 0.3 * rs.randn(bc)])
    return [np.asarray(a, np.float32) for a in (prefix, w, b, mp)]


# (N, T, V, bc, stride); the Pallas body's reshape needs T % stride == 0
T1_SHAPES = [(2, 8, 20, 8, 1), (2, 8, 20, 8, 2), (2, 6, 25, 4, 1), (1, 8, 25, 12, 2)]


@pytest.mark.parametrize("shape", T1_SHAPES, ids=lambda s: "N{}-T{}-V{}-bc{}-s{}".format(*s))
def test_bf16_ms_tcn_plain_matches_the_jax_kernel(shape):
    n, t, v, bc, stride = shape
    prefix, w, b, mp = _t1_operands(n, t, v, bc, seed=t + v)
    want = jax_tool.ms_tcn_fused(jnp.asarray(prefix).astype(jnp.bfloat16), jnp.asarray(w),
                                 jnp.asarray(b), jnp.asarray(mp), stride=stride)
    args = [torch.from_numpy(prefix).to(torch.bfloat16)] + [torch.from_numpy(a)
                                                           for a in (w, b, mp)]
    got = ms_tcn_plain(*args, stride)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape == (n, t // stride, v, 3 * bc)
    assert torch.equal(ms_tcn_fused(*args, stride), got)
    share, rel = _agree(got, want)
    assert share >= SHARE and rel <= TOL, (share, rel)
    # the output is rounded once: the f32 version on the widened prefix, rounded
    f32 = ms_tcn_plain(args[0].float(), *args[1:], stride)
    assert torch.equal(f32.to(torch.bfloat16), got)


def _bf16_parts(w):
    """w (float32) as three bfloat16 parts hi + mid + lo, each rounded to
    nearest from the remainder of the ones before: T1's bf16 form splits
    its weights so as it stages them (csrc/ms_tcn.cu: split3)."""
    hi = w.to(torch.bfloat16)
    r1 = w - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


@pytest.mark.parametrize("shape", T1_SHAPES[:2], ids=lambda s: "N{}-T{}-V{}-bc{}-s{}".format(*s))
def test_t1_bf16_weight_parts_are_exact(shape):
    """The three bf16 parts of a weight sum back to it exactly, over the
    weights' range and past it (scaled by 2^-100 to 2^50), and each part
    times a bf16 prefix value is exact in f32, so T1's bf16 form fed the
    parts computes the f32 products: the plain version on the three parts'
    sum is ms_tcn_plain's output bit for bit, and the dilated branches
    summed part by part in f64, rounded once to bf16, meet the share
    criterion against it."""
    n, t, v, bc, stride = shape
    prefix, w, b, mp = (torch.from_numpy(a) for a in _t1_operands(n, t, v, bc, seed=7))
    wide = torch.cat([w.flatten(), torch.from_numpy(
        np.random.RandomState(1).randn(4096).astype(np.float32))
        * torch.pow(2.0, torch.arange(-100, 100, 50).float()).repeat(1024)])
    for x in (w.flatten(), wide):
        hi, mid, lo = _bf16_parts(x)
        assert torch.equal((hi.double() + mid.double() + lo.double()).float(), x)
        assert torch.equal(hi.float() + mid.float() + lo.float(), x)
    pb = prefix.to(torch.bfloat16)
    want = ms_tcn_plain(pb, w, b, mp, stride)
    hi, mid, lo = _bf16_parts(w)
    assert torch.equal(ms_tcn_plain(pb, hi.float() + mid.float() + lo.float(), b, mp, stride),
                       want)
    # each part's products exact in f32: the three dilated-branch sums in f64
    zero = torch.zeros_like(b).double()
    convs = sum(ms_tcn_plain(pb.double(), part.double(), zero, mp.double(), stride)[..., :2 * bc]
                for part in (hi, mid, lo))
    got = (convs + b.double().reshape(-1)).to(torch.bfloat16).float()
    branches = want[..., :2 * bc].float()
    assert (got == branches).float().mean().item() >= SHARE
    assert (got - branches).abs().max().item() <= TOL * branches.abs().max().item()
