"""The port's eval multi-scale TCN (ops/ms_tcn.py, T1's plain version and
dispatcher) against the JAX tool's, on the CPU.

`ms_tcn_plain` is held against `tools/exp_ms_tcn.py:ms_tcn_xla` (XLA's
convolutions and reduce_window) and against the Pallas `ms_tcn_fused` in
interpret mode, on inputs made with numpy from a seed, f32 on both sides,
within rtol 1e-5 and atol 1e-5 * max|JAX|: each output sums up to 5*bc
terms, in another order in each library. The prefix is all negative, so a
max-pool padded with 0 in place of -inf fails. The Pallas kernel's reshape
needs T % stride == 0, so odd T at stride 2 is held against XLA alone.
The JAX tool switches on a persistent XLA cache and puts a fixed directory
first on sys.path when it is imported; the cache call is patched to a no-op around
the import, and sys.path restored after.
"""
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamgcn_tpu.utils.cache as jax_cache
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, ctrgcn_infer
from tamgcn_tpu_torch.ops import ms_tcn
from tamgcn_tpu_torch.ops.ms_tcn import ms_tcn_fused, ms_tcn_operands, ms_tcn_plain
from tamgcn_tpu_torch.ops.norm import BatchNorm

# the tool puts a fixed directory first on sys.path at import: undone after
with mock.patch.object(jax_cache, "enable_compilation_cache", lambda *a, **k: None), \
        mock.patch.object(sys, "path", list(sys.path)):
    from tools import exp_ms_tcn as jax_tool

torch.set_num_threads(1)
TOL = 1e-5


def _operands(n, t, v, bc, seed=0):
    rs = np.random.RandomState(seed)
    prefix = -np.abs(rs.randn(n, t, v, 3 * bc)) - 0.1
    w = rs.randn(2, 5, bc, bc) * 0.2
    b = rs.randn(2, bc) * 0.1
    mp = np.stack([1.0 + 0.5 * rs.randn(bc), 0.3 * rs.randn(bc)])
    return [np.asarray(a, np.float32) for a in (prefix, w, b, mp)]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


# (N, T, V, bc, stride)
SHAPES = [
    (2, 8, 5, 4, 1), (2, 8, 5, 8, 2), (2, 6, 25, 8, 1), (2, 8, 25, 4, 2),
    (3, 7, 5, 4, 1), (3, 7, 5, 8, 2), (3, 9, 25, 4, 2),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "N{}-T{}-V{}-bc{}-s{}".format(*s))
def test_plain_matches_jax_xla_and_pallas(shape):
    n, t, v, bc, stride = shape
    ops = _operands(n, t, v, bc)
    got = ms_tcn_plain(*map(torch.from_numpy, ops), stride).numpy()
    assert got.shape == (n, -(-t // stride), v, 3 * bc)
    jops = [jnp.asarray(a) for a in ops]
    _close(got, jax_tool.ms_tcn_xla(*jops, stride=stride))
    if t % stride == 0:
        _close(got, jax_tool.ms_tcn_fused(*jops, stride=stride))


def test_max_pool_pads_with_minus_inf():
    """An all-negative prefix: the max-pool's edge frames are the max of
    their two frames inside [0, T), never 0."""
    prefix, w, b, _ = map(torch.from_numpy, _operands(1, 4, 3, 4))
    mp = torch.stack([torch.ones(4), torch.zeros(4)])
    out = ms_tcn_plain(prefix, w, b, mp, 1)[..., 8:]
    want = torch.maximum(prefix[:, :2, :, 8:].max(1).values, prefix[:, 0, :, 8:])
    torch.testing.assert_close(out[:, 0], want, rtol=0, atol=0)
    assert (out < 0).all()


def test_dispatcher_refuses_what_it_does_not_take():
    prefix, w, b, mp = map(torch.from_numpy, _operands(2, 6, 5, 4))
    torch.testing.assert_close(ms_tcn_fused(prefix, w, b, mp, 2),
                               ms_tcn_plain(prefix, w, b, mp, 2), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="meta"):
        ms_tcn_fused(prefix.to("meta"), w, b, mp, 1)
    with pytest.raises(ValueError, match="3\\*bc"):
        ms_tcn_fused(prefix[..., :-1], w, b, mp, 1)
    with pytest.raises(ValueError, match="w has shape"):
        ms_tcn_fused(prefix, w[:, :3], b, mp, 1)
    with pytest.raises(ValueError, match="mp_affine"):
        ms_tcn_fused(prefix, w, b, mp[:1], 1)
    with pytest.raises(ValueError, match="stride 3"):
        ms_tcn_fused(prefix, w, b, mp, 3)


def test_cuda_wrapper_refuses_a_cpu_tensor():
    from tamgcn_tpu_torch.ops.cuda import ms_tcn as t1

    before = t1.launches
    with pytest.raises(ValueError, match="CUDA"):
        t1.ms_tcn_fwd(*map(torch.from_numpy, _operands(1, 4, 5, 4)), 1)
    assert t1.launches == before


def _perturbed_blocks(seed=5):
    """A CTR-GCN at base_channel 8 with every BatchNorm's affine and running
    stats moved off their init values (the fold is invisible at init)."""
    model = create_ctrgcn_nucla(base_channel=8, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.3 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.uniform_(0.5, 2.0, generator=g)
            elif hasattr(m, "alpha"):
                m.alpha.fill_(0.4)
    return model.eval().blocks


@pytest.mark.parametrize("index", [1, 4], ids=["l2-stride1", "l5-stride2"])
def test_engine_branch_half_equals_plain_on_folded_operands(index, monkeypatch):
    """The branch half of `_apply_block(fb, x, use_kernel=False)` equals
    ms_tcn_plain(prefix, *ms_tcn_operands(fb)). The engine adds the residual
    and applies relu, so the block runs without a residual, once as it is
    and once with the branch operands negated: relu(y) - relu(-y) = y."""
    fb = ctrgcn_infer._fold_block(_perturbed_blocks()[index])
    cin = fb["w3"].shape[0]
    x = torch.randn((2, 16, 20, cin), generator=torch.Generator().manual_seed(1))
    prefixes = []
    real = ctrgcn_infer._block_prefix_pw

    def recording(*args):
        out = real(*args)
        prefixes.append(out[0])
        return out

    monkeypatch.setattr(ctrgcn_infer, "_block_prefix_pw", recording)
    plain_fb = dict(fb, res="none")
    neg_fb = dict(plain_fb, mp_scale=-fb["mp_scale"], mp_bias=-fb["mp_bias"],
                  branches=[(pad, dil, -kern, -bias) for pad, dil, kern, bias in fb["branches"]])
    with torch.no_grad():
        pos = ctrgcn_infer._apply_block(plain_fb, x, use_kernel=False)
        neg = ctrgcn_infer._apply_block(neg_fb, x, use_kernel=False)
        want = ms_tcn_plain(prefixes[0], *ms_tcn_operands(fb))
    P = want.shape[-1]
    assert fb["stride"] == (2 if index == 4 else 1)
    assert want.shape == (2, 16 // fb["stride"], 20, P) and want.abs().max() > 0.1
    torch.testing.assert_close(pos[..., :P] - neg[..., :P], want, rtol=TOL,
                               atol=TOL * want.abs().max().item())


def test_operands_refuse_other_branches():
    fb = ctrgcn_infer._fold_block(_perturbed_blocks()[1])
    pad, dil, kern, bias = fb["branches"][1]
    with pytest.raises(ValueError, match="dilations 1 and 2"):
        ms_tcn_operands(dict(fb, branches=[fb["branches"][0], (3, 3, kern, bias)]))
    w, b, mp, stride = ms_tcn_operands(fb)
    assert w.shape == (2, ms_tcn.KS, b.shape[1], b.shape[1]) and stride == 1
    torch.testing.assert_close(w[1, :, :, 0], kern[0, :, :, 0].t(), rtol=0, atol=0)


def test_port_tool_runs_on_the_cpu(monkeypatch, capsys):
    """python -m tamgcn_tpu_torch.tools.exp_ms_tcn --device cpu at small
    shapes: one log line per shape with both times and the error."""
    from tamgcn_tpu_torch.tools import exp_ms_tcn

    monkeypatch.setattr(exp_ms_tcn, "SHAPES", ((2, 8, 5, 16, 1), (3, 7, 5, 20, 2)))
    rows = exp_ms_tcn.main(["--device", "cpu", "--chain", "2", "--iters", "1"])
    err = capsys.readouterr().err
    assert len(rows) == 2 and all(k > 0 and x > 0 and e == 0 for k, x, e in rows)
    assert "T=  7 C= 20 bc=  5 s=2: kernel" in err and "cudnn" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        exp_ms_tcn.main([])
