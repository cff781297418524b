"""The port's stage-2 aggregation (ops/stage2.py, T2's plain versions and
dispatcher) against the JAX tools' Pallas bodies, on the CPU.

Each form's plain version is held against its Pallas body in
tools/exp_stage2.py and tools/exp_stage2b.py, run in interpret mode with
the tools' module sizes (N, T, V, C, S) patched small, and against a numpy
einsum oracle with M written out per index rule. Inputs are made with numpy
from a seed. f32 within rtol 1e-5 and atol 1e-5 * max|want|: sums of V
terms (S*V with the subset sum) taken in another order. The stage2b tile on
bf16 operands: the Pallas body multiplies and adds in bf16, rounding each
of its V partial sums to 8 significant bits, the plain version sums in f32
and rounds once, so they agree within 2.5e-2 * max|want| (V = 5 terms of
2^-8 each, and a margin); the plain version itself is held to the f32 sum
rounded once, exactly. The JAX tools switch on a persistent XLA cache and
put a fixed directory first on sys.path when they are imported; the cache call
is patched to a no-op around the imports, and sys.path restored after.
"""
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamgcn_tpu.utils.cache as jax_cache
from tamgcn_tpu_torch.ops import stage2
from tamgcn_tpu_torch.ops.stage2 import stage2_aggregate, stage2_plain

# the tools put a fixed directory first on sys.path at import: undone after
with mock.patch.object(jax_cache, "enable_compilation_cache", lambda *a, **k: None), \
        mock.patch.object(sys, "path", list(sys.path)):
    from tools import exp_stage2 as jax_stage2
    from tools import exp_stage2b as jax_stage2b

torch.set_num_threads(1)
N, T, V, C, S = 2, 3, 5, 8, 3
SC = S * C
TOL = 1e-5


@pytest.fixture
def small(monkeypatch):
    """The JAX tools' module sizes set small; returns (md, x3) as numpy."""
    for mod in (jax_stage2, jax_stage2b):
        for name, value in dict(N=N, T=T, V=V, C=C, S=S, SC=SC).items():
            monkeypatch.setattr(mod, name, value)
    rs = np.random.RandomState(3)
    return (np.asarray(rs.randn(V, V, SC) * 0.5, np.float32),
            np.asarray(rs.randn(N, T, V, SC), np.float32))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("nacc,bn", [(1, 1), (2, 1), (1, 2)], ids=["nacc1", "nacc2", "bn2"])
def test_tile_matches_pallas(small, nacc, bn):
    md, x3 = small
    want = jax_stage2.make_tile(8, nacc=nacc, bn=bn)(jnp.asarray(md), jnp.asarray(x3))
    _close(stage2_plain(*_t(md, x3), "tile").numpy(), want)


def test_win_matches_pallas(small):
    md, x3 = small
    _close(stage2_plain(*_t(md, x3), "win").numpy(),
           jax_stage2.win_call(jnp.asarray(md), jnp.asarray(x3)))


@pytest.mark.parametrize("nacc", [1, 4])
def test_floor_matches_pallas(small, nacc):
    md, x3 = small
    _close(stage2_plain(*_t(md, x3), "floor").numpy(),
           jax_stage2.make_floor(nacc)(jnp.asarray(md), jnp.asarray(x3)))


@pytest.mark.parametrize("subset_sum", [True, False], ids=["ss", "no-ss"])
def test_flat_matches_pallas(small, subset_sum):
    md, x3 = small
    mdflat, x3flat = md.reshape(V, V * SC), x3.reshape(N, T, V * SC)
    want = jax_stage2.flat_call(jnp.asarray(mdflat), jnp.asarray(x3flat), subset_sum=subset_sum)
    got = stage2_plain(*_t(mdflat, x3flat), "flat", S, subset_sum).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage2b_tile_matches_pallas(small, dtype):
    md, x3 = small
    want = jax_stage2b.make_tile(8, 2, getattr(jnp, dtype))(jnp.asarray(md), jnp.asarray(x3))
    m, x = (t.to(getattr(torch, dtype)) for t in _t(md, x3))
    got = stage2_plain(m, x, "tile")
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           TOL if dtype == "float32" else 2.5e-2)


def _oracle(md, x3, rule):
    """out[n,t,u,l] = sum_j M[j,u,l] x3[n,t,v(j,u),l] with M written out as
    (u, v) pairs, in numpy f64."""
    m_uv = np.zeros((V, V, md.shape[-1]))
    for j in range(V):
        for u in range(V):
            v = {"tile": j, "win": (u + j) % V, "floor": u}[rule]
            m_uv[u, v] += md[j, u]
    return np.einsum("uvl,ntvl->ntul", m_uv, x3.astype(np.float64))


@pytest.mark.parametrize("form,subset_sum", [
    ("tile", False), ("win", False), ("floor", False), ("flat", False), ("flat", True),
    ("tile", True),
], ids=["tile", "win", "floor", "flat", "flat-ss", "tile-ss"])
def test_forms_match_einsum_oracle(small, form, subset_sum):
    md, x3 = small
    want = _oracle(md, x3, "win" if form == "flat" else form)
    if subset_sum:
        want = want.reshape(N, T, V, S, C).sum(3)
    m, x = (md.reshape(V, -1), x3.reshape(N, T, -1)) if form == "flat" else (md, x3)
    got = stage2_aggregate(*_t(m, x), form, S, subset_sum).numpy()
    _close(got.reshape(want.shape), want)
    # the dispatcher's CPU branch is the plain version
    np.testing.assert_array_equal(got, stage2_plain(*_t(m, x), form, S, subset_sum).numpy())


def test_bf16_is_rounded_once(small):
    md, x3 = small
    m, x = (t.bfloat16() for t in _t(md, x3))
    for form in ("tile", "win", "floor"):
        for ss in (False, True):
            got = stage2_aggregate(m, x, form, S, ss)
            want = stage2_aggregate(m.float(), x.float(), form, S, ss).bfloat16()
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, want), (form, ss)


def test_dispatcher_refuses_what_it_does_not_take(small):
    m, x = _t(*small)
    with pytest.raises(ValueError, match="unknown form"):
        stage2_aggregate(m, x, "roll")
    with pytest.raises(NotImplementedError, match="meta"):
        stage2_aggregate(m.to("meta"), x.to("meta"), "tile")
    with pytest.raises(ValueError, match="M has shape"):
        stage2_aggregate(m[:, :, :-1], x, "tile")
    with pytest.raises(TypeError, match="match"):
        stage2_aggregate(m.double(), x, "win")
    with pytest.raises(ValueError, match="L % S"):
        stage2_aggregate(m, x, "floor", S=5, subset_sum=True)
    with pytest.raises(ValueError, match="flat form"):
        stage2_aggregate(m, x, "flat")
    assert stage2.diag_to_vu(m)[(2 + 3) % V, 2].equal(m[3, 2])


def test_cuda_wrapper_refuses_a_cpu_tensor(small):
    from tamgcn_tpu_torch.ops.cuda import stage2 as t2

    m, x = _t(*small)
    before = t2.launches
    with pytest.raises(ValueError, match="CUDA"):
        t2.stage2_aggregate_fwd(m, x, "tile")
    with pytest.raises(ValueError, match="unknown rule"):
        t2.stage2_aggregate_fwd(m, x, "win")
    assert t2.launches == before


@pytest.mark.parametrize("tool", ["exp_stage2", "exp_stage2b"])
def test_port_tool_runs_on_the_cpu(tool, monkeypatch, capsys):
    """The port's tool at the small sizes with --device cpu: every variant
    name of the JAX tool is logged with a time, and the flat numerics hold."""
    import importlib

    mod = importlib.import_module(f"tamgcn_tpu_torch.tools.{tool}")
    for name, value in dict(N=N, T=T, V=V, C=C, R=4, S=S, SC=SC).items():
        monkeypatch.setattr(mod, name, value)
    times = mod.main(["--device", "cpu", "--chain", "2", "--iters", "1"])
    err = capsys.readouterr().err
    if tool == "exp_stage2":
        names = ["bcast", "roll", *(n for n, _ in mod.PROBES), "flat(ss=1)", "flat(ss=0)"]
        assert times["flat_rel_err"] < 1e-5
        assert "flat numerics vs oracle" in err
    else:
        names = [n for n, _ in mod.CANDIDATES]
        assert all(len(times[n]) == mod.REPS for n in names)
    for name in names:
        assert name in times and name in err


def test_port_tool_needs_cuda_or_cpu_flag(monkeypatch):
    from tamgcn_tpu_torch.tools import exp_stage2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        exp_stage2.main([])
