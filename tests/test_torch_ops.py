"""The port's unit CTR-GC op against the JAX package's, on the CPU.

The port's plain `unit_ctr_gc` (the CUDA kernel's plain version) is held
against JAX's XLA path `unit_ctr_gc_xla` and against the Pallas kernel
`unit_ctr_gc_fwd_pallas` in interpret mode (as tests/test_pallas.py runs it
on the CPU), f32 at rtol/atol 2e-5 (the tolerance test_pallas.py uses), on
inputs made with numpy from a seed, with alpha != 0, b4 != 0 and a random A.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu.ops.aggregation import conv3_matmul as jax_conv3_matmul
from tamgcn_tpu.ops.aggregation import unit_ctr_gc_xla
from tamgcn_tpu.ops.pallas.ctr_gc import unit_ctr_gc_fwd_pallas
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops import norm
from tamgcn_tpu_torch.ops.cuda import ctr_gc as port_cuda

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _unit_inputs(n, t, v, c, r, s=3, seed=0):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(n, s, v, r).astype(np.float32),
        rs.randn(n, s, v, r).astype(np.float32),
        rs.randn(n, t, v, s * c).astype(np.float32),
        (rs.randn(s, r, c) * 0.1).astype(np.float32),
        (rs.randn(s, c) * 0.1).astype(np.float32),
        np.asarray([0.7], np.float32),
        rs.rand(s, v, v).astype(np.float32),
    )


def _port(args):
    with torch.no_grad():
        return port.unit_ctr_gc(*(torch.from_numpy(a) for a in args)).numpy()


SHAPES = [
    dict(n=2, t=16, v=20, c=64, r=8),    # l1-l4 widths
    dict(n=2, t=16, v=20, c=128, r=16),  # l6-l7 widths
    dict(n=2, t=13, v=20, c=256, r=32),  # l9-l10 (odd T)
    dict(n=2, t=8, v=25, c=128, r=16),   # NTU joints
    dict(n=1, t=9, v=20, c=80, r=10),    # odd T, ragged widths
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_unit_plain_matches_xla(shape):
    args = _unit_inputs(**shape)
    want = np.asarray(unit_ctr_gc_xla(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(_port(args), want, **TOL)


@pytest.mark.parametrize(
    "shape",
    [dict(n=2, t=13, v=20, c=256, r=32), dict(n=2, t=9, v=20, c=128, r=16)],
    ids=["deep", "odd_t"],
)
def test_unit_plain_matches_pallas_interpret(shape):
    args = _unit_inputs(**shape)
    want = np.asarray(unit_ctr_gc_fwd_pallas(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(_port(args), want, **TOL)


def test_dynamic_term_is_visible():
    """The check above would pass for M = A alone if alpha were 0: make sure
    the refinement changes the output at these inputs."""
    args = list(_unit_inputs(n=1, t=4, v=20, c=64, r=8))
    with_alpha = _port(args)
    args[5] = np.zeros(1, np.float32)
    assert np.abs(with_alpha - _port(args)).max() > 1e-2


@pytest.mark.parametrize("with_bias", [True, False])
def test_dynamic_adjacency_and_aggregate_match_jax(with_bias):
    from tamgcn_tpu.ops import aggregation as jax_agg

    x1, x2, x3s, w4s, b4s, alpha, As = _unit_inputs(n=2, t=7, v=20, c=24, r=8, seed=3)
    args = (x1[:, 0], x2[:, 0], w4s[0], b4s[0] if with_bias else None, alpha, As[0])
    want_m = jax_agg.ctr_gc_dynamic_adjacency(
        *(None if a is None else jnp.asarray(a) for a in args))
    got_m = port.ctr_gc_dynamic_adjacency(
        *(None if a is None else torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    x3 = x3s[..., :24]
    want = jax_agg.ctr_gc_aggregate(want_m, jnp.asarray(x3))
    got = port.ctr_gc_aggregate(got_m, torch.from_numpy(x3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv3_matmul_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 20, 16).astype(np.float32)
    w3 = rs.randn(16, 3 * 24).astype(np.float32)
    b3 = rs.randn(3 * 24).astype(np.float32)
    want = np.asarray(jax_conv3_matmul(jnp.asarray(x), jnp.asarray(w3), jnp.asarray(b3)))
    got = port.conv3_matmul(*(torch.from_numpy(a) for a in (x, w3, b3))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dispatcher_cpu_takes_plain_version():
    args = [torch.from_numpy(a) for a in _unit_inputs(n=1, t=4, v=20, c=64, r=8)]
    before = port_cuda.launches
    got = port.unit_ctr_gc(*args)
    assert port_cuda.launches == before == 0
    torch.testing.assert_close(got, port.unit_ctr_gc_plain(*args), rtol=0, atol=0)


def test_cuda_wrapper_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _unit_inputs(n=1, t=4, v=20, c=64, r=8)]
    with pytest.raises(ValueError, match="CUDA"):
        port_cuda.unit_ctr_gc_fwd(*args)
    assert port_cuda.launches == 0


@pytest.mark.parametrize("moves", [("tiled",), ("whole",), (), ("whole", "tiled")])
def test_launch_counted_takes_the_design_the_launcher_counted(monkeypatch, moves):
    """A wrapper's design counter follows the launch counts the C launcher
    keeps where it launches a kernel: _launch_counted names the one design
    whose count the call moved, and raises where none or both moved."""
    counts = {"whole": 5, "tiled": 7}

    def launch(fn, device, dims, *args, **kwargs):
        for d in moves:
            counts[d] += 1

    monkeypatch.setattr(port_cuda, "_launch", launch)
    fn = port_cuda._launch_counted
    if len(moves) == 1:
        assert fn(counts.get, launch, "cpu", {}) == moves[0]
    else:
        with pytest.raises(RuntimeError, match="counted launches of"):
            fn(counts.get, launch, "cpu", {})


def test_batchnorm_matches_jax_train_and_eval():
    """Eval uses the running stats; train normalises with the biased batch
    variance and accumulates the unbiased one with momentum 0.1."""
    from tamgcn_tpu.ops.norm import BatchNorm as JaxBatchNorm

    rs = np.random.RandomState(2)
    x = rs.randn(4, 3, 5, 8).astype(np.float32) * 2 + 1
    jbn = JaxBatchNorm(momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    params = {"scale": rs.rand(8).astype(np.float32) + 0.5,
              "bias": rs.randn(8).astype(np.float32)}
    stats = {"mean": rs.randn(8).astype(np.float32),
             "var": rs.rand(8).astype(np.float32) + 0.5}
    variables = {"params": params, "batch_stats": stats}

    bn = norm.BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))

    want = jbn.apply(variables, jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        got = bn.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)

    want, mutated = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
    with torch.no_grad():
        got = bn.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), **TOL)
