"""The port's parallel layer, op by op, against the JAX package on the CPU.

  * the three ring ops (parallel/graph_parallel.py: ring_unit_ctr_gc,
    ring_aggregate, ring_aggregate_stgcn), run in k gloo processes
    (tests/_torch_dist_worker.py:ring_ops) at k = 2 and 4, forward and the
    VJP of every input in f64, against tamgcn_tpu/parallel/graph_parallel.py
    on the 8-device CPU mesh: the unit op at V = 20 and at V = 25 (padded to
    a multiple of k) with use_pallas False (the einsum body, within 1e-12)
    and True (the Pallas kernel body, interpret mode, whose products run in
    float32), and the two aggregations (whose JAX rings sum in float32):
    these within 1e-6 of the largest value;
  * the grid (parallel/mesh.py): its errors, the backend rule, the rows a
    data rank takes; the time layout of the sequence-parallel model and the
    halo plan (parallel/comm.py:window_plan); the tensor-parallel rules
    (parallel/sharded.py) against JAX's param_shardings;
  * the step's reduction over a model group of two ranks whose gradients
    differ (parallel/sharded.py:GradientSum): the replicated parameters'
    gradients become the ranks' mean (their sum under SP) on both ranks, so
    the ranks' copies cannot drift apart; the split ones stay each rank's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tamgcn_tpu.parallel import graph_parallel as jax_gp
from tamgcn_tpu.parallel.sharded import DEFAULT_TP_RULES as JAX_TP_RULES
from tamgcn_tpu.parallel.sharded import param_shardings as jax_param_shardings
from tamgcn_tpu_torch.parallel import comm, graph_parallel, mesh as port_mesh
from tamgcn_tpu_torch.parallel.launch import run_ranks
from tamgcn_tpu_torch.parallel.sequence import TimeLayout
from tamgcn_tpu_torch.parallel.sharded import param_shardings

N, T, C, R, S = 2, 3, 8, 4, 3
ENV = {"OMP_NUM_THREADS": "1"}


def _unit_args(rs, V):
    return [rs.randn(N, S, V, R), rs.randn(N, S, V, R), rs.randn(N, T, V, S * C),
            rs.randn(S, R, C) * 0.1, rs.randn(S, C) * 0.1, np.array([0.3]),
            rs.rand(S, V, V) * 0.1]


def _cases(seed):
    """(op, inputs, cotangent) of every case, f64."""
    rs = np.random.RandomState(seed)
    cases = []
    for V in (20, 25):
        args = _unit_args(rs, V)
        cases.append(("ring_unit_ctr_gc", args, rs.randn(N, T, V, C)))
    cases.append(("ring_aggregate", [rs.randn(N, T, 20, 5), rs.rand(20, 20)],
                  rs.randn(N, T, 20, 5)))
    cases.append(("ring_aggregate_stgcn", [rs.randn(N, T, 20, 3, 5), rs.rand(3, 20, 20)],
                  rs.randn(N, T, 20, 5)))
    return cases


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ringed(request):
    """(k, the cases, the port's results on rank 0 and the rest)."""
    k = request.param
    cases = _cases(seed=k)
    results = run_ranks("tests._torch_dist_worker:ring_ops", k, {"cases": cases},
                        timeout=240, env=ENV)
    return k, cases, results


def _jax(name, mesh, use_pallas):
    fns = {
        "ring_unit_ctr_gc": lambda *a: jax_gp.ring_unit_ctr_gc(*a, mesh=mesh,
                                                               use_pallas=use_pallas),
        "ring_aggregate": lambda x, A: jax_gp.ring_aggregate(x, A, mesh),
        "ring_aggregate_stgcn": lambda x, A: jax_gp.ring_aggregate_stgcn(x, A, mesh),
    }
    fn = fns[name]

    @jax.jit
    def run(args, cot):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(cot)

    return run


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case,use_pallas", [
    (0, False), (0, True), (1, False), (1, True), (2, False), (3, False),
], ids=["unit_v20_einsum", "unit_v20_pallas", "unit_v25_einsum", "unit_v25_pallas",
        "aggregate", "aggregate_stgcn"])
def test_ring_op_matches_jax(ringed, x64, case, use_pallas):
    k, cases, results = ringed
    name, inputs, cot = cases[case]
    mesh = Mesh(np.asarray(jax.devices()[:k]).reshape(1, k), ("data", "model"))
    with mesh:
        y, grads = _jax(name, mesh, use_pallas)([jnp.asarray(a) for a in inputs],
                                                 jnp.asarray(cot))
    # the Pallas body's products, and the JAX aggregation rings' sums
    # (preferred_element_type float32), are float32 inside
    tol = 1e-6 if use_pallas or name != "ring_unit_ctr_gc" else 1e-12
    for rank, result in enumerate(results):
        got_y, got_grads = result[case]
        np.testing.assert_allclose(got_y, np.asarray(y), rtol=tol,
                                   atol=tol * float(np.abs(y).max()),
                                   err_msg=f"{name} out, rank {rank}")
        for i, (g, w) in enumerate(zip(got_grads, grads)):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * float(np.abs(w).max()),
                                       err_msg=f"{name} d(input {i}), rank {rank}")


def test_ring_rejects_an_indivisible_joint_axis():
    group = comm.Group(ranks=(0, 1, 2, 3), rank=0)
    with pytest.raises(ValueError, match="joint axis 10 not divisible by mesh axis 4"):
        graph_parallel.shard_joints(torch.zeros(2, 3, 10, 8), group)
    # the unit op pads instead (V = 25 above); a group of one is the dense op
    x = torch.randn(2, 3, 6, 4, dtype=torch.float64)
    A = torch.rand(6, 6, dtype=torch.float64)
    torch.testing.assert_close(graph_parallel.ring_aggregate(x, A, comm.SOLO),
                               torch.einsum("uv,...vc->...uc", A, x))


def test_make_mesh_errors_name_the_numbers_and_the_launcher():
    assert port_mesh.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="torch.distributed.run"):
        port_mesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="model_parallel=2 must divide 1 ranks"):
        port_mesh.make_mesh(1, 2)
    with pytest.raises(ValueError, match="data_parallel"):
        port_mesh.make_mesh(0, 1)


def test_backend_rule():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert port_mesh.backend_for([cpu, cpu]) == "gloo"
    assert port_mesh.backend_for([c0, c1]) == "nccl"
    assert port_mesh.backend_for([c0, c0]) == "gloo"  # NCCL refuses a shared card


def test_rank_devices_take_one_device_entry_per_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert port_mesh.rank_devices(True, [0, 0]) == [torch.device("cuda", 0)] * 2
    assert port_mesh.rank_devices(False, 0) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="one entry per local rank"):
        port_mesh.rank_devices(True, [0])


def test_data_slice_and_shard_batch():
    grid = types.SimpleNamespace(shape={"data": 4, "model": 2}, data_index=2)
    assert port_mesh.data_slice(16, grid) == slice(8, 12)
    with pytest.raises(ValueError, match="batch 6 must be divisible by data_parallel=4"):
        port_mesh.data_slice(6, grid)
    x = np.arange(16)
    (got,) = port_mesh.shard_batch(grid, x)
    np.testing.assert_array_equal(got, [8, 9, 10, 11])


def test_time_layout_gives_each_output_frame_to_its_centre_frames_rank():
    lay = TimeLayout((0, 26, 52))
    assert lay.strided(2).starts == (0, 13, 26)
    assert lay.strided(2).strided(2).starts == (0, 7, 13)  # 13 frames: 7 + 6
    # the ranks' outputs of a stride-2 op partition ceil(T / 2) frames
    lay = TimeLayout((0, 5, 9, 16))
    assert lay.strided(3).starts == (0, 2, 3, 6)


def test_window_plan_fetches_the_halo_and_pads_outside_the_clip():
    # frames [0, 4) and [4, 8); each rank's window of a k=5, pad 2 conv
    plan = comm.window_plan((0, 4, 8), [(-2, 6), (2, 10)])
    assert plan.out_len == (8, 8)
    # (src, dst, lo, hi, at): rank 0 takes its own 4 and rank 1's first 2
    assert set(plan.pieces) == {(0, 0, 0, 4, 2), (1, 0, 0, 2, 6),
                                (0, 1, 2, 4, 0), (1, 1, 0, 4, 2)}
    # a halo wider than a neighbour's frames reaches two ranks away
    plan = comm.window_plan((0, 1, 2, 3, 4), [(-4, 5), (0, 0), (0, 0), (0, 0)])
    assert {p[0] for p in plan.pieces} == {0, 1, 2, 3}


def test_tensor_parallel_rules_match_jax():
    from tamgcn_tpu_torch.models import ResNetGCNAttention, create_ctrgcn_nucla

    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    for model in (create_ctrgcn_nucla(base_channel=8),
                  ResNetGCNAttention(graph="ucla", graph_args={"labeling_mode": "spatial"})):
        dims = param_shardings(model)
        from tamgcn_tpu_torch.convert import flax_param_paths

        paths = flax_param_paths(model)
        tree = {}
        for name, p in model.named_parameters():
            node = tree
            *parents, leaf = paths[name].split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = np.zeros(tuple(reversed(p.shape)) if p.ndim == 2 else p.shape)
        specs = jax_param_shardings(jmesh, tree, JAX_TP_RULES)
        for name, p in model.named_parameters():
            node = specs
            for key in paths[name].split("/"):
                node = node[key]
            spec = tuple(node.spec)
            want = None
            if "model" in spec:
                axis = spec.index("model")
                want = (p.ndim - 1 - axis) if p.ndim == 2 else axis
            assert dims[name] == want, name
        assert dims.get("fc.weight", 0) == 0


@pytest.mark.parametrize("sequence_parallel", [False, True], ids=["mean", "sp_sum"])
def test_gradient_sum_makes_the_model_groups_replicated_gradients_one(sequence_parallel):
    ranks = run_ranks("tests._torch_dist_worker:gradient_sum", 2,
                      {"sequence_parallel": sequence_parallel}, timeout=120, env=ENV)
    split = ranks[0][1]
    assert split == ["fc.bias", "fc.weight"]
    for rank, (grads, _) in enumerate(ranks):
        for name, g in grads.items():
            want = rank + 1.0 if name in split else (3.0 if sequence_parallel else 1.5)
            assert torch.all(g == want), (rank, name, g.flatten()[:3])
