"""The port's copies of the JAX package's host-side graph and data helpers,
bit for bit against the originals on seeded inputs.

tamgcn_tpu_torch/graphs/tools.py (get_sgp_mat, get_k_scale_graph,
normalize_adjacency_matrix, k_adjacency, get_multiscale_spatial_graph,
get_uniform_graph) and tamgcn_tpu_torch/data/transforms.py (centralization,
downsample, pose_match, calculate_recall_precision) are the same numpy
operations as tamgcn_tpu's, so they must give the same bits: every case
compares with np.testing.assert_array_equal. The graphs are NW-UCLA's
(V = 20), NTU RGB+D's (V = 25) and the synthetic tree at V = 256, each
package's own copy (their edge lists are checked equal first).
"""
import numpy as np
import pytest

from tamgcn_tpu.data import transforms as jax_transforms
from tamgcn_tpu.graphs import ntu_rgb_d as jax_ntu
from tamgcn_tpu.graphs import synthetic as jax_synthetic
from tamgcn_tpu.graphs import tools as jax_tools
from tamgcn_tpu.graphs import ucla as jax_ucla
from tamgcn_tpu_torch.data import transforms
from tamgcn_tpu_torch.graphs import ntu_rgb_d, synthetic, tools, ucla

GRAPHS = {"ucla": (ucla.Graph, jax_ucla.Graph, {}),
          "ntu": (ntu_rgb_d.Graph, jax_ntu.Graph, {}),
          "synthetic256": (synthetic.Graph, jax_synthetic.Graph, {"num_node": 256})}


def _edges(graph):
    return graph.num_node, graph.self_link, graph.inward, graph.outward, graph.neighbor


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    """(the port's graph, JAX's), their edge lists equal."""
    port_cls, jax_cls, kw = GRAPHS[request.param]
    port, ref = port_cls(**kw), jax_cls(**kw)
    assert _edges(port) == _edges(ref)
    return port, ref


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("with_self, self_factor", [(False, 1), (True, 1), (True, 0.5)],
                         ids=["no_self", "self", "self_half"])
def test_k_adjacency(graph, k, with_self, self_factor):
    port, ref = graph
    for adjacency in (lambda g, t: t.edge2mat(g.inward, g.num_node),
                      lambda g, t: t.edge2mat(g.neighbor, g.num_node)):
        _same(tools.k_adjacency(adjacency(port, tools), k, with_self, self_factor),
              jax_tools.k_adjacency(adjacency(ref, jax_tools), k, with_self, self_factor))


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_get_k_scale_graph(graph, scale):
    port, ref = graph
    _same(tools.get_k_scale_graph(scale, tools.edge2mat(port.neighbor, port.num_node)),
          jax_tools.get_k_scale_graph(scale, jax_tools.edge2mat(ref.neighbor, ref.num_node)))


def test_get_multiscale_spatial_graph(graph):
    port, ref = graph
    got = tools.get_multiscale_spatial_graph(port.num_node, port.self_link, port.inward,
                                             port.outward)
    assert got.shape == (5, port.num_node, port.num_node)
    _same(got, jax_tools.get_multiscale_spatial_graph(ref.num_node, ref.self_link,
                                                      ref.inward, ref.outward))


def test_get_uniform_graph(graph):
    port, ref = graph
    _same(tools.get_uniform_graph(port.num_node, port.self_link, port.neighbor),
          jax_tools.get_uniform_graph(ref.num_node, ref.self_link, ref.neighbor))


def test_normalize_adjacency_matrix(graph):
    """On the graph with its self links (every degree positive)."""
    port, ref = graph
    got = tools.normalize_adjacency_matrix(
        tools.edge2mat(port.neighbor + port.self_link, port.num_node))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _same(got, jax_tools.normalize_adjacency_matrix(
        jax_tools.edge2mat(ref.neighbor + ref.self_link, ref.num_node)))


def test_get_sgp_mat(graph):
    """Pooling onto the joints themselves (self and inward links) and onto
    four groups (joint i into group i % 4)."""
    port, ref = graph
    V = port.num_node
    for num_out, link in ((V, port.self_link + port.inward),
                          (4, [(i, i % 4) for i in range(V)])):
        got = tools.get_sgp_mat(V, num_out, link)
        assert np.isfinite(got).all()
        _same(got, jax_tools.get_sgp_mat(V, num_out, list(link)))


def _swapped_clip():
    """tests/test_data.py's clip: two bodies on straight lines, their slots
    swapped halfway through."""
    rng = np.random.default_rng(0)
    t_len, V = 20, 5
    base = rng.normal(size=(1, 1, V, 1)) * 0.05
    track_a = base + np.stack(
        [np.linspace(0, 1, t_len), np.linspace(0, 0.5, t_len), np.ones(t_len)]
    ).reshape(3, t_len, 1, 1)
    track_b = base + np.stack(
        [np.linspace(5, 4, t_len), np.linspace(2, 2.5, t_len), np.full(t_len, 0.5)]
    ).reshape(3, t_len, 1, 1)
    data = np.concatenate([track_a, track_b], axis=-1)
    swapped = data.copy()
    swapped[:, t_len // 2:] = data[:, t_len // 2:, :, ::-1]
    return swapped


@pytest.mark.parametrize("clip", ["swapped", "random_m2", "random_m4"])
def test_pose_match(clip):
    if clip == "swapped":
        data = _swapped_clip()
    else:
        M = int(clip[-1])
        data = np.random.default_rng(M).normal(size=(3, 30, 25, M))
        data[2] = np.abs(data[2])  # confidences
    got = transforms.pose_match(data)
    _same(got, jax_transforms.pose_match(data))
    if clip == "swapped":  # the identities strung back together
        np.testing.assert_array_equal(got[0, :, 0, 0], np.sort(got[0, :, 0, 0]))


@pytest.mark.parametrize("step", [1, 2, 3, 4])
@pytest.mark.parametrize("seeded", [False, True], ids=["no_rng", "rng"])
def test_downsample(step, seeded):
    data = np.random.default_rng(1).normal(size=(3, 50, 20, 2))
    rng = (lambda: np.random.default_rng(11 + step)) if seeded else (lambda: None)
    got = transforms.downsample(data, step, rng())
    assert got.shape[1] <= -(-50 // step)
    _same(got, jax_transforms.downsample(data, step, rng()))


def test_centralization():
    data = np.random.default_rng(2).normal(size=(3, 40, 20, 2))
    got = transforms.centralization(data)
    assert np.all(got[:, 0, 0, 0] == 0)
    _same(got, jax_transforms.centralization(data))


def test_calculate_recall_precision():
    """Seeded scores over 6 classes: class 4 never predicted, class 5 never
    the label."""
    rng = np.random.default_rng(3)
    score = rng.normal(size=(60, 6))
    score[:, 4] -= 100
    label = rng.integers(0, 5, 60)
    precision, recall = transforms.calculate_recall_precision(label, score)
    assert precision[4] == recall[5] == 0.0 and 0.0 < recall[0] <= 1.0
    want = jax_transforms.calculate_recall_precision(label, score)
    _same(precision, want[0])
    _same(recall, want[1])
