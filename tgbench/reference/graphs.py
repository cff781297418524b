"""Spatial skeleton graphs of CTR-GCN (the original repository's
graph/ucla.py, graph/ntu_rgb_d.py and graph/tools.py): three partitions,
the identity, the inward edges and the outward edges, each column-normalised
by in-degree. Returns float64 (3, V, V)."""
from __future__ import annotations

import numpy as np

# 1-based (child, parent) edges toward the body's centre
UCLA_INWARD = [
    (1, 2), (2, 3), (4, 3), (5, 3), (6, 5), (7, 6), (8, 7), (9, 3), (10, 9), (11, 10),
    (12, 11), (13, 1), (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18), (20, 19),
]
NTU_INWARD = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7), (9, 21), (10, 9),
    (11, 10), (12, 11), (13, 1), (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
]
GRAPHS = {"ucla": (20, UCLA_INWARD), "ntu_rgb_d": (25, NTU_INWARD)}


def _adjacency(edges, v: int) -> np.ndarray:
    a = np.zeros((v, v))
    for i, j in edges:
        a[j, i] = 1.0
    return a


def _column_normalised(a: np.ndarray) -> np.ndarray:
    degree = a.sum(axis=0)
    scale = np.where(degree > 0, 1.0 / np.where(degree > 0, degree, 1.0), 0.0)
    return a * scale[None, :]


def spatial_graph(name: str) -> np.ndarray:
    """The (3, V, V) spatial adjacency of the graph `name`."""
    v, inward = GRAPHS[name]
    inward0 = [(i - 1, j - 1) for i, j in inward]
    outward0 = [(j, i) for i, j in inward0]
    return np.stack([np.eye(v), _column_normalised(_adjacency(inward0, v)),
                     _column_normalised(_adjacency(outward0, v))])
