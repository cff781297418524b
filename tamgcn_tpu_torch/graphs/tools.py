"""Skeleton-graph adjacency construction.

The functions of tamgcn_tpu/graphs/tools.py that the spatial graphs use
(reference graph/tools.py edge2mat :10-14, normalize_digraph :27-35,
get_spatial_graph :38-43). Pure numpy; an adjacency is built once on the
host and becomes the model's initial PA.
"""
from __future__ import annotations

import numpy as np

Edge = tuple[int, int]


def edge2mat(link: list[Edge], num_node: int) -> np.ndarray:
    """Directed edge list -> adjacency with A[j, i] = 1 for (i, j) in link.

    Matches reference graph/tools.py:10-14 (note the j,i transposition: the
    matrix maps source i -> row of target j).
    """
    A = np.zeros((num_node, num_node))
    for i, j in link:
        A[j, i] = 1
    return A


def normalize_digraph(A: np.ndarray) -> np.ndarray:
    """Column-degree normalisation A @ D^-1 (reference graph/tools.py:27-35)."""
    Dl = np.sum(A, 0)
    w = A.shape[1]
    Dn = np.zeros((w, w))
    for i in range(w):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return np.dot(A, Dn)


def get_spatial_graph(
    num_node: int, self_link: list[Edge], inward: list[Edge], outward: list[Edge]
) -> np.ndarray:
    """Stack (identity, normalised-inward, normalised-outward) partitions.

    Returns float64 array of shape (3, V, V); the 3 subsets are the
    identity / centripetal / centrifugal partitions of ST-GCN spatial labeling
    (reference graph/tools.py:38-43).
    """
    I = edge2mat(self_link, num_node)
    In = normalize_digraph(edge2mat(inward, num_node))
    Out = normalize_digraph(edge2mat(outward, num_node))
    return np.stack((I, In, Out))
