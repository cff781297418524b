"""Skeleton-graph adjacency construction.

Copies of the functions of tamgcn_tpu/graphs/tools.py (reference
graph/tools.py): those the spatial graphs use (edge2mat :10-14,
normalize_digraph :27-35, get_spatial_graph :38-43) and the pooling,
k-scale, k-hop, multiscale and uniform variants (:3-8, :16-25, :45-79),
which no path of either package calls. Pure numpy; an adjacency is built
once on the host and becomes the model's initial PA.
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


def get_sgp_mat(num_in: int, num_out: int, link: list[Edge]) -> np.ndarray:
    """Column-normalised pooling matrix (reference graph/tools.py:3-8)."""
    A = np.zeros((num_in, num_out))
    for i, j in link:
        A[i, j] = 1
    return A / np.sum(A, axis=0, keepdims=True)


def get_k_scale_graph(scale: int, A: np.ndarray) -> np.ndarray:
    """Binary reachability within `scale` hops (reference graph/tools.py:16-25)."""
    if scale == 1:
        return A
    An = np.zeros_like(A)
    A_power = np.eye(A.shape[0])
    for _ in range(scale):
        A_power = A_power @ A
        An += A_power
    An[An > 0] = 1
    return An


def normalize_adjacency_matrix(A: np.ndarray) -> np.ndarray:
    """Symmetric D^-1/2 A D^-1/2 normalisation (reference graph/tools.py:45-49)."""
    node_degrees = A.sum(-1)
    degs_inv_sqrt = np.power(node_degrees, -0.5)
    norm_degs_matrix = np.eye(len(node_degrees)) * degs_inv_sqrt
    return (norm_degs_matrix @ A @ norm_degs_matrix).astype(np.float32)


def k_adjacency(
    A: np.ndarray, k: int, with_self: bool = False, self_factor: float = 1
) -> np.ndarray:
    """Exact-k-hop adjacency shell (reference graph/tools.py:52-61)."""
    assert isinstance(A, np.ndarray)
    I = np.eye(len(A), dtype=A.dtype)
    if k == 0:
        return I
    Ak = np.minimum(np.linalg.matrix_power(A + I, k), 1) - np.minimum(
        np.linalg.matrix_power(A + I, k - 1), 1
    )
    if with_self:
        Ak += self_factor * I
    return Ak


def get_multiscale_spatial_graph(
    num_node: int, self_link: list[Edge], inward: list[Edge], outward: list[Edge]
) -> np.ndarray:
    """5-partition multiscale graph (reference graph/tools.py:63-74)."""
    I = edge2mat(self_link, num_node)
    A1 = edge2mat(inward, num_node)
    A2 = edge2mat(outward, num_node)
    A3 = k_adjacency(A1, 2)
    A4 = k_adjacency(A2, 2)
    return np.stack(
        (
            I,
            normalize_digraph(A1),
            normalize_digraph(A2),
            normalize_digraph(A3),
            normalize_digraph(A4),
        )
    )


def get_uniform_graph(
    num_node: int, self_link: list[Edge], neighbor: list[Edge]
) -> np.ndarray:
    """Single normalised partition over neighbor+self (reference graph/tools.py:78-80)."""
    return normalize_digraph(edge2mat(neighbor + self_link, num_node))
