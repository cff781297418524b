"""Parametric large-V spatial graph (numpy copy of tamgcn_tpu/graphs/synthetic.py).

A seeded random spanning tree over `num_node` vertices with the same
3-partition spatial labeling as the dataset graphs (graphs/tools.py
get_spatial_graph, reference graph/tools.py:38-43); configs/scene256.yaml
names it.
"""
from __future__ import annotations

import numpy as np

from . import tools


class Graph:
    """3-partition spatial adjacency over a seeded random tree,
    `.A` of shape (3, num_node, num_node)."""

    def __init__(
        self,
        labeling_mode: str = "spatial",
        num_node: int = 256,
        seed: int = 0,
    ):
        if num_node < 2:
            raise ValueError(f"num_node must be >= 2, got {num_node}")
        rs = np.random.RandomState(seed)
        self.num_node = num_node
        self.self_link = [(i, i) for i in range(num_node)]
        # random tree: each vertex i >= 1 attaches inward to a uniformly
        # chosen earlier vertex (child -> parent, like the skeleton tables)
        self.inward = [(i, int(rs.randint(0, i))) for i in range(1, num_node)]
        self.outward = [(j, i) for (i, j) in self.inward]
        self.neighbor = self.inward + self.outward
        self.A = self.get_adjacency_matrix(labeling_mode)

    def get_adjacency_matrix(self, labeling_mode: str | None = None) -> np.ndarray:
        if labeling_mode is None:
            return self.A
        if labeling_mode == "spatial":
            return tools.get_spatial_graph(
                self.num_node, self.self_link, self.inward, self.outward
            )
        raise ValueError(f"unknown labeling_mode: {labeling_mode!r}")
