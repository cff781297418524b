"""NW-UCLA 20-joint skeleton graph (capability parity: reference graph/ucla.py).

Joint indexing (1-based in the edge table, converted to 0-based) follows the
NW-UCLA Kinect-v1 20-joint layout; the 19 inward edges point child -> parent
toward the spine (reference graph/ucla.py:9-12).
"""
from __future__ import annotations

import numpy as np

from . import tools

num_node = 20
self_link = [(i, i) for i in range(num_node)]
inward_ori_index = [
    (1, 2), (2, 3), (4, 3), (5, 3), (6, 5), (7, 6),
    (8, 7), (9, 3), (10, 9), (11, 10), (12, 11), (13, 1),
    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19),
]
inward = [(i - 1, j - 1) for (i, j) in inward_ori_index]
outward = [(j, i) for (i, j) in inward]
neighbor = inward + outward


class Graph:
    """3-partition spatial adjacency, `.A` of shape (3, 20, 20)."""

    def __init__(self, labeling_mode: str = "spatial", scale: int = 1):
        self.num_node = num_node
        self.self_link = self_link
        self.inward = inward
        self.outward = outward
        self.neighbor = neighbor
        self.A = self.get_adjacency_matrix(labeling_mode)

    def get_adjacency_matrix(self, labeling_mode: str | None = None) -> np.ndarray:
        if labeling_mode is None:
            return self.A
        if labeling_mode == "spatial":
            return tools.get_spatial_graph(num_node, self_link, inward, outward)
        raise ValueError(f"unknown labeling_mode: {labeling_mode!r}")
