"""NTU RGB+D 25-joint skeleton graph (capability parity: reference graph/ntu_rgb_d.py).

24 inward edges toward joint 21 (spine-shoulder), Kinect-v2 layout
(reference graph/ntu_rgb_d.py:9-12).
"""
from __future__ import annotations

import numpy as np

from . import tools

num_node = 25
self_link = [(i, i) for i in range(num_node)]
inward_ori_index = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
    (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
]
inward = [(i - 1, j - 1) for (i, j) in inward_ori_index]
outward = [(j, i) for (i, j) in inward]
neighbor = inward + outward


class Graph:
    """3-partition spatial adjacency, `.A` of shape (3, 25, 25)."""

    def __init__(self, labeling_mode: str = "spatial"):
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
