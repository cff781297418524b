"""Skeleton graph definitions (NW-UCLA 20-joint, NTU RGB+D 25-joint).

Numpy copies of ``tamgcn_tpu/graphs``. Graphs are selected by registry
name; dotted paths like "graph.ucla.Graph" from reference configs are also
accepted and mapped onto the registry.
"""
from __future__ import annotations

from . import ntu_rgb_d, synthetic, tools, ucla

_REGISTRY = {
    "ucla": ucla.Graph,
    "ntu_rgb_d": ntu_rgb_d.Graph,
    # parametric random-tree graph for the large-V (scene-graph) regime
    "synthetic": synthetic.Graph,
    # reference config compatibility (config/nucla/gcn.yaml:25 etc.)
    "graph.ucla.Graph": ucla.Graph,
    "graph.ntu_rgb_d.Graph": ntu_rgb_d.Graph,
}


def get_graph(name: str, **graph_args):
    """Instantiate a registered Graph by name. Raises KeyError on unknown name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown graph {name!r}; registered: {sorted(set(_REGISTRY))}"
        ) from None
    return cls(**graph_args)


__all__ = ["tools", "ucla", "ntu_rgb_d", "synthetic", "get_graph"]
