"""NW-UCLA cross-view split list of the eval path (val: view 3).

The reference embeds the 464 val records verbatim in code
(feeder/feeder_nucla_gcn.py:25); here they live in
tamgcn_tpu_torch/data/splits/nucla_val.json, a copy of the JAX package's
file. The train list (views 1-2) comes with the training slice.
"""
from __future__ import annotations

import json
import os

_HERE = os.path.dirname(__file__)


def load_nucla_split(split: str) -> list[dict]:
    """Return the sample list for 'val': dicts with file_name / length /
    label (1-based labels, as in the reference)."""
    if split == "train":
        raise NotImplementedError("the NW-UCLA train split comes with the training slice")
    if split != "val":
        raise ValueError(f"split must be 'val', got {split!r}")
    path = os.path.join(_HERE, "splits", f"nucla_{split}.json")
    with open(path) as f:
        return json.load(f)
