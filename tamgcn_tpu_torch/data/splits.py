"""NW-UCLA cross-view split lists (train: views 1-2, val: view 3).

The reference embeds these 1,020 + 464 sample records verbatim in code
(feeder/feeder_nucla_gcn.py:22,25); here they live in
tamgcn_tpu_torch/data/splits/nucla_{train,val}.json, copies of the JAX
package's files.
"""
from __future__ import annotations

import json
import os

_HERE = os.path.dirname(__file__)


def load_nucla_split(split: str) -> list[dict]:
    """Return the sample list for 'train' or 'val': dicts with file_name /
    length / label (1-based labels, as in the reference)."""
    if split not in ("train", "val"):
        raise ValueError(f"split must be 'train' or 'val', got {split!r}")
    path = os.path.join(_HERE, "splits", f"nucla_{split}.json")
    with open(path) as f:
        return json.load(f)
