"""Synthetic skeleton clips from the seed, written in each feeder's file layout.

The real NW-UCLA and NTU-60 skeletons are not in the repository, so a run
writes clips of the datasets' shapes. The clip lengths are fixed for every
seed (NW-UCLA: the lengths its split lists record; NTU-60: a fixed draw over
the configuration's frame range), so every seed gives the host the same
work; the coordinates are drawn from the seed in one call. `Clips` keeps the
arrays exactly as written, for the reference, which reads nothing the
program made.

Layouts:
  * "nucla": `<root>/<name>/<name>.json` {"skeletons": (T, 20, 3)} for every
    name of the split lists in `data/nucla_splits.json`;
  * "skeleton": `<root>/<split>_split.json` ([{"file_name", "label"}]) and
    `<root>/<name>.json` {"skeletons": (T, V, 3) or (T, 2, V, 3)}, the
    two-person clips those of the mutual classes, the coordinates whole
    millimetres.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LENGTH_SEED = 20210723  # the fixed draw of the skeleton layout's clip lengths


@dataclasses.dataclass
class Split:
    names: list
    labels: list  # 0-based
    clips: list  # float64 arrays as written


def _write(path: str, skeleton) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"skeletons": skeleton.tolist()}))


def _nucla(root: str, data: dict, seed: int, splits) -> dict:
    with open(os.path.join(HERE, data["splits"])) as f:
        lists = json.load(f)
    if data.get("limit"):  # the first clips of each split only (the trainer's --debug)
        lists = {split: rows[:data["limit"]] for split, rows in lists.items()}
    lengths = [row[1] for split in ("train", "val") for row in lists[split]]
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, 7]))
    values = rng.normal(size=(sum(lengths), data["num_point"], 3)).round(3)
    out, at = {}, 0
    for split in ("train", "val"):
        split_out = Split([], [], [])
        for name, length, label in lists[split]:
            clip = values[at:at + length]
            at += length
            if split not in splits:
                continue
            os.makedirs(os.path.join(root, name), exist_ok=True)
            _write(os.path.join(root, name, f"{name}.json"), clip)
            split_out.names.append(name)
            split_out.labels.append(label - 1)
            split_out.clips.append(clip)
        out[split] = split_out
    return out


def _skeleton(root: str, data: dict, seed: int, splits) -> dict:
    lo, hi = data["frames"]
    counts = {"train": data["train_clips"], "val": data["val_clips"]}
    fixed = np.random.default_rng(LENGTH_SEED)
    lengths = {s: fixed.integers(lo, hi + 1, size=n) for s, n in counts.items()}
    v, classes, mutual = data["num_point"], data["num_class"], data["mutual_from"]
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, 7]))
    out = {}
    for split, n in counts.items():
        if split not in splits:
            continue
        split_out, records = Split([], [], []), []
        for i in range(n):
            action = i % classes + 1
            persons = 2 if action >= mutual else 1
            shape = ((lengths[split][i], 2, v, 3) if persons == 2
                     else (lengths[split][i], v, 3))
            clip = (1000 * rng.normal(size=shape)).round()
            name = f"S{1 + i // classes:03d}C001P{i:03d}R{1 + (split == 'val')}A{action:03d}"
            _write(os.path.join(root, f"{name}.json"), clip.astype(np.int64))
            records.append({"file_name": name, "label": action})
            split_out.names.append(name)
            split_out.labels.append(action - 1)
            split_out.clips.append(clip)
        with open(os.path.join(root, f"{split}_split.json"), "w") as f:
            json.dump(records, f)
        out[split] = split_out
    return out


def write(root: str, data: dict, seed: int, splits=("train", "val")) -> dict:
    """Write the clips of `splits` of a configuration's `data` section under
    `root`; returns {split: Split}. A clip's values do not depend on which
    splits are written."""
    os.makedirs(root, exist_ok=True)
    return {"nucla": _nucla, "skeleton": _skeleton}[data["layout"]](root, data, seed, splits)
