"""NW-UCLA skeleton feeder for the GCN model families: the eval path.

Numpy copy of the val-split pipeline of tamgcn_tpu/data/feeder_nucla_gcn.py
(reference feeder/feeder_nucla_gcn.py:54-154): JSON skeleton loading
`<data_path>/<name>/<name>.json`, centring on joint 1 of frame 0, min-max
normalisation to [-1, 1], linspace resampling to T=52 and the bone/motion
modalities. The train split's augmentation comes with the training slice.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import transforms as T
from .splits import load_nucla_split


class NUCLAFeederGCN:
    """Map-style dataset yielding (skeleton (3, 52, 20, 1) f32, label, index)."""

    def __init__(
        self,
        data_path: str,
        split: str = "val",
        modality: str = "joint",  # joint | bone | motion
        time_steps: int = 52,
        seed: int = 0,
        debug: bool = False,
        dtype: str = "float32",
        # reference-config compatibility; accepted and unused, like the
        # reference Feeder's random_choose/random_shift/... args for NUCLA
        **_unused,
    ):
        if split != "val":
            raise NotImplementedError(
                f"split {split!r}: the port's NW-UCLA feeder has the eval "
                "path only; train augmentation comes with the training slice"
            )
        if modality not in ("joint", "bone", "motion"):
            raise ValueError(f"unknown modality {modality!r}")
        self.data_path = data_path
        self.split = split
        self.modality = modality
        self.time_steps = time_steps
        self.seed = seed
        self.dtype = np.dtype(dtype)

        self.data_dict = load_nucla_split(split)
        if debug:
            self.data_dict = self.data_dict[:64]
        self.label = np.array(
            [int(info["label"]) - 1 for info in self.data_dict], np.int32
        )
        self.sample_name = [info["file_name"] for info in self.data_dict]
        self._load_data()

    def _load_data(self):
        self.data = []
        for info in self.data_dict:
            name = info["file_name"]
            path = os.path.join(self.data_path, name, name + ".json")
            with open(path) as f:
                skeletons = json.load(f)["skeletons"]
            self.data.append(np.asarray(skeletons, np.float64))  # (T, 20, 3)

    def set_epoch(self, epoch: int):
        """Eval samples do not depend on the epoch; kept for the Loader."""

    def __len__(self) -> int:
        return len(self.data_dict)

    def __getitem__(self, index: int):
        label = int(self.label[index])
        value = self.data[index]

        # center on joint 1 of frame 0 (reference :99-100)
        value = value - value[0:1, 1:2, :]
        value = T.rand_view_transform(value, 0, 0, 1.0)
        value = T.minmax_normalize(value)

        idx = T.resample_eval(value.shape[0], self.time_steps)
        data = value[idx]  # (T=52, 20, 3)

        if self.modality == "bone":
            data = T.to_bone(data)
        elif self.modality == "motion":
            data = T.to_motion(data)

        data = np.transpose(data, (2, 0, 1)).reshape(3, self.time_steps, 20, 1)
        # round through f32 first in every dtype mode, as the JAX feeder does
        # (the reference feeder emits f32, reference :154)
        out = data.astype(np.float32).astype(self.dtype)
        return out, label, index
