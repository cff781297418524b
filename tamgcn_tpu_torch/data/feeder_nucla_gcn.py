"""NW-UCLA skeleton feeder for the GCN model families.

Copy of tamgcn_tpu/data/feeder_nucla_gcn.py (reference
feeder/feeder_nucla_gcn.py:54-154) with its two backends: the numpy path of
`__getitem__`, and the native C++ core (tamgcn_tpu_torch/runtime) behind
`get_batch`, which assembles a whole batch bit for bit as the numpy path
would. `backend` "auto" takes native where the core builds and the output
dtype is float32, else numpy; "native" raises where the core is
unavailable; "numpy" is numpy (`get_batch` returns None, and the loader
assembles the batch sample by sample). JSON skeleton loading
`<data_path>/<name>/<name>.json`, centring on joint 1 of frame 0, the train
split's random 3-D view rotation of +-60 degrees and scale U(0.5, 1.5),
min-max normalisation to [-1, 1], resampling to T=52 (train: sorted random
without replacement; val: linspace), `repeat` oversampling and the
bone/motion modalities. The randomness is an explicit per-sample
np.random.Generator, Philox(key=seed, counter=[0, 0, epoch, index]), so the
train samples equal the JAX feeder's draw for draw.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import transforms as T
from .splits import load_nucla_split

# the train split's augmentation: view rotation of up to +-60 degrees about
# x and y, scale U(0.5, 1.5) (the defaults of
# tamgcn_tpu/data/feeder_nucla_gcn.py:44-45, which no shipped config changes)
ROTATION_DEG = 60
SCALE_RANGE = (0.5, 1.5)


class NUCLAFeederGCN:
    """Map-style dataset yielding (skeleton (3, 52, 20, 1) f32, label, index)."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        modality: str = "joint",  # joint | bone | motion
        repeat: int = 1,
        time_steps: int = 52,
        seed: int = 0,
        debug: bool = False,
        dtype: str = "float32",
        backend: str = "auto",  # auto | native | numpy
        # reference-config compatibility; accepted and unused, like the
        # reference Feeder's random_choose/random_shift/... args for NUCLA
        **_unused,
    ):
        if modality not in ("joint", "bone", "motion"):
            raise ValueError(f"unknown modality {modality!r}")
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown backend {backend!r}: auto, numpy or native")
        self.data_path = data_path
        self.split = split
        self.train = split == "train"
        self.modality = modality
        self.repeat = repeat if self.train else 1
        self.time_steps = time_steps
        self.seed = seed
        self.epoch = 0
        self.dtype = np.dtype(dtype)

        self.data_dict = load_nucla_split(split)
        if debug:
            self.data_dict = self.data_dict[:64]
        self.label = np.array(
            [int(info["label"]) - 1 for info in self.data_dict], np.int32
        )
        self.sample_name = [info["file_name"] for info in self.data_dict]
        self._load_data()

        self._native = False
        if backend in ("auto", "native") and self.dtype == np.float32:
            # the native core emits float32 only
            from .. import runtime

            self._native = runtime.available()
        if backend == "native" and not self._native:
            raise RuntimeError(
                "backend='native': the native augmentation backend is unavailable "
                f"(it needs g++ and dtype float32; dtype {self.dtype})")
        self.backend = "native" if self._native else "numpy"

    def _load_data(self):
        self.data = []
        for info in self.data_dict:
            name = info["file_name"]
            path = os.path.join(self.data_path, name, name + ".json")
            with open(path) as f:
                skeletons = json.load(f)["skeletons"]
            self.data.append(np.asarray(skeletons, np.float64))  # (T, 20, 3)

    def set_epoch(self, epoch: int):
        """Advance the augmentation stream (the Loader calls it each epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.data_dict) * self.repeat

    def __getitem__(self, index: int):
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, self.epoch, index])
        )
        index = index % len(self.data_dict)
        label = int(self.label[index])
        value = self.data[index]

        if self.train:
            agx = int(rng.integers(-ROTATION_DEG, ROTATION_DEG + 1))
            agy = int(rng.integers(-ROTATION_DEG, ROTATION_DEG + 1))
            s = float(rng.uniform(*SCALE_RANGE))
        else:
            agx, agy, s = 0, 0, 1.0

        # center on joint 1 of frame 0 (reference :99-100)
        value = value - value[0:1, 1:2, :]
        value = T.rand_view_transform(value, agx, agy, s)
        value = T.minmax_normalize(value)

        if self.train:
            idx = T.resample_train(value.shape[0], self.time_steps, rng)
        else:
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

    def get_batch(self, indices):
        """The batch of `indices` through the native core (skeletons (B, 3,
        T, 20, 1) float32, labels, sample indices), bit for bit the numpy
        path's samples stacked; None off the native path."""
        if not self._native:
            return None
        from .. import runtime

        indices = np.asarray(indices, np.int64)
        base = indices % len(self.data_dict)
        data = runtime.augment_batch(
            [self.data[i] for i in base],
            indices,
            time_steps=self.time_steps,
            train=self.train,
            modality=self.modality,
            seed=self.seed,
            epoch=self.epoch,
        )
        # labels and indices int64, as the loader's collate of __getitem__
        return data, self.label[base].astype(np.int64), base.astype(np.int64)
