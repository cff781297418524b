"""Generic JSON-skeleton feeder: any joint count and person count (NTU-60, ...).

Copy of tamgcn_tpu/data/feeder_skeleton_gcn.py, the NW-UCLA feeder's
per-sample pipeline generalised over (V, M):

  * dataset layout: `<data_path>/<split>_split.json`, a list of
    `{"file_name": ..., "label": <1-based int>}` records, and per-sample
    skeletons at `<data_path>/<name>/<name>.json` or `<data_path>/<name>.json`
    holding `{"skeletons": (T, V, 3) | (T, M, V, 3)}`;
  * pipeline: center on `center_joint` of frame 0 (person 0), random 3-D
    view rotation and scale (train), per-sample min-max normalisation to
    [-1, 1], temporal resample (train: sorted random without replacement;
    eval: linspace), bone/motion modalities with the bone table chosen by
    joint count (NW-UCLA 20, NTU 25);
  * output: (3, time_steps, V, num_person) float32; persons padded with
    zeros, or the `num_person` with the most motion energy kept.

`backend` "auto" takes the native core (tamgcn_tpu_torch/runtime, batched by
`get_batch`) only where the JAX feeder does (:79-91): single-person clips
(num_person 1, every clip (T, V, 3)), centred on joint 1, with a bone table
where the modality needs one. So configs/ntu60.yaml (num_person 2)
assembles its batches on numpy in both packages, and "native" raises there.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import transforms as T


class SkeletonFeederGCN:
    """Map-style dataset yielding (skeleton (3, T, V, M) f32, label, index)."""

    def __init__(
        self,
        data_path: str,
        split: str = "train",
        modality: str = "joint",  # joint | bone | motion
        repeat: int = 1,
        time_steps: int = 64,
        num_person: int = 1,
        center_joint: int = 1,
        random_rotation_deg: int = 60,
        scale_range: tuple[float, float] = (0.5, 1.5),
        seed: int = 0,
        debug: bool = False,
        backend: str = "auto",  # auto | native | numpy
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
        self.num_person = num_person
        self.center_joint = center_joint
        self.random_rotation_deg = random_rotation_deg
        self.scale_range = scale_range
        self.seed = seed
        self.epoch = 0

        with open(os.path.join(data_path, f"{split}_split.json")) as f:
            self.data_dict = json.load(f)
        if debug:
            self.data_dict = self.data_dict[:64]
        self.label = np.array(
            [int(info["label"]) - 1 for info in self.data_dict], np.int32
        )
        self.sample_name = [info["file_name"] for info in self.data_dict]
        self._load_data()
        self.num_joint = self.data[0].shape[-2] if self.data else 0

        # the native core is (T, V, 3) shaped, centres on joint 1 and has the
        # bone tables of V = 20 and 25
        self._native = False
        has_bones = modality != "bone" or self.num_joint in (20, 25)
        if backend in ("auto", "native") and num_person == 1 and has_bones:
            single = all(d.ndim == 3 for d in self.data)
            if single and center_joint == 1:
                from .. import runtime

                self._native = runtime.available()
        if backend == "native" and not self._native:
            raise RuntimeError(
                "backend='native': the native augmentation backend is unavailable "
                "for this dataset (it takes single-person clips, num_person 1, "
                "centred on joint 1, and needs g++)")
        self.backend = "native" if self._native else "numpy"

    def _load_data(self):
        self.data = []
        for info in self.data_dict:
            name = info["file_name"]
            path = os.path.join(self.data_path, name, name + ".json")
            if not os.path.exists(path):
                path = os.path.join(self.data_path, name + ".json")
            with open(path) as f:
                skeletons = json.load(f)["skeletons"]
            self.data.append(np.asarray(skeletons, np.float64))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.data_dict) * self.repeat

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, self.epoch, index])
        )

    def __getitem__(self, index: int):
        rng = self._rng(index)
        index = index % len(self.data_dict)
        label = int(self.label[index])
        value = self.data[index]
        if value.ndim == 3:  # (T, V, 3) -> (T, 1, V, 3)
            value = value[:, None, :, :]
        t_in, m_in, V, _ = value.shape

        if self.train:
            r = self.random_rotation_deg
            agx = int(rng.integers(-r, r + 1))
            agy = int(rng.integers(-r, r + 1))
            s = float(rng.uniform(*self.scale_range))
        else:
            agx, agy, s = 0, 0, 1.0

        # center all persons on person 0's center joint at frame 0
        value = value - value[0:1, 0:1, self.center_joint:self.center_joint + 1, :]
        value = T.rand_view_transform(value, agx, agy, s)
        value = T.minmax_normalize(value)

        if self.train:
            idx = T.resample_train(t_in, self.time_steps, rng)
        else:
            idx = T.resample_eval(t_in, self.time_steps)
        data = value[idx]  # (T, M, V, 3)

        if self.modality == "bone":
            bones = T.bones_for(V)
            data = np.stack(
                [T.to_bone(data[:, m], bones) for m in range(m_in)], axis=1
            )
        elif self.modality == "motion":
            data = T.to_motion(data)

        # (T, M, V, 3) -> (3, T, V, M), pad/truncate persons
        data = np.transpose(data, (3, 0, 2, 1))
        M = self.num_person
        if m_in < M:
            pad = np.zeros((3, self.time_steps, V, M - m_in), data.dtype)
            data = np.concatenate([data, pad], axis=-1)
        elif m_in > M:
            # keep the persons with the most motion energy
            energy = np.abs(np.diff(data, axis=1)).sum(axis=(0, 1, 2))
            keep = np.sort(np.argsort(-energy)[:M])
            data = data[..., keep]
        return data.astype(np.float32), label, index

    def get_batch(self, indices):
        """The batch of `indices` through the native core (skeletons (B, 3,
        T, V, 1) float32, labels, sample indices), bit for bit the numpy
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

    def top_k(self, score: np.ndarray, k: int) -> float:
        return T.top_k(score, self.label, k)
