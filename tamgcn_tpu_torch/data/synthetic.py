"""Synthetic skeleton dataset for smoke tests and benchmarks (no real data).

Numpy copy of SyntheticSkeletonFeeder from tamgcn_tpu/data/synthetic.py:
the same seed gives the same samples in both packages.

Generates class-separable random walks over the NW-UCLA joint layout so an
end-to-end training run can demonstrably learn (accuracy rises above chance
within a few epochs), without the NW-UCLA download.
"""
from __future__ import annotations

import numpy as np

from . import transforms as T


class SyntheticSkeletonFeeder:
    """Yields (skeleton (3, T, V, 1) f32, label, index), like NUCLAFeederGCN."""

    def __init__(
        self,
        num_samples: int = 256,
        num_class: int = 10,
        num_point: int = 20,
        time_steps: int = 52,
        split: str = "train",
        seed: int = 0,
        **_unused,
    ):
        self.num_class = num_class
        self.num_point = num_point
        self.time_steps = time_steps
        self.train = split == "train"
        self.seed = seed
        self.epoch = 0

        # prototypes shared between splits (keyed by seed only), so val is
        # drawn from the train distribution. Two per class: an oscillation
        # direction and a CONSTANT pose offset — the offset survives the
        # network's global (T, V) mean pooling regardless of the random
        # phase, so the task is generalizably learnable (round-5 fix: with
        # sin(t+phase)*proto alone, the phase flips the pooled signal's
        # sign and trained models memorized train noise while val stayed
        # at chance — observed on-chip, 12 epochs, val top-1 ~= 1/num_class)
        proto_rng = np.random.Generator(np.random.Philox(key=seed))
        self.proto = proto_rng.normal(size=(num_class, num_point, 3)).astype(
            np.float64
        )
        self.proto_pose = proto_rng.normal(
            size=(num_class, num_point, 3)
        ).astype(np.float64)
        rng = np.random.Generator(np.random.Philox(key=seed + (1 if self.train else 2)))
        self.label = rng.integers(0, num_class, size=num_samples).astype(np.int32)
        self.phase = rng.uniform(0, 2 * np.pi, size=num_samples)
        self.sample_name = [f"synthetic_{i:05d}" for i in range(num_samples)]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.label)

    def __getitem__(self, index: int):
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + 17, counter=[0, 0, self.epoch, index])
        )
        label = int(self.label[index])
        t = np.linspace(0, 2 * np.pi, self.time_steps)[:, None, None]
        base = (
            np.sin(t + self.phase[index]) * self.proto[label][None]
            + 0.6 * self.proto_pose[label][None]
        )
        noise = 0.1 * rng.normal(size=base.shape)
        data = T.minmax_normalize(base + noise)  # (T, V, 3)
        data = np.transpose(data, (2, 0, 1))[..., None]  # (3, T, V, 1)
        return data.astype(np.float32), label, index
