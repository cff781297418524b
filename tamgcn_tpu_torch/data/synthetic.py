"""Synthetic datasets for smoke tests and benchmarks (no real data).

Numpy copy of tamgcn_tpu/data/synthetic.py: SyntheticSkeletonFeeder,
SyntheticRGBFeeder and SyntheticFusionFeeder; the same seed gives the same
samples in both packages. None of them reads an image file (no Pillow).

Generates class-separable random walks over the NW-UCLA joint layout, and
per-class prototype images, so an end-to-end training run can demonstrably
learn (accuracy rises above chance within a few epochs), without the
NW-UCLA download.
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


def _rgb_class_protos(num_class: int, image_size: int, seed: int) -> np.ndarray:
    """Per-class RGB prototype images (num_class, 3, S, S), shared between
    splits (keyed by seed only), so val draws from the train distribution."""
    rng = np.random.Generator(np.random.Philox(key=seed + 7))
    return 0.5 * rng.normal(size=(num_class, 3, image_size, image_size)).astype(
        np.float64
    )


class SyntheticRGBFeeder:
    """Yields (rgb (3*F, S, S) f32, label, index), like NUCLAFeederResNet:
    a per-class random prototype image plus per-sample Gaussian noise."""

    def __init__(
        self,
        num_samples: int = 256,
        num_class: int = 10,
        image_size: int = 64,
        temporal_rgb_frames: int = 1,
        split: str = "train",
        seed: int = 0,
        **_unused,
    ):
        self.num_class = num_class
        self.image_size = image_size
        self.temporal_rgb_frames = temporal_rgb_frames
        self.train = split == "train"
        self.seed = seed
        self.epoch = 0
        self.proto_rgb = _rgb_class_protos(num_class, image_size, seed)
        rng = np.random.Generator(
            np.random.Philox(key=seed + (3 if self.train else 4))
        )
        self.label = rng.integers(0, num_class, size=num_samples).astype(np.int32)
        self.sample_name = [f"synthetic_rgb_{i:05d}" for i in range(num_samples)]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.label)

    def __getitem__(self, index: int):
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + 23, counter=[0, 0, self.epoch, index])
        )
        label = int(self.label[index])
        img = self.proto_rgb[label] + 0.3 * rng.normal(size=self.proto_rgb[label].shape)
        if self.temporal_rgb_frames > 1:
            img = np.concatenate([img] * self.temporal_rgb_frames, axis=0)
        return img.astype(np.float32), label, index


class SyntheticFusionFeeder(SyntheticSkeletonFeeder):
    """Two-input synthetic dataset: (skeleton, rgb_stack, label, index); the
    RGB stream carries SyntheticRGBFeeder's per-class prototype signal (plus
    noise), so both modalities are learnable."""

    def __init__(self, *args, temporal_rgb_frames: int = 5, image_size: int = 32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.temporal_rgb_frames = temporal_rgb_frames
        self.image_size = image_size
        self.proto_rgb = _rgb_class_protos(
            self.num_class, image_size, self.seed
        )

    def __getitem__(self, index: int):
        data, label, _ = super().__getitem__(index)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + 31, counter=[0, 0, self.epoch, index])
        )
        rgb = np.concatenate(
            [self.proto_rgb[label]] * self.temporal_rgb_frames, axis=0
        ) + 0.3 * rng.normal(
            size=(3 * self.temporal_rgb_frames, self.image_size, self.image_size)
        )
        return data, rgb.astype(np.float32), label, index
