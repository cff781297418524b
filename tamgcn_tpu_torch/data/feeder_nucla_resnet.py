"""NW-UCLA ST-ROI image feeder for the RGB ResNet branch.

Copy of tamgcn_tpu/data/feeder_nucla_resnet.py (reference
feeder/feeder_nucla_resnet.py): the NW-UCLA split lists, `<rgb_path>/<name>.png`
ST-ROI images at `size`² with ImageNet normalisation, a random horizontal
flip in training (`random_flip`), and the reference's black image where a
file is missing or unreadable (reference :56-60). Unlike the JAX feeder,
which catches every error, an image that exists while Pillow is missing
raises (transforms.load_image_or_black). Returns (rgb (3F, size, size)
f32, label, file_name).
"""
from __future__ import annotations

import os

import numpy as np

from . import transforms as T
from .splits import load_nucla_split


class NUCLAFeederResNet:
    def __init__(
        self,
        rgb_path: str,
        split: str = "train",
        temporal_rgb_frames: int = 1,
        random_flip: bool = False,
        size: int = 224,
        seed: int = 0,
        debug: bool = False,
        **_unused,
    ):
        self.rgb_path = rgb_path
        self.split = split
        self.train = split == "train"
        self.temporal_rgb_frames = temporal_rgb_frames
        self.random_flip = random_flip
        self.size = size
        self.seed = seed
        self.epoch = 0
        self.data_dict = load_nucla_split(split)
        if debug:
            self.data_dict = self.data_dict[:64]
        self.label = np.array(
            [int(info["label"]) - 1 for info in self.data_dict], np.int32
        )
        self.sample_name = [info["file_name"] for info in self.data_dict]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.data_dict)

    def __getitem__(self, index: int):
        name = self.data_dict[index]["file_name"]
        label = int(self.label[index])
        rgb = T.load_image_or_black(os.path.join(self.rgb_path, name + ".png"), self.size)
        if self.train and self.random_flip:
            rng = np.random.Generator(
                np.random.Philox(key=self.seed, counter=[0, 0, self.epoch, index])
            )
            if rng.random() < 0.5:
                rgb = rgb[:, :, ::-1].copy()
        if self.temporal_rgb_frames > 1:
            rgb = np.concatenate([rgb] * self.temporal_rgb_frames, axis=0)
        return rgb, label, name

    def top_k(self, score: np.ndarray, k: int) -> float:
        return T.top_k(score, self.label, k)
