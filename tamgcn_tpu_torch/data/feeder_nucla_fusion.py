"""NW-UCLA fusion feeder: skeleton + replicated ST-ROI RGB stack.

Copy of tamgcn_tpu/data/feeder_nucla_fusion.py (reference
feeder/feeder_nucla_fusion.py): skeleton JSON loading to (3, T, 20, 1) with
the zero-skeleton fallback (reference :101-140), the optional
shift/choose/pad/move augmentation of the tools set (:159-170), and one
ST-ROI image replicated temporal_rgb_frames times -> (3F, 224, 224)
(:172-175). A missing or unreadable image is black, as in the reference;
an image that exists while Pillow is missing raises
(transforms.load_rgb_images). Returns (skeleton, rgb, label, index); the
paths are arguments, not the reference's hardcoded roots.
"""
from __future__ import annotations

import json
import os

import numpy as np

from . import transforms as T
from .splits import load_nucla_split


def load_skeleton_json(path: str) -> np.ndarray:
    """Skeleton JSON -> (3, T, 20, 1); zeros (3, 50, 20, 1) on any failure
    (reference :101-140)."""
    try:
        with open(path) as f:
            video_info = json.load(f)
        if "skeletons" in video_info:
            arr = np.asarray(video_info["skeletons"], np.float64)
        elif "data" in video_info:
            arr = np.asarray(video_info["data"], np.float64)
        else:
            raise KeyError("no 'skeletons' or 'data' key")
        if arr.ndim == 2:  # (T, V*C) -> (T, 20, 3)
            arr = arr.reshape(arr.shape[0], 20, 3)
        return np.transpose(arr, (2, 0, 1))[..., None]  # (3, T, 20, 1)
    except Exception:
        return np.zeros((3, 50, 20, 1))


class NUCLAFeederFusion:
    def __init__(
        self,
        skeleton_root: str,
        rgb_root: str,
        split: str = "train",
        random_choose: bool = False,
        random_shift: bool = False,
        random_move: bool = False,
        window_size: int = -1,
        temporal_rgb_frames: int = 5,
        seed: int = 0,
        debug: bool = False,
        **_unused,
    ):
        self.skeleton_root = skeleton_root
        self.rgb_root = rgb_root
        self.split = split
        self.train = split == "train"
        self.random_choose = random_choose
        self.random_shift = random_shift
        self.random_move = random_move
        self.window_size = window_size
        self.temporal_rgb_frames = temporal_rgb_frames
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
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, self.epoch, index])
        )
        info = self.data_dict[index]
        name = info["file_name"]
        label = int(self.label[index])
        data = load_skeleton_json(os.path.join(self.skeleton_root, name + ".json"))

        if self.random_shift:
            data = T.random_shift(data, rng)
        if self.random_choose:
            data = T.random_choose(data, self.window_size, rng)
        elif self.window_size > 0:
            data = T.auto_pading(data, self.window_size)
            C, t, V, M = data.shape
            if t > self.window_size:  # center crop (reference :166-168)
                begin = (t - self.window_size) // 2
                data = data[:, begin:begin + self.window_size]
        if self.random_move:
            data = T.random_move(data, rng)

        rgb = T.load_rgb_images(self.rgb_root, name, self.temporal_rgb_frames)
        return data.astype(np.float32), rgb.astype(np.float32), label, index

    def top_k(self, score: np.ndarray, k: int) -> float:
        return T.top_k(score, self.label, k)
