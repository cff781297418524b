"""Fusion-effect visualiser: CTR-GCN activation intensity gating an ST-ROI
image. Counterpart of tools/visualize_fusion.py (reference visual.py:14-117).

    python -m tamgcn_tpu_torch.tools.visualize_fusion --weights W \\
        --data_path data/nucla/all_sqe --rgb_root data/nucla/st_roi \\
        [--sample a01_s01_e00_v03] [--out fusion_vis.png] [--device cuda|cpu]

Runs the port's CTR-GCN `extract_feature` on one val clip (on the card
unless `--device cpu`; K1 there), L2-norms the channels into a (T', V)
intensity map (`joint_intensity`), builds a per-joint column weight map for
the reference's target joints, resizes it bilinearly onto the ST-ROI image
(`column_weight_map`, Pillow) and renders original / weight map / gated
(matplotlib, viz.pyplot). --weights takes every form the trainer's
--weights takes (train/checkpoint.py:load_weights).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import tool_device

TARGET_JOINTS = {  # joints highlighted in the reference figure (visual.py:62-83)
    "head": 3, "l_hand": 7, "r_hand": 11, "l_foot": 15, "r_foot": 19,
}


def joint_intensity(model, skeleton: np.ndarray, device="cpu") -> np.ndarray:
    """(T', V) channel-L2 intensity of the pre-pool feature, normalised to
    max 1 (visual.py:53-57); `skeleton` one (C, T, V, M) clip."""
    x = torch.from_numpy(np.asarray(skeleton, np.float32)[None]).to(device)
    with torch.no_grad():
        feat, _ = model.eval().extract_feature(x)  # (1, C, T', V, M)
    inten = np.linalg.norm(feat[0].double().cpu().numpy(), axis=0)[..., 0]  # (T', V)
    return inten / (inten.max() + 1e-9)


def column_weight_map(inten: np.ndarray, image_hw: tuple[int, int],
                      target_joints=tuple(TARGET_JOINTS.values())) -> np.ndarray:
    """Per-joint mean intensity -> per-column weights resized to the image
    (visual.py:62-90). ST-ROI images lay joints out left to right."""
    from PIL import Image

    per_joint = inten.mean(axis=0)  # (V,)
    weights = np.full_like(per_joint, per_joint.mean())
    for j in target_joints:
        weights[j] = per_joint[j]
    col = np.tile(weights[None, :], (8, 1)).astype(np.float32)
    img = Image.fromarray((col * 255).astype(np.uint8))
    img = img.resize((image_hw[1], image_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="fusion effect visualiser")
    p.add_argument("--weights", required=True)
    p.add_argument("--data_path", default="data/nucla/all_sqe")
    p.add_argument("--rgb_root", default="data/nucla/st_roi")
    p.add_argument("--sample", default=None, help="file_name; default first val")
    p.add_argument("--out", default="fusion_vis.png")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    arg = p.parse_args(argv)
    device = tool_device(arg.device)

    from ..data import NUCLAFeederGCN
    from ..data.transforms import load_image_chw
    from ..models import create_ctrgcn_nucla
    from ..train.checkpoint import load_weights
    from ..viz import pyplot

    feeder = NUCLAFeederGCN(arg.data_path, split="val")
    idx = feeder.sample_name.index(arg.sample) if arg.sample else 0
    skeleton, label, _ = feeder[idx]
    name = feeder.sample_name[idx]

    model = create_ctrgcn_nucla()
    model.load_state_dict(load_weights(arg.weights, "ctrgcn", model))
    inten = joint_intensity(model.to(device), skeleton, device)
    rgb_path = os.path.join(arg.rgb_root, name + ".png")
    if os.path.exists(rgb_path):
        rgb = np.transpose(load_image_chw(rgb_path, 224, normalize=False), (1, 2, 0))
    else:
        rgb = np.zeros((224, 224, 3), np.float32)
    wmap = column_weight_map(inten, rgb.shape[:2])
    gated = rgb * wmap[..., None]

    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in zip(axes, [rgb, wmap, gated],
                              [f"ST-ROI: {name} (label {label})", "GCN weight map",
                               "gated"]):
        ax.imshow(np.clip(img, 0, 1), cmap="viridis" if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(arg.out, dpi=120)
    print(f"saved {arg.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
