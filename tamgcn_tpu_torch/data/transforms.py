"""Host-side skeleton and image preprocessing (numpy).

Copies of the functions of tamgcn_tpu/data/transforms.py: view transform,
min-max normalisation, train and eval resampling, the bone/motion
modalities with the bone table per joint count, the generic (C, T, V, M)
tools (centralization, downsample, padding, random crop, move and shift,
multi-person pose matching), the ST-ROI image loaders and the scores
(top-k, per-class precision and recall, the confusion matrix). The port's
feeders use some of them; the rest are the public API, as in JAX.

Images and Pillow: the reference loaders return black images on ANY error
(tamgcn_tpu/data/transforms.py:380-388), which on a machine without Pillow
turns a whole dataset into zeros with no error. Here a missing or unreadable
image file still gives the black image, but an image file that exists while
Pillow is not installed raises an ImportError naming Pillow.
"""
from __future__ import annotations

import math
import os

import numpy as np

# NW-UCLA bone list: (joint, parent) 1-based (reference feeder_nucla_gcn.py:27-28)
NUCLA_BONES = [
    (1, 2), (2, 3), (3, 3), (4, 3), (5, 3), (6, 5), (7, 6), (8, 7), (9, 3),
    (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14), (16, 15),
    (17, 1), (18, 17), (19, 18), (20, 19),
]

# NTU RGB+D bone list: (joint, parent) 1-based, Kinect-v2 25-joint layout
# (the inward edges of graphs/ntu_rgb_d.py plus the spine-shoulder root)
NTU_BONES = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
    (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
    (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (21, 21), (22, 23),
    (23, 8), (24, 25), (25, 12),
]


def bones_for(num_joint: int) -> list[tuple[int, int]]:
    """Bone (child, parent) table for a skeleton layout, keyed by joint count."""
    if num_joint == 20:
        return NUCLA_BONES
    if num_joint == 25:
        return NTU_BONES
    raise ValueError(f"no bone table for {num_joint}-joint skeletons")


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def rand_view_transform(x: np.ndarray, agx: float, agy: float, s: float) -> np.ndarray:
    """3-D view rotation (deg) about x then y, isotropic scale s.

    Matches reference feeder_nucla_gcn.py:75-83: X @ (Ry @ Rx @ S) on
    row-vector (…, 3) coordinates.
    """
    agx = math.radians(agx)
    agy = math.radians(agy)
    rx = np.array(
        [[1, 0, 0],
         [0, math.cos(agx), math.sin(agx)],
         [0, -math.sin(agx), math.cos(agx)]]
    )
    ry = np.array(
        [[math.cos(agy), 0, -math.sin(agy)],
         [0, 1, 0],
         [math.sin(agy), 0, math.cos(agy)]]
    )
    ss = np.diag([s, s, s])
    out = np.reshape(x, (-1, 3)) @ (ry @ rx @ ss)
    return out.reshape(x.shape)


def minmax_normalize(x: np.ndarray) -> np.ndarray:
    """Per-sample min-max normalisation to [-1, 1] over all joints/frames.

    Reference feeder_nucla_gcn.py:102-105 (per-coordinate-axis min/max).
    """
    flat = np.reshape(x, (-1, 3))
    v_min, v_max = flat.min(axis=0), flat.max(axis=0)
    flat = (flat - v_min) / (v_max - v_min + 1e-6)
    return (flat * 2 - 1).reshape(x.shape)


def sample_positions_without_replacement(
    n: int, k: int, rng: np.random.Generator
) -> np.ndarray:
    """k distinct positions uniform over [0, n), via partial Fisher-Yates:
    exactly k ``rng.integers(i, n)`` draws, one per output, so the draw
    stream is the JAX package's draw for draw. Distribution == Python
    ``random.sample(range(n), k)``."""
    swap: dict[int, int] = {}
    out = np.empty(k, np.int64)
    for i in range(k):
        j = int(rng.integers(i, n))
        out[i] = swap.get(j, j)
        swap[j] = swap.get(i, i)
    return out


def resample_train(length: int, time_steps: int, rng: np.random.Generator) -> np.ndarray:
    """Sorted sample without replacement from the 100x-replicated frame list
    (reference feeder_nucla_gcn.py:111-114:
    ``sorted(random.sample(list(np.arange(length)) * 100, time_steps))``)."""
    pos = sample_positions_without_replacement(length * 100, time_steps, rng)
    idx = pos % length
    idx.sort()
    return idx


def resample_eval(length: int, time_steps: int) -> np.ndarray:
    """Deterministic linspace frame indices (reference :115-117)."""
    return np.linspace(0, length - 1, time_steps).astype(int)


def to_bone(data: np.ndarray, bones=NUCLA_BONES) -> np.ndarray:
    """Joint -> bone modality: child minus parent (reference :119-123).

    data: (T, V, 3).
    """
    out = np.zeros_like(data)
    for child, parent in bones:
        out[:, child - 1, :] = data[:, child - 1, :] - data[:, parent - 1, :]
    return out


def to_motion(data: np.ndarray) -> np.ndarray:
    """Joint -> motion modality: temporal diff, last frame zero (reference :124-127)."""
    out = np.zeros_like(data)
    out[:-1] = data[1:] - data[:-1]
    return out


# ---------------------------------------------------------------------------
# Generic (C, T, V, M) tools (reference feeder/tools.py)
# ---------------------------------------------------------------------------


def centralization(data: np.ndarray) -> np.ndarray:
    """Subtract frame-0 joint-0 of person 0 from all (reference tools.py:6-11)."""
    out = data.copy()
    out[:, :, :, 0] = out[:, :, :, 0] - data[:, 0:1, 0:1, 0]
    return out


def downsample(
    data: np.ndarray, step: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Strided temporal downsample with optional random phase (tools.py:13-16)."""
    begin = int(rng.integers(step)) if rng is not None else 0
    return data[:, begin::step, :, :]


def auto_pading(
    data: np.ndarray, size: int, random_pad: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Zero-pad T up to `size` (reference tools.py:39-47)."""
    C, T, V, M = data.shape
    if T >= size:
        return data
    begin = int(rng.integers(0, size - T + 1)) if (random_pad and rng is not None) else 0
    out = np.zeros((C, size, V, M), data.dtype)
    out[:, begin:begin + T] = data
    return out


def random_choose(
    data: np.ndarray, size: int, rng: np.random.Generator, auto_pad: bool = True
) -> np.ndarray:
    """Random temporal crop to `size` frames (reference tools.py:50-62)."""
    C, T, V, M = data.shape
    if T == size:
        return data
    if T < size:
        return auto_pading(data, size, random_pad=True, rng=rng) if auto_pad else data
    begin = int(rng.integers(0, T - size + 1))
    return data[:, begin:begin + size]


_DEFAULT_ANGLES = [
    -175., -170., -165., -160., -155., -150., -145., -140., -135., -130.,
    -125., -120., -115., -100., -95., -90., -85., -80., -75., -70., -65.,
    -60., -55., -50., -45., -40., -35., -30., -25., -20., -15., -10., -5.,
    0., 5., 10., 15., 20., 25., 30., 35., 40., 45., 50., 55., 60., 65., 70.,
    75., 80., 85., 90., 95., 100., 115., 120., 125., 130., 135., 140., 145.,
    150., 155., 160., 165., 170., 175., 180.,
]


def random_move(
    data: np.ndarray,
    rng: np.random.Generator,
    angle_candidate=tuple(_DEFAULT_ANGLES),
    scale_candidate=(0.9, 1.0, 1.1),
    transform_candidate=(-0.2, -0.1, 0.0, 0.1, 0.2),
    move_time_candidate=(1,),
) -> np.ndarray:
    """Piecewise-interpolated 2-D rotate/scale/translate (reference tools.py:65-115;
    the widest angle set, the reference's final choice, tools.py:66-72)."""
    data = data.copy()
    C, T, V, M = data.shape
    move_time = int(rng.choice(np.asarray(move_time_candidate)))
    node = np.arange(0, T, T * 1.0 / move_time).round().astype(int)
    node = np.append(node, T)
    num_node = len(node)

    A = rng.choice(np.asarray(angle_candidate), num_node)
    S = rng.choice(np.asarray(scale_candidate), num_node)
    T_x = rng.choice(np.asarray(transform_candidate), num_node)
    T_y = rng.choice(np.asarray(transform_candidate), num_node)

    a = np.zeros(T)
    s = np.zeros(T)
    t_x = np.zeros(T)
    t_y = np.zeros(T)
    for i in range(num_node - 1):
        n0, n1 = node[i], node[i + 1]
        a[n0:n1] = np.linspace(A[i], A[i + 1], n1 - n0) * np.pi / 180
        s[n0:n1] = np.linspace(S[i], S[i + 1], n1 - n0)
        t_x[n0:n1] = np.linspace(T_x[i], T_x[i + 1], n1 - n0)
        t_y[n0:n1] = np.linspace(T_y[i], T_y[i + 1], n1 - n0)

    theta = np.array(
        [[np.cos(a) * s, -np.sin(a) * s], [np.sin(a) * s, np.cos(a) * s]]
    )  # (2, 2, T)
    for t in range(T):
        xy = data[0:2, t].reshape(2, -1)
        new_xy = theta[:, :, t] @ xy
        new_xy[0] += t_x[t]
        new_xy[1] += t_y[t]
        data[0:2, t] = new_xy.reshape(2, V, M)
    return data


def random_shift(data: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Shift the valid-frame span to a random offset (reference tools.py:118-130)."""
    C, T, V, M = data.shape
    out = np.zeros_like(data)
    valid = (data != 0).sum(axis=(0, 2, 3)) > 0
    begin = int(valid.argmax())
    end = len(valid) - int(valid[::-1].argmax())
    size = end - begin
    bias = int(rng.integers(0, T - size + 1))
    out[:, bias:bias + size] = data[:, begin:end]
    return out


def pose_match(data: np.ndarray) -> np.ndarray:
    """Track multi-person pose identities across frames (reference
    feeder/tools.py:133-174 `openpose_match` capability).

    data: (3, T, V, M) with channel 2 = per-joint confidence. Bodies are
    matched frame-to-frame greedily in descending per-frame confidence
    order by nearest xy distance, identity chains are strung through time,
    and the person axis is re-ordered by total trace confidence.
    """
    C, T, V, M = data.shape
    if C != 3:
        raise ValueError("pose_match expects (3, T, V, M) with confidence in channel 2")
    xy = data[0:2]                      # (2, T, V, M)
    conf = data[2].sum(axis=1)          # (T, M) per-frame body confidence
    # squared xy distance between every body in frame t and frame t+1
    diff = xy[:, :-1, :, :, None] - xy[:, 1:, :, None, :]   # (2, T-1, V, M, M)
    dist = (diff ** 2).sum(axis=(0, 2))                      # (T-1, M, M)

    ident = np.zeros((T, M), dtype=int)  # ident[t, m]: body slot of trace m at t
    ident[0] = np.arange(M)
    for t in range(T - 1):
        taken = np.zeros(M, bool)
        step = np.zeros(M, dtype=int)
        for b in np.argsort(-conf[t]):   # most confident body first
            d = dist[t, b].copy()
            d[taken] = np.inf
            nxt = int(d.argmin())
            taken[nxt] = True
            step[b] = nxt
        ident[t + 1] = step[ident[t]]

    out = np.zeros_like(data)
    for t in range(T):
        out[:, t] = data[:, t, :, ident[t]].transpose(1, 2, 0)
    order = np.argsort(-out[2].sum(axis=(0, 1)))  # total trace confidence
    return out[:, :, :, order]


# ---------------------------------------------------------------------------
# Images (Pillow; the reference's torchvision Resize+ToTensor+Normalize)
# ---------------------------------------------------------------------------


def load_image_chw(
    path: str, size: int = 224, normalize: bool = True
) -> np.ndarray:
    """Load an RGB image -> float32 (3, size, size), ImageNet-normalised
    (reference feeder_nucla_resnet.py:25-35, tools.py:216-246; Pillow's
    bilinear resize). Raises ImportError, naming Pillow, where it is not
    installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading the image {path} needs Pillow (the PIL package), which is "
            "not installed") from e

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0  # (H, W, 3)
    if normalize:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(arr, (2, 0, 1))


def load_image_or_black(path: str, size: int = 224) -> np.ndarray:
    """load_image_chw, or the reference's black image (zeros) where the file
    is missing or unreadable; a missing Pillow raises (module docstring)."""
    if not os.path.exists(path):
        return np.zeros((3, size, size), np.float32)
    try:
        return load_image_chw(path, size)
    except ImportError:
        raise
    except Exception:
        return np.zeros((3, size, size), np.float32)


def load_rgb_images(
    rgb_root: str, name: str, temporal_rgb_frames: int, size: int = 224
) -> np.ndarray:
    """Replicate one ST-ROI image temporal_rgb_frames x -> (3*F, size, size)
    (reference feeder/tools.py:216-246, `<name>.png`, else `<name>.jpg`),
    black where it is missing or unreadable."""
    img_path = os.path.join(rgb_root, name + ".png")
    if not os.path.exists(img_path):
        img_path = os.path.join(rgb_root, name + ".jpg")
    img = load_image_or_black(img_path, size)
    return np.concatenate([img] * temporal_rgb_frames, axis=0)


def top_k(score: np.ndarray, label: np.ndarray, k: int) -> float:
    """Top-k accuracy (reference feeder_nucla_gcn.py:156-159)."""
    rank = score.argsort(axis=1)
    hit = [l in rank[i, -k:] for i, l in enumerate(label)]
    return sum(hit) / len(hit)


def top_k_by_category(label, score, k) -> list[float]:
    """Per-class top-k accuracy (reference tools.py:177-191)."""
    instance_num, class_num = score.shape
    rank = score.argsort(axis=1)
    hits: list[list[bool]] = [[] for _ in range(class_num)]
    for i in range(instance_num):
        l = label[i]
        hits[l].append(l in rank[i, -k:])
    return [sum(h) / len(h) if h else 0.0 for h in hits]


def calculate_recall_precision(label, score):
    """Per-class precision/recall from argmax predictions (tools.py:194-214)."""
    instance_num, class_num = score.shape
    pred = score.argmax(axis=1)
    confusion = np.zeros([class_num, class_num])
    for i in range(instance_num):
        confusion[label[i]][pred[i]] += 1
    precision, recall = [], []
    for i in range(class_num):
        tp = confusion[i][i]
        fn = confusion[i, :].sum() - tp
        fp = confusion[:, i].sum() - tp
        precision.append(tp / (tp + fp) if (tp + fp) else 0.0)
        recall.append(tp / (tp + fn) if (tp + fn) else 0.0)
    return precision, recall


def confusion_matrix(label, score) -> np.ndarray:
    """Counts of (true class, argmax class)."""
    class_num = score.shape[1]
    pred = score.argmax(axis=1)
    cm = np.zeros([class_num, class_num], dtype=np.int64)
    for l, p in zip(label, pred):
        cm[l][p] += 1
    return cm
