"""Host-side skeleton preprocessing (numpy).

Copies of the functions of tamgcn_tpu/data/transforms.py that the NW-UCLA
and synthetic feeders use: view transform, min-max normalisation, train and
eval resampling, the bone/motion modalities and top-k scoring.
"""
from __future__ import annotations

import math

import numpy as np

# NW-UCLA bone list: (joint, parent) 1-based (reference feeder_nucla_gcn.py:27-28)
NUCLA_BONES = [
    (1, 2), (2, 3), (3, 3), (4, 3), (5, 3), (6, 5), (7, 6), (8, 7), (9, 3),
    (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14), (16, 15),
    (17, 1), (18, 17), (19, 18), (20, 19),
]


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


def top_k(score: np.ndarray, label: np.ndarray, k: int) -> float:
    """Top-k accuracy (reference feeder_nucla_gcn.py:156-159)."""
    rank = score.argsort(axis=1)
    hit = [l in rank[i, -k:] for i, l in enumerate(label)]
    return sum(hit) / len(hit)
