"""The two skeleton feeders' sample transforms and the train loader's order,
in numpy, after the original repository's feeder/feeder_nucla_gcn.py and
its generalisation to several persons:

  * centre every frame on joint 1 (0-based) of person 0 in frame 0;
  * train: a view rotation about x then y by whole degrees drawn from
    [-60, 60] and a scale drawn from U(0.5, 1.5), X @ (Ry @ Rx @ S);
  * min-max normalisation of each coordinate axis to [-1, 1] (+1e-6);
  * resampling to `time_steps` frames: train, a sorted sample without
    replacement from the frame list repeated 100 times; eval, linspace;
  * (3, T, V, M) float32, persons padded with zeros (or the M of most
    motion kept).

Each sample's randomness is numpy's Philox stream keyed on (seed, epoch,
sample index), drawn in the order the transforms need it (x angle, y angle,
scale, then one integer per resampled frame), and the train loader's order
is the permutation drawn from the stream (seed, epoch, 1); batches are
consecutive runs of that order, the last partial batch dropped."""
from __future__ import annotations

import math

import numpy as np

ROTATION = 60
SCALE = (0.5, 1.5)
CENTRE = 1


def stream(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, epoch, index]))


def order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The train loader's sample order of an epoch."""
    idx = np.arange(n)
    stream(seed, epoch, 1).shuffle(idx)
    return idx


def _rotation(agx: float, agy: float, s: float) -> np.ndarray:
    ax, ay = math.radians(agx), math.radians(agy)
    rx = np.array([[1, 0, 0], [0, math.cos(ax), math.sin(ax)],
                   [0, -math.sin(ax), math.cos(ax)]])
    ry = np.array([[math.cos(ay), 0, -math.sin(ay)], [0, 1, 0],
                   [math.sin(ay), 0, math.cos(ay)]])
    return ry @ rx @ np.diag([s, s, s])


def _train_frames(length: int, steps: int, rng) -> np.ndarray:
    """Sorted positions of `steps` draws without replacement from
    range(length * 100), taken modulo length: a partial Fisher-Yates
    shuffle, one rng.integers(i, n) per draw."""
    n = length * 100
    moved: dict[int, int] = {}
    picks = np.empty(steps, np.int64)
    for i in range(steps):
        j = int(rng.integers(i, n))
        picks[i] = moved.get(j, j)
        moved[j] = moved.get(i, i)
    return np.sort(picks % length)


def sample(clip: np.ndarray, index: int, *, train: bool, seed: int, epoch: int,
           steps: int, persons: int) -> np.ndarray:
    """One sample of a clip (T, V, 3) or (T, M, V, 3) as (3, steps, V, persons) f32."""
    rng = stream(seed, epoch, index)
    x = np.asarray(clip, np.float64)
    if x.ndim == 3:
        x = x[:, None]
    t, m, v, _ = x.shape
    if train:
        agx = int(rng.integers(-ROTATION, ROTATION + 1))
        agy = int(rng.integers(-ROTATION, ROTATION + 1))
        s = float(rng.uniform(*SCALE))
    else:
        agx, agy, s = 0, 0, 1.0
    x = x - x[0:1, 0:1, CENTRE:CENTRE + 1, :]
    x = (x.reshape(-1, 3) @ _rotation(agx, agy, s)).reshape(x.shape)
    flat = x.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    x = (((flat - lo) / (hi - lo + 1e-6)) * 2 - 1).reshape(x.shape)
    frames = (_train_frames(t, steps, rng) if train
              else np.linspace(0, t - 1, steps).astype(int))
    x = np.transpose(x[frames], (3, 0, 2, 1))  # (3, steps, V, m)
    if m < persons:
        x = np.concatenate([x, np.zeros((3, steps, v, persons - m))], axis=-1)
    elif m > persons:
        energy = np.abs(np.diff(x, axis=1)).sum(axis=(0, 1, 2))
        x = x[..., np.sort(np.argsort(-energy)[:persons])]
    return x.astype(np.float32)


def batch(clips, labels, indices, *, train: bool, seed: int, epoch: int, steps: int,
          persons: int):
    """(x (B, 3, steps, V, persons) f32, labels (B,) int64) of the dataset
    indices `indices` (a repeated dataset's index modulo its clips)."""
    n = len(clips)
    x = np.stack([sample(clips[i % n], int(i), train=train, seed=seed, epoch=epoch,
                         steps=steps, persons=persons) for i in indices])
    return x, np.asarray([labels[i % n] for i in indices], np.int64)
