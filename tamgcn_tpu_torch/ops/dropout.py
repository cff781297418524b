"""Seeded dropout: masks keyed on (run seed, train step, site, element).

Counterpart of `flax.linen.Dropout` as the JAX models use it: in training
each kept element is scaled by 1 / (1 - p), the rest are 0; in eval it is
the identity. The JAX trainer draws a step's masks from
`jax.random.fold_in(rng, step)` (tamgcn_tpu/train/packing.py:187,
trainer.py:378), so a mask is a function of the run's key and the train step
and a resumed run draws the masks an unbroken one draws. The port keeps that
property with a counter-based mask instead of a generator's state:

    keep[i] = hash(hash(seed, step, site), i) >= p * 2**32

a 32-bit integer hash (`_hash32`) of the run seed, the train step, the site
(the dropout calls of one forward, numbered in call order) and the
element's flat index, computed with int64 tensor ops on the tensor's device.
Its constants are below 2**31, so every product of a 32-bit value fits in
int64, and the CPU and the card compute the same bits.

The step is read from a tensor: the packed train state's device step
counter (train/packing.py), which the fused step advances. A CUDA graph of
the train step (train/graphs.py) reads the counter at each replay, so each
replay draws a fresh mask with no write from the host; a resume writes the
checkpoint's step into the counter. torch's global generator and
`nn.Dropout` are not used: neither is keyed on the step, and their replay
semantics under `torch.cuda.graph` depend on generator registration.

Under data parallelism each rank holds rows of the global batch: the stream
of its forward carries the global index of its first sample (`row0`) and
its sample count (`rows`), and a site's element index is its index in the
global batch's tensor, so the ranks draw the masks of one process's run
(a site's tensor holds its samples' elements contiguously, sample-major).

A training forward with a dropout rate > 0 runs under `stream(seed, step)`,
as a Flax apply in training needs a "dropout" rng; outside one it raises.
With rate 0, or in eval, `SeededDropout` returns its input and launches
nothing.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

_MASK32 = 0xFFFFFFFF
_local = threading.local()


def _hash32(h):
    """A 32-bit integer hash (a bijection of [0, 2**32)), on Python ints or
    on int64 tensors that hold 32-bit values."""
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & _MASK32
    return h ^ (h >> 15)


def _site_key(seed: int, step, site: int):
    """The 32-bit key of one dropout site at one step: a Python int for an
    int `step`, a 0-d int64 tensor on the step's device for a tensor."""
    k = _hash32((seed & _MASK32) ^ 0x9E3779B9)
    if isinstance(step, torch.Tensor):
        k = _hash32(step.to(torch.int64) ^ k)
    else:
        k = _hash32((int(step) & _MASK32) ^ k)
    return _hash32(k ^ _hash32(site + 1))


def keep_mask(shape, p: float, seed: int, step, site: int,
              device=None, offset: int = 0) -> torch.Tensor:
    """The bool keep-mask of `shape` at rate `p` for (seed, step, site); on
    the step tensor's device, else on `device`; its elements are those of
    flat indices offset, offset + 1, ... of the site's whole tensor."""
    if isinstance(step, torch.Tensor):
        device = step.device
    n = 1
    for d in shape:
        n *= d
    if offset + n >= 2 ** 32:
        raise ValueError(f"a dropout mask of {offset + n} elements: the element index "
                         "is hashed in 32 bits")
    k = _site_key(seed, step, site)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    h = _hash32(_hash32((idx + k) & _MASK32) ^ k)
    return (h >= min(int(p * 2 ** 32), _MASK32)).reshape(shape)


class _Stream:
    def __init__(self, seed: int, step, masks, row0: int, rows: int | None):
        self.seed = seed
        self.step = step
        self.masks = masks
        self.row0 = row0
        self.rows = rows
        self.sites = 0

    def offset(self, x: torch.Tensor) -> int:
        """The global flat index of x's first element (data parallelism)."""
        if not self.row0:
            return 0
        return self.row0 * (x.numel() // self.rows)


@contextlib.contextmanager
def stream(seed: int, step, masks=None, row0: int = 0, rows: int | None = None):
    """The dropout stream of one training forward: the run seed and the train
    step (an int, or the packed state's 0-d int64 device counter, read where
    a mask is drawn); under data parallelism the global index of the rank's
    first sample `row0` and its sample count `rows`. `masks`, for tests
    only: the bool keep-masks of the sites in call order, used in place of
    the hash (to hold the port against another implementation's masks)."""
    prior = getattr(_local, "stream", None)
    _local.stream = _Stream(seed, step, masks, row0, rows)
    try:
        yield _local.stream
    finally:
        _local.stream = prior


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """flax.linen.Dropout(rate=p)(x, deterministic=not training) with the
    mask of the current stream's next site."""
    if not training or not p:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    s = getattr(_local, "stream", None)
    if s is None:
        raise RuntimeError(
            f"dropout {p} in training draws its mask from a seeded stream: run the "
            "forward under tamgcn_tpu_torch.ops.dropout.stream(seed, step), as the "
            "packed train step does")
    site = s.sites
    s.sites += 1
    if s.masks is not None:
        keep = s.masks[site].to(device=x.device, dtype=torch.bool)
        if keep.shape != x.shape:
            raise ValueError(f"the mask of dropout site {site} has shape "
                             f"{tuple(keep.shape)}, its input {tuple(x.shape)}")
    else:
        keep = keep_mask(x.shape, p, s.seed, s.step, site, x.device, s.offset(x))
    return torch.where(keep, x / (1.0 - p), 0.0)


class SeededDropout(nn.Module):
    """A dropout site (`dropout`): the identity in eval and at p = 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return dropout(x, self.p, self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def draws(model: nn.Module) -> bool:
    """Whether a training forward of `model` draws dropout masks (a site
    with p > 0)."""
    return any(isinstance(m, SeededDropout) and m.p > 0 for m in model.modules())
