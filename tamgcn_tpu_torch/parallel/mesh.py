"""The (data, model) grid of ranks over torch.distributed.

Counterpart of tamgcn_tpu/parallel/mesh.py (:25-45): where JAX lays its
devices out as a named Mesh, the port runs one process per rank and lays
the ranks out row-major as a (data, model) grid, rank = d * model + m:

  * data: the batch axis (DP). Ranks of one model index form a data group,
    over which the gradient and the BatchNorm statistics are summed;
  * model: the joint ring, the tensor-parallel head and the sequence axis.
    Ranks of one data index form a model group; they hold the same samples.

`make_mesh(data_parallel, model_parallel)` builds the grid over the world of
the default process group (or of no group: one rank); -1 means "the rest".
A product that does not match the world size raises, naming both numbers,
and so does a grid larger than 1 without a process group, naming the
launcher. `init_distributed` starts the world from the launcher's
environment (`python -m torch.distributed.run`), as `--distributed true`
asks (the counterpart of jax.distributed.initialize(),
tamgcn_tpu/train/trainer.py:64-65): each rank takes its card from
`--device`, one entry per local rank, and the backend is NCCL where every
rank has a card of its own, gloo on the CPU or where ranks share a card
(NCCL refuses two ranks on one card).

`shard_batch` gives a data rank its contiguous slice of a global batch, the
counterpart of `shard_batch` (:60-74) for a process that loads every batch
whole; with `--distributed true` each process loads only its shard of the
dataset instead (data/loader.py, process_index/process_count).
"""
from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

from .comm import SOLO, Group

DATA_AXIS = "data"
MODEL_AXIS = "model"
# how long a collective may wait for its peers before the rank raises
TIMEOUT = datetime.timedelta(seconds=600)
LAUNCHER = "python -m torch.distributed.run --nproc_per_node N -m tamgcn_tpu_torch ..."


class Mesh:
    """The grid: `shape` {"data": D, "model": M}, this process's `rank`,
    its `data_index` and `model_index`, and the groups `data` (the ranks
    of its model index), `model` (the ranks of its data index) and `world`,
    each a comm.Group with this rank's position in it."""

    def __init__(self, data: int, model: int, rank: int = 0, backend: str = "gloo"):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.rank = rank
        self.backend = backend
        self.data_index, self.model_index = divmod(rank, model)
        if self.size == 1:
            self.data = self.model = self.world = SOLO
            return
        # every rank creates every group, in the same order (new_group's rule)
        data_groups = {m: self._group([d * model + m for d in range(data)])
                       for m in range(model)}
        model_groups = {d: self._group([d * model + m for m in range(model)])
                        for d in range(data)}
        self.data = data_groups[self.model_index]
        self.model = model_groups[self.data_index]
        self.world = Group(tuple(range(self.size)), rank, None, backend)

    def _group(self, ranks: list) -> Group:
        pg = dist.new_group(ranks) if len(ranks) > 1 else None
        if self.rank not in ranks:
            return None
        return Group(tuple(ranks), ranks.index(self.rank), pg, self.backend)


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(data_parallel: int = -1, model_parallel: int = 1) -> Mesh:
    """The (data, model) grid over the world's ranks; data_parallel=-1
    takes every rank the model axis leaves."""
    rank, n = world()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {n} ranks")
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        if n == 1:
            raise ValueError(
                f"a grid of data_parallel*model_parallel = {data_parallel}*"
                f"{model_parallel} ranks needs a process group of that many ranks: "
                f"launch one process per rank with `{LAUNCHER} --distributed true`")
        raise ValueError(
            f"data_parallel*model_parallel = {data_parallel}*{model_parallel} != {n} ranks")
    backend = dist.get_backend() if n > 1 else "gloo"
    return Mesh(data_parallel, model_parallel, rank, backend)


def rank_devices(use_gpu: bool, device) -> list[torch.device]:
    """Each local rank's device: the CPU, or cuda:<device[i]> for local rank
    i, one entry of --device per local rank of the launcher."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if not use_gpu:
        return [torch.device("cpu")] * local_world
    indices = list(device) if isinstance(device, (list, tuple)) else [device]
    if len(indices) != local_world:
        raise ValueError(
            f"--device {' '.join(map(str, indices))}: one entry per local rank, "
            f"{local_world} local ranks (--device 0 0 puts two ranks on card 0)")
    return [torch.device("cuda", int(i)) for i in indices]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a card of its own, gloo on the CPU or where
    ranks share a card."""
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    return "nccl" if len({d.index for d in devices}) == len(devices) else "gloo"


def init_distributed(use_gpu: bool, device) -> torch.device:
    """Start the world from the launcher's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--distributed true needs the launcher's environment (RANK, WORLD_SIZE): "
            f"start the ranks with `{LAUNCHER}`")
    devices = rank_devices(use_gpu, device)
    mine = devices[int(os.environ.get("LOCAL_RANK", "0"))]
    if mine.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--use_gpu true but CUDA is not available; pass "
                               "--use_gpu false to run the ranks on the CPU")
        torch.cuda.set_device(mine)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(devices), init_method="env://",
                                timeout=TIMEOUT)
    return mine


def data_slice(n: int, mesh: Mesh) -> slice:
    """The rows of a global batch of `n` that the rank's data index takes."""
    d = mesh.shape[DATA_AXIS]
    if n % d:
        raise ValueError(f"batch {n} must be divisible by data_parallel={d}")
    per = n // d
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, *arrays):
    """Each array's rows of this rank's data index (the batch split over the
    data axis; the loader's drop_last or the test phase's padding makes the
    batch divisible)."""
    if mesh.shape[DATA_AXIS] == 1:
        return arrays
    rows = data_slice(len(arrays[0]), mesh)
    return tuple(a[rows] for a in arrays)
