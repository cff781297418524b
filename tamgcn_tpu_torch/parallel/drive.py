"""Drive the port's train step on a grid of ranks and report what it did.

`train_on_grid` is what one rank of the multi-rank dry run
(serving.py:dryrun_multichip) and of the CPU tests runs: it builds a model
from a state dict, wires it to the (data, model) grid of the world it runs
in (parallel/sharded.py:parallelize), packs it with the grid's gradient sum
(train/packing.py, GradientSum) and takes the packed train step on each
global batch it is given, its rows and, under sequence parallelism, its
frames (of its skeleton inputs). It returns every step's loss and hit count, the reduced gradient of
the last step and the state before the first step and after each step
(every tensor full: the tensor-parallel shards gathered), each step's wall
time, and on the card the kernel launches the steps made and, with
`profile`, the device time of the last step's kernels and of its copies
(torch.profiler). On the card it runs with TF32 off: its results are held
against other runs. With a world of one rank (no process group) it is the
single-process step, the reference the grid's steps are held to.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import comm
from .mesh import make_mesh, shard_batch
from .sequence import shard_time
from .sharded import GradientSum, full_state_dict, parallelize, sharded_dims


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _device_ms(prof):
    """(kernels, copies): the device time (ms) of the traced step, its
    kernels apart from its memory copies and sets; None where the trace
    holds no device time."""
    kernels = copies = 0.0
    for e in prof.key_averages():
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.self_device_time_total
        else:
            kernels += e.self_device_time_total
    if kernels + copies <= 0:
        return None, None
    return kernels / 1e3, copies / 1e3


def _launches():
    if not torch.cuda.is_available():
        return {}
    from ..ops.cuda import launch_counts

    return launch_counts()


def full_grads(model) -> dict:
    """{parameter name: its gradient}, the shards of the sharded ones
    gathered."""
    dims = sharded_dims(model)
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in dims:
            dim, group = dims[name]
            g = comm.all_gather(g, group, dim)
        out[name] = g.cpu().clone()
    return out


def train_on_grid(mesh_rank: int = 0, world: int = 1, *, model: str, model_args: dict,
                  weights: dict, batches: list, data_parallel: int = -1,
                  model_parallel: int = 1, graph_partition: str = "none",
                  sequence_parallel: bool = False, lr: float = 0.01,
                  weight_decay: float = 1e-4, dtype=torch.float32, device: str = "cpu",
                  seed: int = 0, profile: bool = False) -> dict:
    """The packed train step on each (x, y) of `batches` (numpy, the global
    batch; x an array or a tuple of the model's inputs) on this rank of the
    grid; what it did (module docstring)."""
    from ..models import get_model
    from ..train.packing import PackedTrainState, make_fused_train_step

    if device == "cuda":
        torch.cuda.set_device(0)
        # numerics checks: no TF32 rounding on either side of a comparison
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(data_parallel, model_parallel)
    sp = sequence_parallel and mesh.model.size > 1
    net = get_model(model, **model_args).to(dtype)
    net.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in weights.items()})
    parallelize(net, mesh, graph_partition, sp)
    net.to(device).train()
    state = PackedTrainState(net, "SGD", nesterov=True, weight_decay=weight_decay,
                             seed=seed, mesh=mesh if mesh.size > 1 else None)
    if mesh.size > 1:
        state.reduce = GradientSum(state, mesh, sp)
    step = make_fused_train_step(state)
    state.set_lr(lr)
    out = {"losses": [], "hits": [], "step_ms": [], "busy_ms": None, "copy_ms": None,
           "states": [{k: v.detach().cpu().clone()
                       for k, v in full_state_dict(net).items()}]}
    before = _launches()
    for i, (x, y) in enumerate(batches):
        *xs, y = shard_batch(mesh, *(x if isinstance(x, tuple) else (x,)), y)
        if sp:  # the skeleton inputs' frames; images whole (the JAX trainer's _sp_put)
            xs = tuple(shard_time(a, mesh) if a.ndim in (3, 5) else a for a in xs)
        xs = [torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype) for a in xs]
        yt = torch.from_numpy(np.asarray(y, np.int64)).to(device)
        if device == "cuda":
            torch.cuda.synchronize()
        profiler = (_profiler() if profile and device == "cuda"
                    and i == len(batches) - 1 else contextlib.nullcontext())
        with profiler as prof:
            t0 = time.perf_counter()
            loss, hits = step(*xs, yt)
            if device == "cuda":
                torch.cuda.synchronize()
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if prof is not None:
            out["busy_ms"], out["copy_ms"] = _device_ms(prof)
        out["losses"].append(float(loss))
        out["hits"].append(int(hits))
        out["states"].append({k: v.detach().cpu().clone()
                              for k, v in full_state_dict(net).items()})
    after = _launches()
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    out["grads"] = full_grads(net)
    out["rank"] = mesh.rank
    return out
