"""The serving entry point, the sharded serving run and the multi-rank dry run.

Counterparts of `entry()` and `dryrun_multichip()` in `__graft_entry__.py`:

  * `entry()`: the flagship CTR-GCN's eval forward and its input, a callable
    and example arguments that a harness can call, time or
    `torch.export.export` (tools/export_serving.py writes such an artifact);
  * `serve_sharded(artifact, inputs)`: an artifact that
    tools/export_serving.py exported with `--data_parallel N` (at the
    per-rank batch B/N, N recorded in the file) run on N ranks, each on its
    rows of the batch, rank 0 gathering the logits;
  * `dryrun_multichip(n, device)`: the parallel layer on n ranks that it
    launches itself (parallel/launch.py; gloo), in one world: one DP step
    of CTR-GCN over (n, 1), and over the (n/2, 2) grid (for even n) the
    joint ring of CTR-GCN, of the CTR-GCN at configs/scene256.yaml's widths
    and of ST-GCN, the tensor-parallel head and the fusion model's
    tensor-parallel attention MLP, and the time-sharded CTR-GCN, ST-GCN and
    fusion model (its CTR-GCN's frames split, its RGB trunk whole on every
    rank); the ring's unit op, output and VJP, against the dense plain
    version at each block's shape of both CTR-GCNs. Each mode is held to the single-rank
    step on the same device and the same global batch (the first step's
    loss within 1e-4 of it, SP's within 1e-4 of DP's as the JAX dry run
    holds them); it prints the JAX dry run's summary line with the port's
    numbers and returns every rank's record for finer checks (chip_smoke.py
    phase 16 holds each mode's gradients and state to an f64 run). Both run
    on the card unless `device` asks for the CPU.
    `full=True` runs the NW-UCLA CTR-GCN at full width (base_channel 64,
    T = 52, batch 16, 3 steps), scene256 (V = 256, T = 32, batch 8) and
    configs/nucla/cross_modal.yaml's fusion model (224 x 224 images);
    otherwise small shapes that run on the CPU in seconds.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

UCLA = dict(num_class=10, num_point=20, num_person=1, graph="ucla",
            graph_args={"labeling_mode": "spatial"})
DRYRUN_LR = 0.05
# the first step's loss of each mode against the single rank's, as JAX's
# dry run holds SP to DP and the ring to the dense step
LOSS_RTOL = 1e-4
# the ring's unit op against the dense plain version, per part a share of
# its max |plain|: the output as chip_smoke.py holds K1 to its plain version
# (1e-5), the gradients as it holds K3 (1e-4; alpha's, one sum over every
# element, 1e-3)
UNIT_PARTS = ("out", "dx1s", "dx2s", "dx3s", "dw4s", "db4s", "dalpha", "dAs")
UNIT_RTOL = dict.fromkeys(UNIT_PARTS, 1e-4) | {"out": 1e-5, "dalpha": 1e-3}


def _cuda_unless_cpu(device) -> str:
    """`device`, the card when it is None; raises where the card is asked
    for and CUDA is not available."""
    device = str(device or "cuda")
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the plain "
                           "versions on the CPU")
    return device


def entry(device: str | torch.device | None = None):
    """(fn, example_args): the NW-UCLA CTR-GCN (models/ctrgcn.py:
    create_ctrgcn_nucla, seed 0) in eval mode and a batch of 8 clips (T =
    52, V = 20, one person) from a seeded normal, on the card unless `device`
    asks for the CPU; ``fn(*example_args)`` are the logits (8, 10), through
    K1 on the card. Without CUDA and without device="cpu" it raises."""
    from .models import create_ctrgcn_nucla

    device = torch.device(_cuda_unless_cpu(device))
    model = create_ctrgcn_nucla().to(device).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 3, 52, 20, 1).astype(np.float32))
    return model, (x.to(device),)


# -- the sharded serving run ---------------------------------------------------

def artifact_data_parallel(path: str) -> int:
    """The N a serving artifact was exported for (1 for an unsharded one)."""
    extra = {"data_parallel": ""}
    torch.export.load(path, extra_files=extra)
    return int(extra["data_parallel"] or 1)


def _serve_rank(mesh_rank: int = 0, world: int = 1, *, artifact: str, inputs,
                device: str = "cpu"):
    """One rank of `serve_sharded`: its rows through the artifact; the
    gathered logits on rank 0."""
    from . import ops  # noqa: F401  (registers the custom ops the artifact calls)
    from .parallel import comm
    from .parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(world, 1)
    program = torch.export.load(artifact)
    with torch.no_grad():
        out = program.module()(*(torch.from_numpy(a).to(device)
                                 for a in shard_batch(mesh, *inputs)))
    logits = comm.all_gather(out.contiguous(), mesh.data, 0)
    return logits.cpu() if mesh_rank == 0 else None


def serve_sharded(artifact: str, inputs, device: str | None = None, timeout: float = 600):
    """The logits of `inputs` (numpy, the whole batch) through an artifact
    exported with --data_parallel N, on N ranks (gloo), each on its rows; on
    the card unless `device` asks for the CPU (without CUDA it raises)."""
    from .parallel.launch import run_ranks

    device = _cuda_unless_cpu(device)
    n = artifact_data_parallel(artifact)
    results = run_ranks("tamgcn_tpu_torch.serving:_serve_rank", n, dict(
        artifact=os.path.abspath(artifact), inputs=[np.asarray(a) for a in inputs],
        device=device), timeout=timeout)
    return results[0]


# -- the multi-rank dry run ------------------------------------------------------

def _perturbed(model, seed: int) -> dict:
    """The model's state with alpha, the TAM offset convs and gcn1/bn off
    their degenerate init (a zero offset branch makes the step's gradients
    rounding-sized)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g, dtype=t.dtype)
            if name.endswith("gcn1.alpha"):
                t.copy_(0.5 * noise)
            elif "offset_conv.weight" in name:
                t.add_(0.3 * noise)
            elif name.endswith("gcn1.bn.weight"):
                t.copy_(1.0 + 0.1 * noise)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _clips(rs, n, T, V, classes):
    return (rs.randn(n, 3, T, V, 1).astype(np.float32), rs.randint(0, classes, n))


def _unit_shapes(net, batch: int, T: int, V: int) -> list:
    """(N, T, V, C, R) of the unit op of each block of a CTR-GCN."""
    shapes = []
    for blk in net.blocks:
        shapes.append((batch, T, V, blk.gcn1.out_channels, blk.gcn1.R))
        T = -(-T // blk.stride)
    return shapes


def dryrun_plan(n: int, full: bool = False, weights: dict | None = None,
                batches=None) -> dict:
    """The dry run's modes: {name: train_on_grid's keyword arguments} and the
    shapes of the ring unit op's check (each block's of both CTR-GCNs, once
    each). `weights` and `batches` (the CTR-GCN's) replace the seeded ones."""
    from .models import get_model

    model_axis = 2 if n % 2 == 0 else 1
    data_axis = n // model_axis
    rs = np.random.RandomState(0)
    bc, T, batch, steps = (64, 52, 16, 3) if full else (16, 16, 2 * n, 1)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    ctr_args = dict(UCLA, base_channel=bc)
    ctr_net = get_model("ctrgcn", generator=gen(1), **ctr_args)
    ctr_w = weights or _perturbed(ctr_net, 2)
    ctr_b = batches or [_clips(rs, batch, T, 20, 10) for _ in range(steps)]
    scene_V, scene_T, scene_batch = (256, 32, 8) if full else (64, 8, 2 * data_axis)
    scene_args = dict(num_class=10, num_point=scene_V, num_person=1, graph="synthetic",
                      graph_args={"labeling_mode": "spatial", "num_node": scene_V},
                      base_channel=bc)
    scene_net = get_model("ctrgcn", generator=gen(3), **scene_args)
    scene_w = _perturbed(scene_net, 4)
    st_args = dict(UCLA, in_channels=3)
    st_w = get_model("stgcn", generator=gen(5), **st_args).state_dict()
    side, fusion_batch = (224, 16) if full else (32, 2 * data_axis)
    fusion_args = dict(UCLA, in_channels_rgb=15, freeze_gcn_bn=False)
    fusion_w = get_model("resnet_gcn_attention", generator=gen(6), **fusion_args).state_dict()
    fusion_b = [((rs.randn(fusion_batch, 3, T, 20, 1).astype(np.float32),
                  rs.randn(fusion_batch, 15, side, side).astype(np.float32)),
                 rs.randint(0, 10, fusion_batch))]
    ctr = dict(model="ctrgcn", model_args=ctr_args, weights=ctr_w, batches=ctr_b)
    grid = dict(data_parallel=data_axis, model_parallel=model_axis)
    modes = {
        "dp": dict(ctr, data_parallel=n, model_parallel=1),
        "ring": dict(ctr, **grid, graph_partition="ring"),
        "tp": dict(ctr, **grid, batches=ctr_b[:1]),
        "sp": dict(ctr, **grid, sequence_parallel=True),
        "scene_ring": dict(model="ctrgcn", model_args=scene_args, weights=scene_w,
                           batches=[_clips(rs, scene_batch, scene_T, scene_V, 10)],
                           **grid, graph_partition="ring", profile=full),
        "stgcn_ring": dict(model="stgcn", model_args=st_args, weights=st_w,
                           batches=[_clips(rs, batch, T, 20, 10)], **grid,
                           graph_partition="ring"),
        "fusion_tp": dict(model="resnet_gcn_attention", model_args=fusion_args,
                          weights=fusion_w, batches=fusion_b, **grid),
    }
    # the time-sharded ST-GCN and fusion model on their ring's and TP's steps
    for name, like in (("stgcn_sp", "stgcn_ring"), ("fusion_sp", "fusion_tp")):
        modes[name] = dict(modes[like], graph_partition="none", sequence_parallel=True)
    for spec in modes.values():
        spec.setdefault("lr", DRYRUN_LR)
    # the unit op of each block at the rank's rows, the ring at the model axis
    shapes = (_unit_shapes(ctr_net, batch // data_axis, T, 20)
              + _unit_shapes(scene_net, scene_batch // data_axis, scene_T, scene_V))
    return {"n": n, "data_axis": data_axis, "model_axis": model_axis, "modes": modes,
            "unit_shapes": list(dict.fromkeys(shapes))}


def ring_unit_errors(mesh_rank: int = 0, world: int = 1, shapes=(), model_axis: int = 2,
                     device: str = "cpu") -> list:
    """{part: max |ring - plain| / max |plain|} at each shape, for the unit
    op's output and its VJP of a seeded cotangent (UNIT_PARTS): the ring
    over a (world / model_axis, model_axis) grid on `device`, against the
    dense plain version (ops/aggregation.py:unit_ctr_gc_plain) on the same
    inputs."""
    from .ops.aggregation import unit_ctr_gc_plain
    from .parallel.graph_parallel import ring_unit_ctr_gc
    from .parallel.mesh import make_mesh

    mesh = make_mesh(world // model_axis, model_axis)
    out = []
    for i, (N, T, V, C, R) in enumerate(shapes):
        g = torch.Generator().manual_seed(100 + i)
        S = 3

        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g)).to(device)

        args = (rnd(N, S, V, R), rnd(N, S, V, R), rnd(N, T, V, S * C), rnd(S, R, C, scale=0.1),
                rnd(S, C, scale=0.1), rnd(1, scale=0.3), rnd(S, V, V, scale=0.1))
        cotangent = rnd(N, T, V, C)
        parts = []
        for fn in (lambda *a: ring_unit_ctr_gc(*a, mesh.model), unit_ctr_gc_plain):
            leaves = [a.clone().requires_grad_() for a in args]
            y = fn(*leaves)
            y.backward(cotangent)
            parts.append([y.detach()] + [a.grad for a in leaves])
        ring, plain = parts
        out.append({part: float((r - p).abs().max() / p.abs().max())
                    for part, r, p in zip(UNIT_PARTS, ring, plain)})
        del parts, ring, plain
    return out


def _dryrun_rank(mesh_rank: int = 0, world: int = 1, *, plan: dict, device: str) -> dict:
    """Every mode of the plan on this rank (parallel/drive.py:train_on_grid)
    and the ring unit op's errors."""
    from .parallel.drive import train_on_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {name: train_on_grid(mesh_rank, world, device=device, **spec)
           for name, spec in plan["modes"].items()}
    out["unit_errors"] = ring_unit_errors(mesh_rank, world, plan["unit_shapes"],
                                          plan["model_axis"], device)
    return out


# the grid's arguments of train_on_grid: the single-rank reference drops them
GRID_ARGS = ("data_parallel", "model_parallel", "graph_partition", "sequence_parallel")


def verify_dryrun(plan: dict, ranks: list, device: str) -> dict:
    """The dry run's checks (module docstring) of every rank's record, the
    single-rank steps run here: {"single": each model's single-rank record,
    "summary": JAX's summary line}. Raises where a check fails."""
    from .parallel.drive import train_on_grid

    modes = plan["modes"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    single = {name: train_on_grid(device=device, **{k: v for k, v in modes[name].items()
                                                    if k not in GRID_ARGS})
              for name in ("dp", "scene_ring", "stgcn_ring", "fusion_tp")}
    reference = {"dp": "dp", "ring": "dp", "tp": "dp", "sp": "dp", "scene_ring": "scene_ring",
                 "stgcn_ring": "stgcn_ring", "fusion_tp": "fusion_tp",
                 "stgcn_sp": "stgcn_ring", "fusion_sp": "fusion_tp"}
    for name, ref in reference.items():
        want = single[ref]["losses"][0]
        for r in ranks:
            got = r[name]["losses"][0]
            if not (math.isfinite(got) and abs(got - want) <= LOSS_RTOL * max(1.0, abs(want))):
                raise AssertionError(f"dry run {name}: rank {r[name]['rank']}'s first loss "
                                     f"{got} against the single rank's {want}")
    dp, sp = ranks[0]["dp"]["losses"][0], ranks[0]["sp"]["losses"][0]
    if abs(sp - dp) > LOSS_RTOL * max(1.0, abs(dp)):
        raise AssertionError(f"sp train loss {sp} != dp train loss {dp}")
    for r in ranks:
        for shape, errs in zip(plan["unit_shapes"], r["unit_errors"]):
            for part, err in errs.items():
                if not err <= UNIT_RTOL[part]:
                    raise AssertionError(
                        f"ring unit op vs the dense plain op at (N, T, V, C, R) = {shape}, "
                        f"rank {r['dp']['rank']}: {part} {err:.3e} of max |plain| > "
                        f"{UNIT_RTOL[part]}")
    unit = max(e["out"] for r in ranks for e in r["unit_errors"])
    summary = (
        f"dryrun_multichip ok: mesh data={plan['data_axis']} model={plan['model_axis']}, "
        f"loss={dp:.4f}, sp_train_loss={sp:.4f}, "
        f"ring_stgcn_loss={ranks[0]['stgcn_ring']['losses'][0]:.4f}, "
        f"ring_ctrgcn_loss={ranks[0]['ring']['losses'][0]:.4f}, "
        f"ring_kernel_body_maxerr={unit:.2e}")
    print(summary, flush=True)
    return {"single": single, "summary": summary}


def dryrun_multichip(n_devices: int = 2, device: str | None = None, full: bool = False,
                     weights: dict | None = None, batches=None,
                     timeout: float = 1200) -> dict:
    """The dry run (module docstring) on n_devices ranks, on the card unless
    `device` asks for the CPU (without CUDA it raises): {"plan", "ranks"
    (each rank's record of each mode), "single" (the single-rank reference
    of each model), "summary"}. Raises where a check fails."""
    from .parallel.launch import run_ranks

    device = _cuda_unless_cpu(device)
    plan = dryrun_plan(n_devices, full, weights, batches)
    ranks = run_ranks("tamgcn_tpu_torch.serving:_dryrun_rank", n_devices,
                      {"plan": plan, "device": device}, timeout=timeout)
    return {"plan": plan, "ranks": ranks, **verify_dryrun(plan, ranks, device)}
