"""Serving export: a trained model's eval forward as a `torch.export` artifact.

Counterpart of tools/export_serving.py (jax.export to StableHLO there).
`torch.export.export` traces the model's eval forward once, with the
weights in it, and `torch.export.save` writes one `.pt2` file that a later
process loads with `torch.export.load` and calls, without the model code or
the config. The port's eval kernels are custom ops (namespace `tamgcn`):
`tamgcn::unit_ctr_gc` (K1 in both designs and forms,
ops/aggregation.py:unit_ctr_gc_op) and `tamgcn::gcn_tcn_block` (K5,
ops/gcn_tcn_block.py:gcn_tcn_block_op). Each is one node of the exported
graph, run by the kernel on a CUDA device and by its plain version on the
CPU.

The serving contract: a process that loads an artifact imports
`tamgcn_tpu_torch.ops` (which registers the ops) and nothing else of the
port:

    import torch, tamgcn_tpu_torch.ops
    program = torch.export.load("ctrgcn.pt2")
    logits = program.module()(x)     # x on the device the artifact was held on

Without the ops registered, `torch.export.load` raises.

    python -m tamgcn_tpu_torch.tools.export_serving -c configs/nucla/gcn.yaml \\
        --out ctrgcn.pt2 [--weights W] [--batch 64] [--time 52] \\
        [--poly_batch | --fast_eval] [--platforms cuda|cpu|cpu,cuda]

  * --poly_batch exports with a symbolic batch (`torch.export.Dim`): the
    port's kernels take any batch, so the artifact keeps the custom ops
    (the JAX tool drops to the XLA aggregation there, its Pallas grids
    needing static shapes);
  * --fast_eval exports the folded inference engine
    (models/ctrgcn_infer.py:FoldedFastEval, folded at export): K5 where
    ops/gcn_tcn_block.py:k5_takes takes a block, else K1 and matmuls; CTR-GCN
    only, and at a fixed batch, as the JAX tool;
  * --platforms: the artifact is exported on the first platform listed and
    held on each, moved there with `torch.export.passes.move_to_device_pass`
    (the custom ops run the kernels on cuda and the plain versions on the
    cpu); the default is the card, and without CUDA it raises unless `cpu`
    is asked for. A TPU is not a platform of the port;
  * --weights takes what the trainer's --weights takes
    (train/checkpoint.py:read_weights): the port's `.pt`, a checkpoint
    directory (its best.pt, else its latest epoch{n}.pt), a reference
    `.npz` or a Flax `.npz`; omitted, the seeded init;
  * --data_parallel N > 1 (the JAX tool's :177-195): the artifact is
    exported at the per-rank batch B/N and records N (an extra file of the
    .pt2, serving.py:artifact_data_parallel); serving.py:serve_sharded runs
    it on N ranks (gloo), each on its rows of a batch of B, rank 0 gathering
    the logits, and the tool holds that against the live model on the whole
    batch. B not divisible by N raises, as does --poly_batch with it (the
    per-rank batch is fixed at export).

The tool reloads its own artifact and holds it against `ep.module()` of
the program it saved (rtol = atol = 2e-5, as the JAX tool holds its
artifact against the jitted function it serialised), and against the live
eager model (within 1e-4 x max |logit|), at the example batch and, with
--poly_batch, at batch // 2. It prints one JSON line, `metric:
serving_export_roundtrip`. Numerics run with TF32 off.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import log

SKELETON_MODELS = ("ctrgcn", "stgcn", "models.ctrgcn.Model", "models.stgcn.Model")
RGB_MODELS = ("resnet_only", "models.resnet_only.Model")
FUSION_MODELS = ("resnet_gcn_attention",
                 "models.resnet_gcn_attention.ResNet_GCN_Attention")
PLATFORMS = ("cpu", "cuda")
# the reloaded artifact against the program it saved (the JAX tool's), and
# against the live eager model as a share of its max |logit|
ROUNDTRIP_TOL = 2e-5
EAGER_TOL = 1e-4


def image_size(feeder_args: dict) -> int:
    """The RGB input's side: `size` or, as the synthetic and ST-ROI feeders
    name it, `image_size` (the JAX tool reads only `size`)."""
    return int(feeder_args.get("size", feeder_args.get("image_size", 224)))


def example_shapes(arg, batch: int, time_steps: int) -> list[tuple]:
    """The input shapes of the config's model family (the JAX tool's rules)."""
    ma = dict(arg.model_args or {})
    fa = dict(arg.test_feeder_args or {})
    if arg.model in SKELETON_MODELS:
        return [(batch, ma.get("in_channels", 3), time_steps,
                 ma.get("num_point", 25), ma.get("num_person", 2))]
    if arg.model in RGB_MODELS:
        frames = int(fa.get("temporal_rgb_frames", 1))
        size = image_size(fa)
        return [(batch, 3 * frames, size, size)]
    if arg.model in FUSION_MODELS:
        size = image_size(fa)
        return [(batch, ma.get("in_channels_gcn", 3), time_steps,
                 ma.get("num_point", 20), ma.get("num_person", 1)),
                (batch, ma.get("in_channels_rgb", 15), size, size)]
    raise SystemExit(
        f"export_serving: no example-input rule for model {arg.model!r} "
        f"(supported: {SKELETON_MODELS + RGB_MODELS + FUSION_MODELS})")


def parse_platforms(text: str | None) -> list[str]:
    """--platforms -> device types; the card by default. Raises on a TPU (or
    any platform the port lacks) and on cuda without CUDA."""
    platforms = [p.strip() for p in (text or "cuda").split(",") if p.strip()]
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"--platforms {p!r}: the port exports for {PLATFORMS}, "
                             "not for a TPU (the JAX tool's platform)")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --platforms cpu to export and "
                           "hold the artifact on the CPU")
    return platforms


def checkpoint_path(path: str) -> str:
    """--weights as given, or for a directory its best.pt, else its latest
    epoch{n}.pt; a directory with neither exits naming it."""
    from ..train.checkpoint import latest_epoch

    if not os.path.isdir(path):
        return path
    if os.path.exists(os.path.join(path, "best.pt")):
        return os.path.join(path, "best.pt")
    latest = latest_epoch(path)
    if latest is None:
        raise SystemExit(f"no checkpoint found in {path}")
    return os.path.join(path, f"epoch{latest}.pt")


def build_model(arg, weights: str | None):
    """The config's model from --seed (or --weights), in eval mode, on the CPU."""
    from ..models import get_model
    from ..train.checkpoint import partial_update, port_state, read_weights

    model = get_model(arg.model, generator=torch.Generator().manual_seed(arg.seed),
                      **dict(arg.model_args or {}))
    if weights:
        form, contents, path = read_weights(checkpoint_path(weights))
        log(f"loaded weights: {path} ({form})")
        partial_update(model, port_state(form, contents, arg.model, model), log=log)
    return model.eval()


def serving_module(model, fast_eval: bool):
    """What the artifact computes: the model's eval forward, or with
    --fast_eval its folded engine (folded now)."""
    if not fast_eval:
        return model
    from ..models.ctrgcn import CTRGCN
    from ..models.ctrgcn_infer import FoldedFastEval

    if not isinstance(model, CTRGCN):
        raise SystemExit(f"--fast_eval exports the CTR-GCN engine, not a "
                         f"{type(model).__name__}")
    return FoldedFastEval(model)


def export(module, inputs, poly_batch: bool):
    """torch.export of `module` on `inputs` (no_grad), the batch symbolic
    with `poly_batch`."""
    dynamic = None
    if poly_batch:
        batch = torch.export.Dim("batch")
        dynamic = tuple({0: batch} for _ in inputs)
    with torch.no_grad():
        return torch.export.export(module, tuple(inputs), dynamic_shapes=dynamic)


def custom_op_nodes(program) -> dict[str, int]:
    """{op name: nodes} of the `tamgcn` custom ops in an exported graph."""
    out: dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("tamgcn."):
            out[name] = out.get(name, 0) + 1
    return out


def _close(got, want, what: str, rtol: float = 0.0, atol: float = 0.0) -> float:
    """|got - want| <= atol + rtol |want| elementwise; returns max |got - want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {float(diff.max()):.3e} (rtol {rtol}, "
                             f"atol {atol:.3e})")
    return float(diff.max())


def _close_to_live(got, live, what: str) -> float:
    """Within EAGER_TOL x max |logit| of the live model's logits."""
    return _close(got, live, what, atol=EAGER_TOL * float(live.detach().abs().max()))


def run(argv=None) -> dict:
    """Export, save, reload and check; returns the JSON record."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output artifact path (.pt2)")
    ap.add_argument("--weights", default=None,
                    help="what the trainer's --weights takes; default: the seeded init")
    ap.add_argument("--batch", type=int, default=None,
                    help="example batch size (default: the config's test_batch_size)")
    ap.add_argument("--time", type=int, default=52,
                    help="skeleton time steps (NW-UCLA resample length)")
    ap.add_argument("--poly_batch", action="store_true",
                    help="export with a symbolic batch dimension")
    ap.add_argument("--platforms", default=None,
                    help="comma list of cpu, cuda (default: cuda)")
    ap.add_argument("--fast_eval", action="store_true",
                    help="export the folded CTR-GCN inference engine (K5)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="export for N ranks, each serving batch / N rows")
    ns, rest = ap.parse_known_args(argv)
    if ns.fast_eval and ns.poly_batch:
        raise SystemExit("--fast_eval artifacts are exported at a fixed batch, as the "
                         "JAX tool's; drop --poly_batch")

    from ..train.config import base_parser, load_config

    arg = load_config(rest, parser=base_parser(add_help=False))
    batch = ns.batch or arg.test_batch_size
    ranks = max(1, ns.data_parallel)
    if ranks > 1:
        if ns.poly_batch:
            raise SystemExit("--data_parallel fixes the per-rank batch at export; drop "
                             "--poly_batch")
        if batch % ranks:
            raise SystemExit(f"batch {batch} must be divisible by data_parallel={ranks}")
    platforms = parse_platforms(ns.platforms)
    device = torch.device(platforms[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = build_model(arg, ns.weights).to(device)
    module = serving_module(model, ns.fast_eval)
    rs = np.random.RandomState(arg.seed)
    shapes = example_shapes(arg, batch, ns.time)
    whole = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device) for s in shapes]
    inputs = [x[:batch // ranks] for x in whole]  # one rank's rows

    t0 = time.perf_counter()
    program = export(module, inputs, ns.poly_batch)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    torch.export.save(program, ns.out, extra_files={"data_parallel": str(ranks)})
    export_s = time.perf_counter() - t0
    reloaded = torch.export.load(ns.out)

    with torch.no_grad():
        want = program.module()(*inputs)
        got = reloaded.module()(*inputs)
        live = model(*inputs)
    roundtrip = _close(got, want, "artifact vs the exported program",
                       rtol=ROUNDTRIP_TOL, atol=ROUNDTRIP_TOL)
    eager = _close_to_live(got, live, "artifact vs the live model")
    half_shape = None
    if ns.poly_batch:
        half = [x[:max(1, batch // 2)] for x in inputs]
        with torch.no_grad():
            got_half = reloaded.module()(*half)
            eager = max(eager, _close_to_live(got_half, model(*half),
                                              "artifact at batch // 2 vs the live model"))
        half_shape = list(got_half.shape)

    sharded = None
    if ranks > 1:
        from ..serving import serve_sharded

        got_all = serve_sharded(ns.out, [x.cpu().numpy() for x in whole], platforms[0])
        with torch.no_grad():
            sharded = _close_to_live(got_all, model(*whole),
                                     f"artifact on {ranks} ranks vs the live model")

    held = {}
    for p in platforms[1:]:
        from torch.export.passes import move_to_device_pass

        moved = move_to_device_pass(reloaded, torch.device(p))
        with torch.no_grad():
            out = moved.module()(*(x.to(p) for x in inputs))
        held[p] = _close_to_live(out, live, f"artifact on {p} vs the live model")

    record = {
        "metric": "serving_export_roundtrip",
        "artifact": ns.out,
        "bytes": os.path.getsize(ns.out),
        "platforms": platforms,
        "poly_batch": bool(ns.poly_batch),
        "fast_eval": bool(ns.fast_eval),
        "input_shapes": [list(x.shape) for x in inputs],
        "output_shape": list(got.shape),
        "half_batch_output_shape": half_shape,
        "nr_devices": ranks,
        "sharded_max_abs_err": sharded,
        "custom_ops": custom_op_nodes(reloaded),
        "export_seconds": export_s,
        "roundtrip_max_abs_err": roundtrip,
        "eager_max_abs_err": eager,
        "platform_max_abs_err": held,
    }
    return record


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
