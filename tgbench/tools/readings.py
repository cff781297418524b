"""Read a cell's compared numbers over many seeds in one process: the sound
program, the lower-precision control (the program's own bf16 path) and the
planted faults. The limits in limits/<cell>.json are set from what this
prints (PERF.md gives the readings and the rule).

    python3 tgbench/tools/readings.py --cell nucla-train --seeds 12 \\
        [--control 3] [--faults half_batch answer_altered] [--seconds 0] \\
        [--out chiprun_out/readings.jsonl]
    python3 tgbench/tools/readings.py --cell nucla-train --seeds 0 --control 0 \
        --witness 0 3 8 9 10

Seeds are drawn large, from a fixed base. Training's numbers need no
window (--seconds 0); evaluation compares what a short window
at the cell's own load produced.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASE_SEED = 3_000_000_000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=0, help="index of the first seed")
    ap.add_argument("--control", type=int, default=3, help="seeds of the bf16 control")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--witness", type=int, nargs="*", default=[],
                    help="seed indices of a training cell's witness: sound computations of "
                         "the reference against each other (the sound seeds are 0-11)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from tgbench.run import caches

    caches()
    import torch

    from tgbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    bench = harness.manifest()
    out = open(args.out, "a") if args.out else None
    plan = []
    for cell in args.cell:
        plan += [(cell, BASE_SEED + args.first + i, "sound", None, None)
                 for i in range(args.seeds)]
        plan += [(cell, BASE_SEED + 1000 + i, "control", None, {"dtype": "bfloat16"})
                 for i in range(args.control)]
        plan += [(cell, BASE_SEED + 2000 + i, f, f, None)
                 for f in args.faults for i in range(args.fault_seeds)]
        plan += [(cell, BASE_SEED + i, "witness", None, None) for i in args.witness]
    for cell, seed, variant, fault, overrides in plan:
        if variant == "witness":
            line = witness(bench, cell, seed, device)
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
            continue
        t0 = time.perf_counter()
        try:
            result, checks = harness.execute(bench, cell, seed, args.seconds, False, device, t0,
                                             fault=fault, overrides=overrides)
            line = {"cell": cell, "seed": seed, "variant": variant,
                    "numbers": {c.name: c.value for c in checks},
                    "correct": result["correct"], "attempted": result["attempted"],
                    "setup_s": result["metrics"].get("setup_s", {}).get("value"),
                    "seconds": time.perf_counter() - t0}
        except Exception as e:  # a control or fault that crashes has failed
            line = {"cell": cell, "seed": seed, "variant": variant,
                    "error": f"{type(e).__name__}: {e}"[:400]}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


def witness(bench, cell, seed, device) -> dict:
    """The train check's numbers between sound computations of the same
    three steps at the cell's own size: the reference in float32 (TF32 off)
    and with cuDNN's TF32 (the program's precision) against float64, and
    with cuDNN's TF32 against float32 with TF32 off (the check's own
    reference, as the program is compared)."""
    import tempfile

    import torch

    from tgbench import clips, compare, harness, weights
    from tgbench.drivers import train_loop
    from tgbench.reference import model as ref_model, sgd

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        run = harness.make_run(bench, cell, seed, device, tmp)
        cfg, args = run.config, run.config["trainer"]
        split = clips.write(os.path.join(tmp, "clips"), cfg["data"], seed, ("train",))["train"]
        repeat = args["train_feeder_args"].get("repeat", 1)
        n = len(split.clips) * repeat
        batch = args["batch_size"]
        batches, lrs = train_loop.reference_inputs(run, split, n, batch, n // batch)
        w0 = weights.make(cfg["model"], seed, device)
        wd = args["weight_decay"]
        runs = {}
        for label, dtype, tf32 in (("f64", torch.float64, False), ("f32", torch.float32, False),
                                   ("f32 cuDNN TF32", torch.float32, True)):
            w = {k: v.to(dtype) for k, v in w0.items()}
            b = [(x.to(dtype), y) for x, y in batches]
            with compare.reference_numerics():
                torch.backends.cudnn.allow_tf32 = tf32
                runs[label] = sgd.train_steps(
                    lambda ww, x: ref_model.forward(cfg["model"], ww, x, train=True),
                    w, b, lrs, wd)
        w64 = {k: v.double() for k, v in w0.items()}

        def as64(r):
            losses, first, after, logits = r
            return (losses, {k: v.double() for k, v in first.items()},
                    {k: v.double() for k, v in after.items()}, logits.double())

        out = {}
        for label, against in (("f32", "f64"), ("f32 cuDNN TF32", "f64"),
                               ("f32 cuDNN TF32", "f32")):
            losses, first, after, logits = as64(runs[label])
            program = (losses, first, {k: after[k] - w64[k] for k in first}, logits)
            numbers, notes = train_loop.step_numbers(program, as64(runs[against]), w64)
            out[f"{label} against {against}"] = {"numbers": numbers, "notes": notes}
    return {"cell": cell, "seed": seed, "variant": "witness: sound computations of the same steps",
            **out}


if __name__ == "__main__":
    sys.exit(main())
