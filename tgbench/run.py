"""Run one cell of the benchmark of tamgcn_tpu_torch on the card(s) of this machine.

    python3 tgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the numbers that decide `correct` are printed
beside their limits as the last lines of standard error and, under
"checks", last in the result. With --trace 0 the result holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
torch.profiler trace of part of the window. Without a CUDA card, or with
fewer cards than the cell asks for, it exits 1 and prints no result.

Every cache the program or torch builds goes to a fixed directory inside
the checkout: the port builds its kernels into tamgcn_tpu_torch/_build/,
and the harness points TORCH_EXTENSIONS_DIR, TRITON_CACHE_DIR and
TORCHINDUCTOR_CACHE_DIR at tgbench/.cache/. Clips are written under TMPDIR and removed at the end of the run.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def caches() -> None:
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from tgbench import harness

    bench = harness.manifest()
    chips = harness.workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tgbench: the cell {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {n}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = harness.execute(bench, args.workload, args.seed, args.seconds,
                                     bool(args.trace), device, T0, chips)
    return finish(result, checks)


def finish(result: dict, checks: list) -> int:
    """Print the checks and then the result line, unless the process holds
    a module it may not: checked last, after the window, the per-layer
    readers and the reference, so that whatever any of them loaded counts."""
    from tgbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"tgbench: the benchmark's process holds {', '.join(found)}; it may import "
              f"none of {', '.join(harness.FORBIDDEN)}; no result", file=sys.stderr, flush=True)
        return 1
    for c in sorted(checks, key=lambda c: c.compared):
        if c.compared:
            print(f"check {c.name}: {c.value!r} against the limit {c.limit!r} "
                  f"({'passed' if c.passed else 'FAILED'})", file=sys.stderr, flush=True)
        else:
            print(f"reading {c.name}: {c.value!r} (not compared)", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
