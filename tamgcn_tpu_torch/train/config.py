"""Config/flag system: CLI > YAML > defaults, with unknown-key hard errors.

A copy of tamgcn_tpu/train/config.py with the same flag set, so every
shipped YAML config parses; `check_supported` rejects --use_pallas, which
has no meaning in the port, and `resolve_device` maps --use_gpu/--device
for one process. The parallel flags build the grid of ranks
(parallel/mesh.py, parallel/sharded.py:parallelize); the values and
combinations the JAX package rejects raise there, naming the flag.

Capability parity with the reference's three-tier precedence (double argparse
pass with set_defaults, processor/io.py:31-50, unknown-YAML-key assertion
:43-46) and the nested-dict flag (`DictAction`,
torchlight/torchlight/io.py:192-203) — but parsed with ast.literal_eval
instead of the reference's `eval` (flagged in SURVEY §5 as a must-not-copy).
"""
from __future__ import annotations

import argparse
import ast
from typing import Any

import yaml


def safe_literal(text: str) -> Any:
    """Parse '1', '0.1', 'True', '[50]', '{a: 1}'-style YAML/py literals safely."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return yaml.safe_load(text)


class DictAction(argparse.Action):
    """--model_args "{'num_class': 10}" or repeated key=value pairs."""

    def __call__(self, parser, namespace, values, option_string=None):
        current = dict(getattr(namespace, self.dest, None) or {})
        if isinstance(values, str):
            values = [values]
        for item in values:
            if "=" in item and not item.lstrip().startswith(("{", "[")):
                k, v = item.split("=", 1)
                current[k.strip()] = safe_literal(v)
            else:
                parsed = safe_literal(item)
                if not isinstance(parsed, dict):
                    raise argparse.ArgumentError(
                        self, f"expected dict literal or key=value, got {item!r}"
                    )
                current.update(parsed)
        setattr(namespace, self.dest, current)


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def base_parser(add_help: bool = False) -> argparse.ArgumentParser:
    """Shared trainer flags (superset of reference processor/processor.py:170-213
    and recognition_rgb.py:128-143)."""
    p = argparse.ArgumentParser(add_help=add_help, description="tamgcn_tpu_torch trainer")
    p.add_argument("-w", "--work_dir", default="./work_dir/tmp")
    p.add_argument("-c", "--config", default=None)

    # phase / lifecycle
    p.add_argument("--phase", default="train", choices=["train", "test"])
    p.add_argument("--save_result", type=str2bool, default=False)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--resume", type=str2bool, default=False,
                   help="restore the latest work-dir checkpoint and continue "
                        "(crash recovery; reference equivalent is manual "
                        "--start_epoch + --weights)")
    p.add_argument("--num_epoch", type=int, default=80)
    p.add_argument("--seed", type=int, default=1)

    # logging / eval cadence
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=10)
    p.add_argument("--eval_interval", type=int, default=5)
    p.add_argument("--save_log", type=str2bool, default=True)
    p.add_argument("--print_log", type=str2bool, default=True)
    p.add_argument("--show_topk", type=int, default=[1, 5], nargs="+")

    # feeder
    p.add_argument("--feeder", default="nucla_gcn")
    p.add_argument("--num_worker", type=int, default=4)
    p.add_argument("--train_feeder_args", action=DictAction, nargs="+", default=dict())
    p.add_argument("--test_feeder_args", action=DictAction, nargs="+", default=dict())
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--test_batch_size", type=int, default=64)
    p.add_argument("--debug", type=str2bool, default=False)

    # model
    p.add_argument("--model", default=None)
    p.add_argument("--model_args", action=DictAction, nargs="+", default=dict())
    p.add_argument("--weights", default=None,
                   help="checkpoint dir or reference-exported .npz weights")
    p.add_argument("--ignore_weights", type=str, default=[], nargs="+")
    p.add_argument("--freeze_params", type=str, default=[], nargs="+",
                   help="param path prefixes excluded from optimisation "
                        "(e.g. 'gcn' for the frozen fusion extractor)")

    # optimisation (reference recognition_rgb.py:136-141 + gcn.yaml extras)
    p.add_argument("--optimizer", default="SGD", choices=["SGD", "Adam"])
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--step", type=int, default=[], nargs="+")
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--warm_up_epoch", type=int, default=0)
    p.add_argument("--nesterov", type=str2bool, default=True)
    p.add_argument("--weight_decay", type=float, default=0.0001)

    # device / parallelism: one process per rank of the (data, model) grid
    p.add_argument("--device", type=int, default=0, nargs="+",
                   help="CUDA device index; with --distributed true one entry "
                        "per local rank (--device 0 0: two ranks on card 0)")
    p.add_argument("--use_gpu", type=str2bool, default=True,
                   help="run on cuda:<device> (raises without CUDA); "
                        "false runs on the CPU")
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="ranks on the grid's data axis; -1 = all the model "
                        "axis leaves")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks on the grid's model axis (the joint ring, the "
                        "tensor-parallel head, the sequence axis)")
    p.add_argument("--graph_partition", default="none",
                   choices=["none", "ring"],
                   help="'ring': edge-partition the joint axis over the "
                        "grid's model axis, the unit op of each ring step "
                        "on the resident joint block (parallel/graph_parallel.py)")
    p.add_argument("--use_pallas", type=str2bool, default=None,
                   help="not ported: kernels are chosen by tensor device")
    p.add_argument("--fast_eval", type=str2bool, default=False,
                   help="score CTR-GCN evaluation through the folded "
                        "whole-block engine (models/ctrgcn_infer.py; the "
                        "CUDA kernel K5 on the card)")
    p.add_argument("--sequence_parallel", type=str2bool, default=False,
                   help="split the clips' TIME axis over the grid's model "
                        "axis, train and eval (CTR-GCN; requires "
                        "model_parallel dividing T; halo exchanges before "
                        "the temporal convs, parallel/sequence.py)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the train "
                        "phase (CPU and, on the card, CUDA activity) here")
    p.add_argument("--debug_nans", type=str2bool, default=False,
                   help="stop at the first non-finite loss, logit, gradient, "
                        "parameter or BN statistic with a FloatingPointError "
                        "naming the module that produced it")
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="start the process group from the launcher's "
                        "environment (python -m torch.distributed.run); each "
                        "rank loads its shard of the dataset")
    return p


def load_config(argv=None, parser: argparse.ArgumentParser | None = None):
    """Two-pass parse: CLI > YAML > argparse defaults (reference io.py:31-50)."""
    parser = parser or base_parser()
    p = parser.parse_args(argv)
    if p.config is not None:
        with open(p.config) as f:
            default_arg = yaml.safe_load(f)
        known = set(vars(p).keys())
        for k in default_arg:
            if k not in known:
                raise KeyError(f"Unknown argument in config file: {k}")
        parser.set_defaults(**default_arg)
        p = parser.parse_args(argv)
    return p


# flag -> (the values the port accepts, why any other raises)
_NOT_PORTED = {
    "use_pallas": ((None,), "--use_pallas has no meaning in the port: a CUDA "
                            "tensor runs the CUDA kernels, a CPU tensor the "
                            "plain versions"),
}


def check_supported(arg) -> None:
    """Raise NotImplementedError for a flag set to what the port has no
    meaning for, so that none is ignored quietly; and ValueError for the
    parallel flags' combinations the JAX trainer rejects
    (tamgcn_tpu/train/trainer.py:52-63, 344-348), naming them."""
    for name, (accepted, why) in _NOT_PORTED.items():
        value = getattr(arg, name)
        if value not in accepted:
            raise NotImplementedError(f"{why} (got --{name} {value!r})")
    if arg.sequence_parallel and arg.graph_partition != "none":
        raise ValueError(
            "--sequence_parallel and --graph_partition are mutually exclusive: both "
            "shard over the mesh's 'model' axis (sp shards time, the ring shards "
            "joints). Drop one.")
    if arg.sequence_parallel and arg.fast_eval:
        raise ValueError(
            "--fast_eval and --sequence_parallel are mutually exclusive: the fused "
            "block kernels have no partitioning spec for a sharded time axis. Drop "
            "one of the flags.")


def resolve_device(arg):
    """--use_gpu/--device -> torch.device of a process that is not a rank
    of a launched world. --use_gpu true without CUDA raises: there is no
    quiet CPU run."""
    import torch

    if not arg.use_gpu:
        return torch.device("cpu")
    index = arg.device
    if isinstance(index, (list, tuple)):
        if len(index) != 1:
            raise ValueError(
                f"--device {index}: one process runs on one device; a list takes "
                "one entry per local rank with --distributed true"
            )
        index = index[0]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--use_gpu true but CUDA is not available; pass --use_gpu false "
            "to run on the CPU"
        )
    return torch.device("cuda", int(index))
