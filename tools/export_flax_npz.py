#!/usr/bin/env python
"""Export a JAX training checkpoint (orbax directory) to a Flax-layout .npz.

The bridge from the JAX trainer's checkpoints to the PyTorch port, which
reads no orbax: opens `<work_dir>/checkpoints` of a tamgcn_tpu run with its
`Checkpointer`, takes `best`, else the newest `epoch{n}` (as the JAX
trainer's --weights does), restores it against the configured model's
init, and writes every parameter and BatchNorm statistic under its
"/"-joined Flax path (`params/l1/gcn1/conv3/kernel`,
`batch_stats/data_bn/mean`, ...). The port's --weights loads that file
(tamgcn_tpu_torch/train/checkpoint.py).

    python tools/export_flax_npz.py WORK_DIR/checkpoints -c configs/nucla/gcn.yaml \
        -o weights.npz [--model_args base_channel=64 ...]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def flatten(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def export(checkpoint_dir: str, model, out: str, in_channels: int = 3,
           num_point: int = 20, num_person: int = 1) -> dict:
    """Restore the checkpoint against `model`'s init and write the .npz;
    returns the arrays written."""
    import jax
    import jax.numpy as jnp

    from tamgcn_tpu.train.checkpoint import Checkpointer

    x = jnp.zeros((2, in_channels, 8, num_point, num_person), jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), x, train=False))
    ckptr = Checkpointer(checkpoint_dir)
    if ckptr.exists("best"):
        name = "best"
    elif ckptr.latest_epoch() is not None:
        name = f"epoch{ckptr.latest_epoch()}"
    else:
        raise FileNotFoundError(f"no best or epoch<n> checkpoint under {checkpoint_dir}")
    tree = ckptr.restore(name, target={
        "params": variables["params"],
        "batch_stats": variables.get("batch_stats", {}),
        "step": np.zeros((), np.int32),
    })
    arrays = flatten(jax.device_get(tree["params"]), "params")
    arrays.update(flatten(jax.device_get(tree["batch_stats"]), "batch_stats"))
    np.savez(out, **arrays)
    print(f"exported {name} of {checkpoint_dir}: {len(arrays)} arrays -> {out}")
    return arrays


def main(argv=None) -> int:
    from tamgcn_tpu.models import get_model
    from tamgcn_tpu.train.config import base_parser, load_config

    parser = base_parser(add_help=True)
    parser.add_argument("checkpoint_dir", help="the JAX run's <work_dir>/checkpoints")
    parser.add_argument("-o", "--out", required=True, help="the .npz to write")
    arg = load_config(argv, parser=parser)
    model_args = dict(arg.model_args)
    model = get_model(arg.model, **model_args)
    export(arg.checkpoint_dir, model, arg.out,
           in_channels=int(model_args.get("in_channels", 3)),
           num_point=int(model_args.get("num_point", 20)),
           num_person=int(model_args.get("num_person", 1)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
