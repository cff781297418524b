"""How the harness builds the system under test from a configuration file:
the port's trainer from the configuration's trainer settings, with the
clips' directory, a work directory and the seed in place of the shipped
paths, and the benchmark's weights loaded in place of the init."""
from __future__ import annotations

import os

import torch


def trainer_args(run, phase: str, clips_root: str):
    """The trainer's arguments: the configuration's trainer section as the
    YAML defaults, then the run's own values as command-line flags."""
    from tamgcn_tpu_torch.train.config import base_parser

    parser = base_parser()
    parser.set_defaults(**run.config["trainer"])
    argv = ["--phase", phase, "--work_dir", os.path.join(run.tmp, "work"),
            "--seed", str(run.seed), "--use_gpu", str(run.device.type == "cuda").lower(),
            "--train_feeder_args", f"data_path={clips_root}",
            "--test_feeder_args", f"data_path={clips_root}"]
    if run.device.type == "cuda":
        argv += ["--device", str(run.device.index or 0)]
    for key, value in run.overrides.items():
        argv += ["--model_args", f"{key}={value}"]
    return parser.parse_args(argv)


def trainer(run, phase: str, clips_root: str):
    from tamgcn_tpu_torch.train.trainer import RecognitionTrainer

    return RecognitionTrainer(trainer_args(run, phase, clips_root))


def same_samples(feeder, split) -> None:
    """Raise where the program's feeder holds other samples, or another
    order, than the clips the harness wrote."""
    names = list(getattr(feeder, "sample_name", []))
    if names != list(split.names) or [int(x) for x in feeder.label] != list(split.labels):
        raise RuntimeError("the program's feeder reads other samples than the benchmark wrote")


def load(model: torch.nn.Module, w: dict) -> None:
    """Copy the benchmark's weights into the model, every tensor by name."""
    state = model.state_dict()
    if list(state) != list(w) or any(state[k].shape != w[k].shape for k in w):
        raise RuntimeError("the model's tensors differ from the benchmark's weights: "
                           f"{sorted(set(state) ^ set(w))[:8]}")
    model.load_state_dict({k: v.detach().to(state[k].device) for k, v in w.items()})
