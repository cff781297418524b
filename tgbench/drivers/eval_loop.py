"""Evaluation: whole passes of the port's `RecognitionTrainer.test_epoch`
over the val split.

Set-up writes the clips, builds the trainer in its test phase (the val
feeder parses every clip), makes the weights and sets their BatchNorm
statistics from one reference pass over the first test batch, loads them,
and runs one pass, in which the graphed eval step is captured for each
batch shape. The window runs passes until `seconds` have passed:
eval_samples_per_s is every sample scored over the window. Every pass's
scores are kept and each is compared with the reference's logits.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import clips, compare, faults, program, weights
from ..harness import Check, Window
from ..reference import feeders, model as ref_model
from ..work import flops


def val_inputs(run, split, rows=None) -> torch.Tensor:
    cfg = run.config
    idx = range(len(split.clips)) if rows is None else range(rows)
    x, _ = feeders.batch(split.clips, split.labels, list(idx), train=False, seed=run.seed,
                         epoch=0, steps=cfg["time_steps"], persons=cfg["model"]["num_person"])
    return torch.from_numpy(x).to(run.device)


def benchmark_weights(run, split) -> dict:
    """The seed's weights with their BatchNorm statistics set from the first
    test batch by the reference."""
    cfg = run.config
    w = weights.make(cfg["model"], run.seed, run.device)
    with compare.reference_numerics():
        weights.calibrate(cfg["model"], w,
                          val_inputs(run, split, cfg["trainer"]["test_batch_size"]))
    return w


def reference_logits(run, split, w) -> np.ndarray:
    with compare.reference_numerics():
        out = ref_model.logits_in_blocks(run.config["model"], w, val_inputs(run, split))
    return out.double().cpu().numpy()


class Driver:
    def __init__(self, run, fault=None):
        self.run = run
        root = os.path.join(run.tmp, "clips")
        mark = run.phases or (lambda name: None)
        self.clips = clips.write(root, run.config["data"], run.seed, ("val",))
        mark("clips written")
        t = self.trainer = program.trainer(run, "test", root)
        program.same_samples(t.test_feeder, self.clips["val"])
        mark("trainer built (the feeder parses every clip)")
        self.w = benchmark_weights(run, self.clips["val"])
        program.load(t.model, self.w)
        t._ensure_steps()  # the graphed eval step
        mark("weights made, calibrated and loaded")
        if fault:
            faults.plant(fault, t)
        t.test_epoch()  # captures a graph per batch shape
        mark("first pass (a capture per batch shape)")
        self.scores = []
        self.batches = [len(b) for b in np.array_split(
            np.arange(len(t.test_feeder)),
            range(t.arg.test_batch_size, len(t.test_feeder), t.arg.test_batch_size))]

    def _pass(self) -> None:
        self.trainer.test_epoch()
        self.scores.append(self.trainer.result_scores)

    def window(self, seconds: float, tracer) -> Window:
        passes = traced = 0
        start = time.perf_counter()
        if tracer is not None:
            with tracer:
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < self.run.traffic["trace_min_seconds"]:
                    self._pass()
                    traced += 1
            passes += traced
        while time.perf_counter() - start < seconds:
            self._pass()
            passes += 1
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        elapsed = time.perf_counter() - start
        n = sum(self.batches)
        cfg = self.run.config
        facts = dict(traced_steps=traced * len(self.batches), traced_samples=traced * n,
                     traced_batches={b: traced * self.batches.count(b) for b in set(self.batches)},
                     flops_per_sample=flops.forward_per_sample(cfg["model"], cfg["time_steps"]))
        return Window(elapsed, passes * n, 0, {"eval_samples_per_s": passes * n / elapsed}, facts)

    def release(self) -> None:
        del self.trainer
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[Check]:
        ref = reference_logits(self.run, self.clips["val"], self.w)
        gap = max((compare.logit_gap(s, ref) for s in self.scores), default=float("inf"))
        return [Check("logit_gap", gap, self.run.limits.get("logit_gap"))]
