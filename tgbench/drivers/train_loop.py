"""Training: whole epochs of the port's `RecognitionTrainer.train_epoch`.

Set-up writes the clips, builds the trainer from the configuration (its
feeder parses every clip), loads the benchmark's weights, and runs epoch 0
through the trainer's own loop: the graphed step is captured at its first
call, and the first three steps are recorded (losses, the parameters after
steps 1 and 3, the momentum after step 1) for the check. The window runs
epochs 1, 2, ... until `seconds` have passed, and ends with a synchronise:
train_samples_per_s is every sample of every step over the window.

With a tracer, the first epochs of the window, until `trace_min_seconds`
have passed, are traced; the per-layer facts are theirs. The loader's
wait is the trainer's own "dataloader" timer, summed over those epochs.
"""
from __future__ import annotations

import os
import time

import torch

from .. import clips, compare, faults, program, weights
from ..harness import Check, Window
from ..reference import feeders, model as ref_model, sgd
from ..work import flops

RECORDED = 3


class Recorder:
    """The train step, recording the loss, the flat parameters and (after
    the first) the flat momentum and the logits of its first `n` calls.

    The logits are the model's output inside the step: a forward hook on
    the model, registered before the step is captured, copies them
    into a buffer at every step (a copy of batch x classes values, part of
    the captured graph), which the recorder reads after the first call."""

    def __init__(self, step, state, model, batch: int, n: int):
        self.step, self.state, self.n = step, state, n
        self.records = []
        self.logits = None
        self.rows = 0
        self.buffer = None

        def keep(module, inputs, out):
            if self.buffer is None:
                self.buffer = torch.zeros((batch,) + tuple(out.shape[1:]), dtype=out.dtype,
                                          device=out.device)
            self.rows = min(batch, out.shape[0])
            self.buffer[:self.rows].copy_(out[:self.rows].detach())

        model.register_forward_hook(keep)

    def __call__(self, *args):
        out = self.step(*args)
        if len(self.records) < self.n:
            state = self.state
            first = not self.records
            momentum = ([m.clone() for m in state.optimizer.state["momentum_buffer"]]
                        if first else None)
            if first:
                self.logits = self.buffer[:self.rows].clone()
            self.records.append((out[0].clone(), [f.clone() for f in state.params.flats],
                                 momentum))
        return out


class Driver:
    def __init__(self, run, fault=None):
        self.run = run
        cfg = run.config
        root = os.path.join(run.tmp, "clips")
        mark = run.phases or (lambda name: None)
        self.clips = clips.write(root, cfg["data"], run.seed, ("train",))
        mark("clips written")
        t = self.trainer = program.trainer(run, "train", root)
        program.same_samples(t.train_feeder, self.clips["train"])
        mark("trainer built (the feeder parses every clip)")
        self.w0 = weights.make(cfg["model"], run.seed, run.device)
        program.load(t.model, self.w0)
        t._ensure_steps()  # the packed state and the graphed step
        mark("weights made, loaded and packed")
        if fault:
            faults.plant(fault, t)
        recorder = Recorder(t.steps["train"], t.state, t.model, t.arg.batch_size, RECORDED)
        t.steps["train"] = recorder
        t.train_epoch(0)
        t.steps["train"] = recorder.step
        mark("epoch 0 (the step's capture and the recorded steps)")
        self.records = recorder.records
        self.logits = recorder.logits
        self.layout = list(zip(t.state.param_names, t.state.params.slots,
                               [p.shape for p in t.state.params.tensors]))
        self.train_len = len(t.train_feeder)
        self.steps_per_epoch = len(t.loaders["train"])
        self.batch = t.arg.batch_size
        self.epoch = 1

    def _epoch(self) -> tuple[int, float]:
        t = self.trainer
        steps = len(t.train_epoch(self.epoch))
        self.epoch += 1
        return steps, t.session.split_timer.get("dataloader", 0.0)

    def window(self, seconds: float, tracer) -> Window:
        steps = 0
        traced = dict(steps=0, wait_s=0.0)
        start = time.perf_counter()
        if tracer is not None:
            with tracer:
                t0 = time.perf_counter()
                while True:
                    n, wait = self._epoch()
                    traced["steps"] += n
                    traced["wait_s"] += wait
                    if time.perf_counter() - t0 >= self.run.traffic["trace_min_seconds"]:
                        break
            steps += traced["steps"]
        while time.perf_counter() - start < seconds:
            steps += self._epoch()[0]
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        elapsed = time.perf_counter() - start
        samples = steps * self.batch
        cfg = self.run.config
        facts = dict(traced_steps=traced["steps"], traced_samples=traced["steps"] * self.batch,
                     loader_wait_s=traced["wait_s"], batch=self.batch,
                     flops_per_sample=flops.train_per_sample(cfg["model"], cfg["time_steps"]))
        return Window(elapsed, steps, 0, {"train_samples_per_s": samples / elapsed}, facts)

    def release(self) -> None:
        del self.trainer
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _leaves(self, flats) -> dict:
        return {name: flats[g][o:o + n].view(shape)
                for name, (g, o, n), shape in self.layout}

    def check(self) -> list[Check]:
        run, cfg = self.run, self.run.config
        if len(self.records) < RECORDED:
            return [Check("recorded_steps", float("inf"), 0.0)]
        batches, lrs = reference_inputs(run, self.clips["train"], self.train_len, self.batch,
                                        self.steps_per_epoch)
        with compare.reference_numerics():
            ref = sgd.train_steps(lambda w, x: ref_model.forward(cfg["model"], w, x, train=True),
                                  self.w0, batches, lrs, cfg["trainer"]["weight_decay"])
        wd = cfg["trainer"]["weight_decay"]
        m1 = self._leaves(self.records[0][2])
        p3 = self._leaves(self.records[-1][1])
        program = ([float(r[0]) for r in self.records],
                   {k: m1[k] - wd * self.w0[k] for k in m1},
                   {k: p3[k] - self.w0[k] for k in p3},
                   self.logits)
        numbers, self.notes = step_numbers(program, ref, self.w0)
        return [Check(k, v, run.limits.get(k)) for k, v in numbers.items()]


def reference_inputs(run, split, train_len: int, batch: int, steps_per_epoch: int):
    """The reference's own first batches of epoch 0 (the loader's order,
    the feeder's transforms, from the raw clips) and their learning rates."""
    cfg, args = run.config, run.config["trainer"]
    order = feeders.order(train_len, run.seed, 0)
    batches = []
    for k in range(RECORDED):
        x, y = feeders.batch(split.clips, split.labels, order[k * batch:(k + 1) * batch],
                             train=True, seed=run.seed, epoch=0, steps=cfg["time_steps"],
                             persons=cfg["model"]["num_person"])
        batches.append((torch.from_numpy(x).to(run.device), torch.from_numpy(y).to(run.device)))
    lrs = [sgd.learning_rate(k, base_lr=args["base_lr"], steps_per_epoch=steps_per_epoch,
                             warm_up_epoch=args["warm_up_epoch"], decay_epochs=args["step"],
                             decay_rate=args["lr_decay_rate"]) for k in range(RECORDED)]
    return batches, lrs


def step_numbers(program, reference, w0) -> tuple[dict, dict]:
    """The numbers compared (compare.py) of a program's three steps
    (losses, first gradients, changes by leaf, first logits) against the
    reference's (losses, first gradients, parameters after, first logits),
    and the worst leaves."""
    losses, grad, change, logits = program
    ref_losses, first, after, ref_logits = reference
    ref_change = {k: after[k] - w0[k] for k in change}
    grads = compare.leaf_gaps(grad, first)
    changes = compare.leaf_gaps(change, ref_change, compare.moved_leaves(first))
    numbers = {"logit_gap_1": compare.logit_gap(logits.double().cpu().numpy(),
                                                ref_logits.double().cpu().numpy()),
               "loss_gap_1": compare.loss_gap(losses[:1], ref_losses[:1]),
               "loss_gap": compare.loss_gap(losses, ref_losses),
               "grad_gap": compare.worst(grads)[0], "grad_gap_median": compare.median(grads),
               "change_gap": compare.worst(changes)[0],
               "change_gap_median": compare.median(changes)}

    def top(gaps):
        return ", ".join(f"{k} {v:.4g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:4])

    return numbers, {"grad_gap worst leaves": top(grads), "change_gap worst leaves": top(changes)}
