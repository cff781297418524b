"""Recognition trainer of the port: the train and test phases.

Counterpart of tamgcn_tpu/train/trainer.py:RecognitionTrainer (reference
processor/processor.py lifecycle :27-35 and epoch loop :107-168;
recognition_rgb.py train/test/start :48-126), on one device or on each rank
of a (data, model) grid:

  * train phase: a shuffled, drop_last train loader keyed on --seed; per
    step the lr from the schedule (train/optim.py) and the fused train step
    of train/packing.py: a train-mode forward (BatchNorm batch stats), mean
    cross-entropy, backward (on the card through K1-K3) into the flat
    gradient and the flat-space optimiser, with the --freeze_params mask on
    its update; the val loader built at the first eval; eval every
    --eval_interval epochs, the best top-1 with its checkpoint and score
    pickle, epoch checkpoints every --save_interval, the progress csv and
    --resume; a model's dropout masks are keyed on --seed and the step
    (ops/dropout.py), so a resumed run draws the masks an unbroken one
    draws;
  * test phase: inference over the val split with --weights, mean loss,
    top-k and the per-sample score pickle.

`_build_steps` makes the three steps of the JAX trainer (:278-366): the
train step, the eval step (logits and mean loss,
models/ctrgcn_infer.py:make_eval_step) and, with --fast_eval, the fast-eval
step, which folds the current weights inside the step
(models/ctrgcn_infer.py:make_fast_eval_step, every block through K5 on the
card where K5 takes it). On the card each runs as CUDA graphs, one per
input shape (train/graphs.py), where the JAX trainer jits; on the CPU the
same step functions run eagerly (train/packing.py:make_fused_train_step and
make_eval_step are the eager steps, for a comparison on the card).

--profile_dir wraps the train phase in a torch.profiler trace (CPU and, on
the card, CUDA activity) written as a Chrome trace under that directory, as
the JAX trainer wraps it in jax.profiler (:649-679), with the spans of the
loop and the loader (utils/spans.py) in it. --debug_nans adds a
finiteness check to every step and, at the first non-finite value, raises
FloatingPointError naming the module that made it (train/debug_nans.py).

The grid (parallel/): --data_parallel and --model_parallel lay the world's
ranks out (parallel/mesh.py:make_mesh); --distributed true starts the world
from the launcher's environment (`python -m torch.distributed.run`), and then
each data rank's loader takes its contiguous shard of the dataset (the JAX
loader's process sharding); a world started by its caller (the dry run,
the tests) with --distributed false loads every batch whole and each rank
takes its rows (parallel/mesh.py:shard_batch), as the JAX trainer splits a
batch over one process's devices. The model is wired to the grid
(parallel/sharded.py:parallelize: BatchNorm over the data group, the joint
ring with --graph_partition ring, the tensor-parallel head where the model
axis is > 1, the time-sharded model with --sequence_parallel), and each
step is the step of the global batch: the flat gradient summed over the
grid before the optimiser (GradientSum), the test batches padded by tiling
to a multiple of the data size and their padded rows dropped (:579-603),
the logits gathered. A world of more than one rank runs its steps eagerly
(under gloo a CUDA graph cannot hold the collectives); rank 0 writes the
logs, checkpoints (full tensors, the tensor-parallel shards gathered, so one
process loads them) and score files. --debug_nans on a grid reduces each
step's finiteness flag over the world inside the step; at a non-finite
verdict every rank re-runs the step with the others and raises
FloatingPointError naming the same module (train/debug_nans.py).

--use_pallas raises (train/config.py:check_supported).
"""
from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch

from ..data import Loader, feeder_accepts_seed, get_feeder
from ..data.loader import Copier, prefetch
from ..data.transforms import top_k
from ..models import get_model
from ..models.ctrgcn import CTRGCN
from ..models.ctrgcn_infer import make_eval_step, make_fast_eval_step
from ..parallel import comm
from ..parallel.mesh import data_slice, init_distributed, make_mesh, shard_batch, world
from ..parallel.sequence import shard_time
from ..parallel.sharded import (GradientSum, full_optimizer_state, full_state_dict,
                                load_full_state, parallelize, shard_optimizer_state)
from ..utils import spans
from .checkpoint import Checkpoints, filter_ignore, partial_update, port_state, read_weights
from .config import check_supported, resolve_device
from .debug_nans import checked, locate_non_finite, non_finite_names
from .graphs import GraphedStep
from .optim import make_lr_schedule
from .packing import PackedTrainState, make_fused_train_step
from .session import Session


class RecognitionTrainer:
    """Skeleton-recognition training and evaluation (reference REC_Processor)."""

    def __init__(self, arg):
        check_supported(arg)
        self.arg = arg
        if arg.distributed and world()[1] == 1:
            self.device = init_distributed(arg.use_gpu, arg.device)
        else:
            self.device = resolve_device(arg)
        self.mesh = make_mesh(arg.data_parallel, arg.model_parallel)
        self.lead = self.mesh.rank == 0  # writes the logs, checkpoints and scores
        # the steps as CUDA graphs on the card (train/graphs.py), eager on the
        # CPU and on a grid of more than one rank
        self.capture = self.device.type == "cuda" and self.mesh.size == 1
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # where the graphs replay
        # every batch's copy to the device (data/loader.py; pinned on the card)
        self.copier = Copier(self.device)
        self.state = None  # PackedTrainState, built with the steps
        self.steps = None
        self.session = Session(arg.work_dir, arg.save_log and self.lead,
                               arg.print_log and self.lead)
        if self.lead:
            self.session.save_arg(arg)
        self.print_log = self.session.print_log
        self.print_log(f"device: {self.device}")
        if self.mesh.size > 1:
            devices = comm.all_gather_objects(str(self.device), self.mesh.world)
            self.print_log(
                f"mesh: data={self.mesh.shape['data']} model={self.mesh.shape['model']}, "
                f"backend {self.mesh.backend}, rank devices {devices}; the steps run "
                "eagerly (no CUDA graph holds the collectives)")
        self.loaders = {}
        self._load_data()
        self._load_model()
        if arg.phase == "train":
            self._load_optimizer()
        self.checkpoints = Checkpoints(os.path.join(arg.work_dir, "checkpoints"))
        self.best_t1 = 0.0
        n_evals = max(1, arg.num_epoch // max(1, arg.eval_interval))
        self.progress = np.zeros([n_evals, 4])
        self.result_scores = None

    # -- construction --------------------------------------------------------

    def _load_data(self):
        arg = self.arg
        if arg.phase == "train":
            train_args = dict(arg.train_feeder_args)
            train_args.setdefault("debug", arg.debug)
            train_args.setdefault("split", "train")
            # the augmentation stream is keyed on the run seed
            if "seed" not in train_args and feeder_accepts_seed(arg.feeder):
                train_args["seed"] = arg.seed
            self.train_feeder = get_feeder(arg.feeder, **train_args)
            self._log_backend("train", self.train_feeder)
            # --distributed: each data rank loads its shard of the dataset
            shards = (dict(process_index=self.mesh.data_index,
                           process_count=self.mesh.shape["data"])
                      if arg.distributed else {})
            self.loaders["train"] = Loader(
                self.train_feeder,
                batch_size=arg.batch_size,
                shuffle=True,
                drop_last=True,
                seed=arg.seed,
                num_workers=arg.num_worker,
                **shards,
            )
        else:
            self._ensure_test_loader()

    def _ensure_test_loader(self):
        """Build the val feeder/loader on first use: training starts without
        a loadable val split (the reference never touches val until eval,
        processor/recognition_rgb.py:71-101)."""
        if "test" in self.loaders:
            return
        arg = self.arg
        test_args = dict(arg.test_feeder_args)
        test_args.setdefault("split", "val")
        # the synthetic feeder's seed selects the class prototypes shared
        # between splits, so the test feeder is keyed on the run seed too
        if "seed" not in test_args and feeder_accepts_seed(arg.feeder):
            test_args["seed"] = arg.seed
        self.test_feeder = get_feeder(arg.feeder, **test_args)
        self._log_backend("test", self.test_feeder)
        self.loaders["test"] = Loader(
            self.test_feeder,
            batch_size=arg.test_batch_size,
            shuffle=False,
            drop_last=False,
            seed=arg.seed,
            num_workers=arg.num_worker,
        )

    def _log_backend(self, split: str, feeder):
        """Which augmentation backend a feeder took (the NW-UCLA feeder's
        native core or numpy)."""
        backend = getattr(feeder, "backend", None)
        if backend is not None:
            self.print_log(f"{split} feeder: {type(feeder).__name__}, backend {backend}")

    def _load_model(self):
        arg = self.arg
        generator = torch.Generator().manual_seed(arg.seed)
        self.model = get_model(arg.model, generator=generator, **dict(arg.model_args))
        n_params = sum(p.numel() for p in self.model.parameters())
        compute = getattr(self.model, "dtype", None) or torch.float32
        self.print_log(f"model: {arg.model} ({n_params/1e6:.2f}M params, {compute} "
                       "compute)")
        if arg.weights:
            self._load_weights()
        partition = (arg.graph_partition if arg.graph_partition != "none"
                     else dict(arg.model_args).get("graph_partition", "none"))
        parallelize(self.model, self.mesh, partition,
                    arg.sequence_parallel and self.mesh.model.size > 1)
        self.model.to(self.device).eval()

    def _load_weights(self):
        """--weights in any of its forms (train/checkpoint.py:read_weights; a
        directory names its best.pt or latest epoch{n}.pt), then
        --ignore_weights and the partial load with its report, which raises
        where most of the target module would stay at init."""
        arg = self.arg
        form, contents, path = read_weights(arg.weights)
        where = arg.weights if path == arg.weights else f"{arg.weights} ({path})"
        self.print_log(f"Load weights from {where} ({form})")
        target, state = self._weights_for(form, contents)
        partial_update(target, filter_ignore(state, arg.ignore_weights),
                       log=self.print_log, ignore_keys=arg.ignore_weights)

    def _weights_for(self, form: str, contents: dict):
        """(the module the weights load into, its state dict from them)."""
        return self.model, port_state(form, contents, self.arg.model, self.model)

    def _load_optimizer(self):
        arg = self.arg
        self.steps_per_epoch = max(1, len(self.loaders["train"]))
        self.schedule = make_lr_schedule(
            arg.base_lr, arg.step, arg.lr_decay_rate, self.steps_per_epoch,
            arg.warm_up_epoch,
        )
        self.step = 0  # optimizer steps taken; the schedule's counter

    # -- the steps ---------------------------------------------------------------

    def _build_steps(self):
        """The train step (train phase), the eval step and, with --fast_eval,
        the fast-eval step in its place; as CUDA graphs on the card.
        Built at first use, on the model as it is then (where it trains and
        in the dtype it trains in)."""
        arg, model = self.arg, self.model

        def graphed(fn, name, preserve=()):
            return GraphedStep(fn, name, preserve) if self.capture else fn

        steps = {}
        if arg.phase == "train":
            # frozen parameters get a zero update (and so no weight decay):
            # the functional requires_grad=False of the JAX trainer (:266)
            self.state = PackedTrainState(
                model, arg.optimizer, nesterov=arg.nesterov,
                weight_decay=arg.weight_decay,
                freeze_prefixes=tuple(arg.freeze_params or ()), seed=arg.seed,
                mesh=self.mesh if self.mesh.size > 1 else None)
            if self.mesh.size > 1:
                self.state.reduce = GradientSum(self.state, self.mesh,
                                                self.model.sequence_parallel)
            steps["train"] = graphed(
                make_fused_train_step(self.state, check_finite=arg.debug_nans),
                "train", self.state.tensors())
            if arg.debug_nans:
                # the state each step starts from, for the eager re-run
                self._nan_backup = [t.clone() for t in self.state.tensors()]

        fast = arg.fast_eval and isinstance(model, CTRGCN)
        if arg.fast_eval and not fast:
            self.print_log(
                "WARNING: --fast_eval only applies to CTRGCN models; ignored for "
                f"{type(model).__name__} (ordinary eval path).")
        name, step = (("fast_eval", make_fast_eval_step(model)) if fast
                      else ("eval", make_eval_step(model)))
        if self.mesh.shape["data"] > 1:
            step = self._gathered(step)
        if arg.debug_nans:
            watched = (self.state.params.flats + self.state.stats.flats
                       if self.state is not None
                       else list(model.parameters()) + list(model.buffers()))
            step = checked(step, watched, self.mesh.world)
        steps["eval"] = graphed(step, name)
        self.steps = steps

    def _gathered(self, step):
        """An eval step on the rank's rows whose logits are gathered over the
        data group, its loss the mean over the whole (padded) batch."""
        mesh = self.mesh

        def gathered(*args):
            *inputs, label = args
            _, logits = step(*inputs, label[data_slice(len(label), mesh)])
            logits = comm.all_gather(logits, mesh.data, 0)
            return torch.nn.functional.cross_entropy(logits, label), logits

        return gathered

    def _ensure_steps(self):
        if self.steps is None:
            self._build_steps()
        elif self.state is not None:
            self.state.check()

    # -- epoch loops -------------------------------------------------------------

    def _put(self, batch):
        """Producer-thread host->device copy (loader.prefetch) of the rank's
        part of a train batch: its rows (where it loaded the global batch)
        and, with --sequence_parallel, its frames."""
        inputs, label = batch[:-2], batch[-2]
        if not self.arg.distributed:
            *inputs, label = shard_batch(self.mesh, *inputs, label)
        return self._to_device(inputs, label, label)

    def _to_device(self, inputs, label, label_np):
        """(the inputs on the device, the int64 labels on the device,
        `label_np`) through the trainer's copier; on the card a
        `loader.Ready` of it, which prefetch hands over once copied."""
        if self.model.sequence_parallel:
            inputs = tuple(shard_time(a, self.mesh) if a.ndim in (3, 5) else a
                           for a in inputs)
        return self.copier([*inputs, label.astype(np.int64)],
                           lambda *t: (t[:-1], t[-1], label_np))

    def _put_test(self, batch):
        """A test batch padded by tiling to a multiple of the data size (JAX
        trainer :579-603): (the rank's rows of the inputs on the device, the
        padded labels on the device, the batch's own labels)."""
        inputs, label = batch[:-2], batch[-2]
        n, d = len(label), self.mesh.shape["data"]
        pad = (-n) % d
        if pad:
            inputs = tuple(np.concatenate([a, np.resize(a, (pad,) + a.shape[1:])])
                           for a in inputs)
            label = np.concatenate([label, np.resize(label, (pad,))])
        return self._to_device(shard_batch(self.mesh, *inputs), label, batch[-2])

    def train_epoch(self, epoch: int) -> np.ndarray:
        """One epoch of optimizer steps; returns the loss of each step.

        The Session's timers split the epoch's host time three ways:
        "dataloader", the wait for the next batch; "step", the host's part
        of a step (the learning rate and the step's call, which on the card
        enqueues an asynchronous graph replay: not the device's time); and
        "statistics". The spans (utils/spans.py) mark the epoch, each step,
        each log line and the epoch's end."""
        with spans.span("tamgcn.train.epoch", epoch):
            arg = self.arg
            loader = self.loaders["train"]
            loader.set_epoch(epoch)
            self._ensure_steps()
            train_step = self.steps["train"]
            self.model.train()
            losses, hits = [], []
            self.session.init_timer("dataloader", "step", "statistics")
            t0 = time.perf_counter()
            nseen = 0
            for it, (inputs, label, label_np) in enumerate(prefetch(iter(loader), self._put)):
                self.session.check_time("dataloader")
                with spans.span("tamgcn.train.step", self.step):
                    lr = self.schedule(self.step)
                    self.state.set_lr(lr)
                    if arg.debug_nans:
                        torch._foreach_copy_(self._nan_backup, self.state.tensors())
                        loss, hit, finite = train_step(*inputs, label)
                        if not bool(finite):
                            self._raise_non_finite("train", epoch, inputs, label)
                    else:
                        loss, hit = train_step(*inputs, label)
                self.step += 1
                self.session.check_time("step")
                # keep the statistics on the device; one copy at the epoch's end
                losses.append(loss)
                hits.append(hit)
                nseen += len(label_np) * (self.mesh.shape["data"] if arg.distributed else 1)
                if it % arg.log_interval == 0:
                    with spans.span("tamgcn.train.log", self.step - 1):
                        self.print_log(
                            f"\tIter {it}/{len(loader)} | loss: {loss.item():.4f} "
                            f"| lr: {lr:.6f}"
                        )
                self.session.check_time("statistics")
            with spans.span("tamgcn.train.epoch_end", epoch):
                losses = torch.stack(losses).cpu().numpy()
                acc = torch.stack(hits).sum().item() / nseen
                seconds = time.perf_counter() - t0
                self.print_log(
                    f"\tTraining loss: {float(np.mean(losses)):.4f} | acc: {acc:.2%} "
                    f"| {nseen / seconds:.1f} samples/s"
                )
                self.session.print_timer()
            return losses

    def test_epoch(self):
        """One pass over the val split: (mean loss, top-1, top-5); the
        scores and labels stay in `result_scores`, `result_labels`. The
        spans mark the pass, each batch's step and the pass's end."""
        with spans.span("tamgcn.eval.pass"):
            self._ensure_test_loader()
            self._ensure_steps()
            eval_step = self.steps["eval"]
            loader = self.loaders["test"]
            self.model.eval()
            losses, scores, labels = [], [], []
            n_batches = n_samples = 0
            t0 = time.perf_counter()
            with torch.inference_mode():
                # on a grid, each rank its rows of the padded batch, the labels whole
                put = self._put if self.mesh.size == 1 else self._put_test
                for it, (inputs, label, label_np) in enumerate(prefetch(iter(loader), put)):
                    with spans.span("tamgcn.eval.step", it):
                        loss, logits, *finite = eval_step(*inputs, label)
                        logits = logits[:len(label_np)]  # the padded rows dropped
                        if finite and not bool(finite[0]):
                            self._raise_non_finite("eval", None, inputs, label, batch=it)
                    # keep results on the device; one bulk copy below
                    losses.append(loss)
                    scores.append(logits)
                    labels.append(label_np)
                    n_batches += 1
                    n_samples += len(label_np)
            with spans.span("tamgcn.eval.pass_end"):
                losses = torch.stack(losses).cpu().numpy()
                scores = torch.cat(scores).float().cpu().numpy()
                seconds = time.perf_counter() - t0
                labels = np.concatenate(labels)
                self.print_log(
                    f"\tEval: {n_batches} batches, {1e3 * seconds / n_batches:.3f} "
                    f"ms/batch, {n_samples / seconds:.1f} samples/s"
                )
                mean_loss = float(np.mean(losses))
                for k in self.arg.show_topk:
                    self.print_log(f"\tTop{k}: {top_k(scores, labels, k):.2%}")
                top1 = top_k(scores, labels, 1)
                top5 = top_k(scores, labels, 5)
            self.result_scores = scores
            self.result_labels = labels
            return mean_loss, top1, top5

    def _raise_non_finite(self, kind: str, epoch, inputs, label, batch=None):
        """--debug_nans: a step made a non-finite value. Re-run it eagerly
        on the same batch from the state it started from (a train step's
        state is restored first) and raise FloatingPointError naming where
        the first non-finite value arose; on a grid every rank does so
        together and names the same place."""
        world = self.mesh.world
        after = None
        if kind == "train":
            after = non_finite_names(list(self.model.named_parameters())
                                     + list(self.model.named_buffers()), world)
            torch._foreach_copy_(self.state.tensors(), self._nan_backup)
        elif self.mesh.shape["data"] > 1:  # the rank's rows of the padded batch
            label = label[data_slice(len(label), self.mesh)]
        # the eager re-run draws the dropout masks the step drew (the
        # restored counter stands at the step)
        with self.state.dropout_stream() if kind == "train" else contextlib.nullcontext():
            where = locate_non_finite(self.model, inputs, label, train=kind == "train",
                                      group=world)
        if where is None:
            where = (f"the optimiser's update of {', '.join(after[:5])}" if after
                     else "the step's outputs (the eager re-run stayed finite)")
        when = (f"train step {self.step} (epoch {epoch + 1})" if kind == "train"
                else f"eval batch {batch}" + (f" (after {self.step} train steps)"
                                              if self.arg.phase == "train" else ""))
        raise FloatingPointError(f"--debug_nans: non-finite value in {where}, {when}")

    # -- lifecycle ---------------------------------------------------------------

    def start(self):
        self.print_log(f"Parameters:\n{vars(self.arg)}\n")
        if self.arg.phase == "train":
            self._train_phase()
        else:
            self._test_phase()

    def _train_phase(self):
        arg = self.arg
        start_epoch = arg.start_epoch
        self._ensure_steps()
        if arg.resume:
            start_epoch = max(start_epoch, self.resume())
        profiler = self._start_profiler() if arg.profile_dir else None
        try:
            self._epochs(start_epoch)
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)

    def _start_profiler(self):
        """--profile_dir: a torch.profiler trace of the train phase, CPU and,
        on the card, CUDA activity, with the spans (utils/spans.py) that it
        collects."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        spans.reset()
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler):
        """Write the Chrome trace, then add to it the spans of the threads
        kineto does not record (the loader's producer)."""
        profiler.stop()
        os.makedirs(self.arg.profile_dir, exist_ok=True)
        path = os.path.join(self.arg.profile_dir,
                            f"train_{socket.gethostname()}_{os.getpid()}.pt.trace.json")
        profiler.export_chrome_trace(path)
        added = spans.add_to_chrome_trace(path)
        self.print_log(f"profile trace written: {path} ({added} spans of other threads)")

    def _epochs(self, start_epoch: int):
        arg = self.arg
        for epoch in range(start_epoch, arg.num_epoch):
            self.print_log(f"Training epoch: {epoch + 1}")
            train_loss = float(np.mean(self.train_epoch(epoch)))
            last = epoch + 1 == arg.num_epoch
            if (epoch + 1) % arg.eval_interval == 0 or last:
                self.print_log(f"Eval epoch: {epoch + 1}")
                test_loss, top1, top5 = self.test_epoch()
                self.print_log(
                    f"\tEvaluation Acc: {top1:.2%} (top5 {top5:.2%}) "
                    f"loss {test_loss:.4f}"
                )
                row = min(epoch // max(1, arg.eval_interval), len(self.progress) - 1)
                self.progress[row] = [train_loss, test_loss, top1, top5]
                if top1 > self.best_t1:
                    self.best_t1 = top1
                    self.print_log(f"Save best Top1 at epoch:{epoch + 1}")
                    self._save_checkpoint("best")
                    self._save_scores(f"test_result_epoch{epoch + 1}.pkl")
                if (epoch + 1) % arg.save_interval == 0 or last:
                    self._save_checkpoint(f"epoch{epoch + 1}")
        if self.lead:
            self.session.save_progress_csv(self.progress)
        self.print_log(f"Best Top1: {self.best_t1:.2%}")

    def _test_phase(self):
        arg = self.arg
        if arg.weights is None:
            raise ValueError("Please appoint --weights.")
        self.print_log(f"Model:   {arg.model}.")
        self.print_log(f"Weights: {arg.weights}.")
        self.print_log("Evaluation Start:")
        test_loss, top1, top5 = self.test_epoch()
        self.print_log(
            f"\tEvaluation Acc: {top1:.2%} (top5 {top5:.2%}) loss {test_loss:.4f}"
        )
        if arg.save_result:
            self._save_scores("test_result.pkl")

    def _save_scores(self, filename: str):
        """Per-sample score pickle keyed by sample name
        (reference processor.py:162-168); rank 0 writes it."""
        if not self.lead:
            return
        names = getattr(self.test_feeder, "sample_name", None)
        if names is None:
            names = list(range(len(self.result_scores)))
        self.session.save_pkl(dict(zip(names, self.result_scores)), filename)
        self.print_log(f"saved scores: {filename}")

    def _save_checkpoint(self, name: str):
        """best: {model, step}; epoch{n}, a resume point: {model, optimizer,
        step}."""
        optimizer = (self.state.optimizer_state_dict() if name.startswith("epoch")
                     else None)
        # full tensors: the tensor-parallel shards gathered (every rank joins)
        state = full_state_dict(self.model)
        if optimizer is not None:
            optimizer = full_optimizer_state(optimizer, self.model)
        if self.lead:
            self.checkpoints.save(name, self.model, self.step, optimizer, state=state)
        self.print_log(f"checkpoint saved: {name}")

    def resume(self) -> int:
        """Restore the latest epoch checkpoint if present, in place into the
        packed state (the captured graphs keep their addresses); returns the
        epoch to continue from."""
        latest = self.checkpoints.latest_epoch()
        if latest is None:
            return self.arg.start_epoch
        tree = self.checkpoints.load(f"epoch{latest}")
        self._ensure_steps()
        load_full_state(self.model, tree["model"])
        self.state.load_optimizer_state_dict(
            shard_optimizer_state(tree["optimizer"], self.model))
        self.step = int(tree["step"])
        # the dropout stream goes on from the step it stopped at
        self.state.set_step(self.step)
        self.print_log(f"resumed from epoch{latest}")
        return latest
