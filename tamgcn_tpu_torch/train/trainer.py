"""Recognition trainer of the port: the test phase.

Counterpart of tamgcn_tpu/train/trainer.py:RecognitionTrainer for
`--phase test` (reference processor/processor.py lifecycle and
recognition_rgb.py test): build the val loader, the model (seeded from
--seed) and its weights, run inference over the val split on the device
that --use_gpu/--device name, report the mean loss and top-k, and save the
per-sample score pickle. `--phase train` and the other flags of features
the port lacks raise (train/config.py:check_supported).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import Loader, feeder_accepts_seed, get_feeder
from ..data.loader import prefetch
from ..data.transforms import top_k
from ..models import get_model
from .checkpoint import filter_ignore, load_weights, partial_update
from .config import check_supported, resolve_device
from .session import Session


class RecognitionTrainer:
    """Skeleton-recognition eval driver (reference REC_Processor, test phase)."""

    def __init__(self, arg):
        check_supported(arg)
        self.arg = arg
        self.device = resolve_device(arg)
        self.session = Session(arg.work_dir, arg.save_log, arg.print_log)
        self.session.save_arg(arg)
        self.print_log = self.session.print_log
        self.print_log(f"device: {self.device}")
        self.loaders = {}
        self._load_data()
        self._load_model()
        self.result_scores = None

    # -- construction --------------------------------------------------------

    def _load_data(self):
        arg = self.arg
        test_args = dict(arg.test_feeder_args)
        test_args.setdefault("split", "val")
        # the synthetic feeder's seed selects the class prototypes shared
        # between splits, so the test feeder is keyed on the run seed too
        if "seed" not in test_args and feeder_accepts_seed(arg.feeder):
            test_args["seed"] = arg.seed
        self.test_feeder = get_feeder(arg.feeder, **test_args)
        self.loaders["test"] = Loader(
            self.test_feeder,
            batch_size=arg.test_batch_size,
            shuffle=False,
            drop_last=False,
            seed=arg.seed,
            num_workers=arg.num_worker,
        )

    def _load_model(self):
        arg = self.arg
        generator = torch.Generator().manual_seed(arg.seed)
        self.model = get_model(arg.model, generator=generator, **dict(arg.model_args))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.print_log(f"model: {arg.model} ({n_params/1e6:.2f}M params)")
        if arg.weights:
            self._load_weights()
        self.model.to(self.device).eval()

    def _load_weights(self):
        arg = self.arg
        self.print_log(f"Load weights from {arg.weights}")
        state = filter_ignore(load_weights(arg.weights), arg.ignore_weights)
        partial_update(self.model, state, log=self.print_log)

    # -- eval ------------------------------------------------------------------

    def test_epoch(self):
        loader = self.loaders["test"]
        device = self.device
        losses, scores, labels = [], [], []

        def put(batch):
            inputs, label = batch[:-2], batch[-2]
            inputs = tuple(torch.from_numpy(a).to(device) for a in inputs)
            return inputs, torch.from_numpy(label.astype(np.int64)).to(device), label

        n_batches = n_samples = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            for inputs, label, label_np in prefetch(iter(loader), put):
                logits = self.model(*inputs)
                # keep results on the device; one bulk copy below
                losses.append(F.cross_entropy(logits, label))
                scores.append(logits)
                labels.append(label_np)
                n_batches += 1
                n_samples += len(label_np)
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

    # -- lifecycle ---------------------------------------------------------------

    def start(self):
        self.print_log(f"Parameters:\n{vars(self.arg)}\n")
        self._test_phase()

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
        (reference processor.py:162-168)."""
        names = getattr(self.test_feeder, "sample_name", None)
        if names is None:
            names = list(range(len(self.result_scores)))
        self.session.save_pkl(dict(zip(names, self.result_scores)), filename)
        self.print_log(f"saved scores: {filename}")
