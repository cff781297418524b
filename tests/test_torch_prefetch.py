"""The loader's prefetch thread and its host-to-device copier
(tamgcn_tpu_torch/data/loader.py), on the CPU and, for one test, the card.

On the CPU the copier takes the plain path, `torch.from_numpy(...).to(device)`,
as the trainer always did there. Its pinned path runs here through a
stand-in card whose copies are lazy: a copy runs only when an event
recorded after it is waited on, the way a copy stream runs behind the host,
so a slot written again before its event reports done would hand the step
the later batch's values. Through prefetch, both paths give the plain
batches in order; an exception raised in the producer (in the iterator or
in `put`) reaches the consumer; the counters count pinned batches, plain
batches and the producer's waits for a slot; a CPU trainer's epoch and pass
through the stand-in card equal the plain path's bit for bit.

The card test (marker `cuda`; skipped without one):

    python -m pytest --noconftest -m cuda tests/test_torch_prefetch.py -q

runs one NW-UCLA train epoch and one eval pass of configs/nucla/gcn.yaml
through the pinned path and holds every batch the steps were handed to
the plain path's bit for bit, with every batch pinned and no slot wait at
the trainer's queue depth. This file imports no JAX.
"""
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from tamgcn_tpu_torch.data import Loader, SyntheticSkeletonFeeder
from tamgcn_tpu_torch.data import loader as loader_mod
from tamgcn_tpu_torch.data.loader import Copier, Ready, prefetch
from tamgcn_tpu_torch.train.config import base_parser, load_config
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
GCN_YAML = os.path.join(REPO, "configs", "nucla", "gcn.yaml")


class LazyCard:
    """A stand-in for the copier's CUDA calls: a copy is queued, and runs
    when an event recorded after it is waited on (`synchronize`, or the
    consumer's `hand_over`); until then the event's `query` reports False."""

    stream = "copy stream"

    def __init__(self):
        self.lock = threading.Lock()
        self.queue = []  # [out, host] of each copy, None once run
        self.handed = 0

    def host(self, shape, dtype):
        return torch.empty(shape, dtype=dtype)

    def event(self):
        return LazyEvent(self)

    def copying(self):
        return contextlib.nullcontext()

    def copy(self, out, host):
        with self.lock:
            self.queue.append([out, host])

    def run(self, upto):
        with self.lock:
            for k in range(upto):
                if self.queue[k] is not None:
                    out, host = self.queue[k]
                    out.copy_(host)
                    self.queue[k] = None

    def hand_over(self, event, tensors):
        event.synchronize()
        self.handed += 1


class LazyEvent:
    def __init__(self, card):
        self.card, self.upto = card, 0

    def record(self, stream):
        assert stream == LazyCard.stream
        with self.card.lock:
            self.upto = len(self.card.queue)

    def query(self):
        with self.card.lock:
            return all(c is None for c in self.card.queue[:self.upto])

    def synchronize(self):
        self.card.run(self.upto)


@pytest.fixture(autouse=True)
def fresh_stats():
    loader_mod.reset_stats()
    yield
    loader_mod.reset_stats()


def _counts():
    s = loader_mod.stats
    return s.pinned, s.plain, s.slot_waits


def _loader(n=22, batch=4):
    return Loader(SyntheticSkeletonFeeder(num_samples=n, split="train", seed=3),
                  batch_size=batch, shuffle=True, seed=5, num_workers=1)


def _put(copier):
    def put(batch):
        return copier([batch[0], batch[1].astype(np.int64)], lambda x, y: (x, y))
    return put


@pytest.mark.parametrize("card", [None, LazyCard], ids=["plain", "lazy_card"])
def test_prefetch_yields_the_plain_batches_in_order(card):
    loader = _loader()
    want = [(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))) for x, y, _ in loader]
    copier = Copier("cpu", card=card and card())
    got = list(prefetch(iter(loader), _put(copier)))
    assert len(got) == len(want) == 6  # 22 clips at 4, the last batch of 2
    assert not any(isinstance(item, Ready) for item in got)
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == wx.dtype and x.equal(wx)
        assert y.dtype == torch.int64 and y.equal(wy)
    if card is not None:
        assert copier.card.handed == len(want)


@pytest.mark.parametrize("where", ["iterator", "put"])
def test_an_exception_in_the_producer_reaches_the_consumer(where):
    def items():
        for k in range(5):
            if where == "iterator" and k == 3:
                raise ValueError("bad batch 3")
            yield k

    def put(k):
        if where == "put" and k == 3:
            raise ValueError("bad batch 3")
        return k

    seen = []
    with pytest.raises(ValueError, match="bad batch 3"):
        for k in prefetch(items(), put):
            seen.append(k)
    assert seen == [0, 1, 2]


def test_a_slot_is_not_rewritten_before_its_event_reports_done():
    """Seven batches of one shape and no consumer: each batch past the
    ring's SLOTS waits for the copy SLOTS batches back. Had a slot been
    written before its event reported done, the lazy copy of the earlier
    batch would carry the later batch's values."""
    assert loader_mod.SLOTS == 4
    copier = Copier("cpu", card=LazyCard())
    batches = [np.full((3, 4), k, np.float32) for k in range(7)]
    ready = [copier([b], lambda x: x) for b in batches]
    assert _counts() == (7, 0, 3)
    assert not ready[-1].event.query()  # the last copy is still queued
    for k, r in enumerate(ready):
        assert r.hand_over().equal(torch.full((3, 4), float(k)))
    # another shape has a ring of its own: no wait
    copier([np.zeros(7, np.int64)], lambda x: x)
    assert _counts() == (8, 0, 3)


def test_the_counters_count_pinned_and_plain_batches_and_slot_waits():
    loader = _loader(n=16)
    list(prefetch(iter(loader), _put(Copier("cpu"))))
    assert _counts() == (0, 4, 0)
    # the queue's depth plus two slots: the lazy copies run at each hand-over,
    # so the producer never finds its slot's copy in flight
    list(prefetch(iter(loader), _put(Copier("cpu", card=LazyCard()))))
    assert _counts() == (4, 4, 0)
    # no consumer: no copy runs, and each array of the batches past the
    # ring's SLOTS waits for its slot
    copier = Copier("cpu", card=LazyCard())
    for x, y, _ in [*loader, *loader]:
        copier([x, y.astype(np.int64)], lambda *t: t)
    assert _counts() == (12, 4, 4 * 2)


def _trainer(tmp_path, name):
    import yaml

    parser = base_parser()
    with open(SMOKE) as f:
        parser.set_defaults(**yaml.safe_load(f))
    return RecognitionTrainer(parser.parse_args([
        "--use_gpu", "false", "--work_dir", str(tmp_path / name), "--print_log", "false",
        "--model_args", "base_channel=8", "--batch_size", "4", "--test_batch_size", "4",
        "--train_feeder_args", "num_samples=12", "--test_feeder_args", "num_samples=6",
        "--num_worker", "1"]))


def test_a_cpu_trainer_copies_on_the_plain_path(tmp_path):
    """The trainer's copier on a CPU device: no card, and `_put` gives
    `torch.from_numpy` of the batch's arrays, the labels in int64."""
    t = _trainer(tmp_path, "plain")
    assert t.copier.card is None and t.copier.device == torch.device("cpu")
    batch = next(iter(t.loaders["train"]))
    (x,), y, y_np = t._put(batch)
    assert x.device.type == "cpu" and x.is_contiguous()
    assert x.dtype == torch.float32 and x.equal(torch.from_numpy(batch[0]))
    assert y.dtype == torch.int64 and y.equal(torch.from_numpy(batch[1]).long())
    assert y_np is batch[1]
    assert _counts() == (0, 1, 0)


def test_a_trainer_through_the_lazy_card_matches_the_plain_path(tmp_path):
    """An epoch and a pass of a CPU trainer whose copier goes through the
    stand-in card: the losses, scores and state equal the plain path's bit
    for bit, and every batch went through the card."""
    runs = []
    for name in ("plain", "lazy"):
        t = _trainer(tmp_path, name)
        if name == "lazy":
            t.copier = Copier(t.device, card=LazyCard())
        losses = t.train_epoch(0)
        test_loss, top1, _ = t.test_epoch()
        runs.append((losses, test_loss, t.result_scores,
                     [p.detach().clone() for p in t.model.parameters()]))
    (l0, e0, s0, p0), (l1, e1, s1, p1) = runs
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(s0, s1)
    assert e0 == e1 and all(a.equal(b) for a, b in zip(p0, p1))
    assert _counts() == (3 + 2, 3 + 2, 0)  # 12 clips at 4; 6 at 4, the last of 2


@pytest.mark.cuda
def test_the_card_hands_the_steps_the_plain_paths_batches(tmp_path):
    """One NW-UCLA train epoch (318 steps of 16) and one eval pass (7 of 64,
    one of 16) of gcn.yaml on the card through the pinned path: every batch
    each step was handed equals, bit for bit, the plain path's copy of the
    same loader's batch; every batch went through the pinned path and the
    producer never waited for a slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    import chip_smoke

    clips = str(tmp_path / "clips")
    chip_smoke.write_nucla_clips(clips)
    t = RecognitionTrainer(load_config([
        "-c", GCN_YAML, "--work_dir", str(tmp_path / "run"), "--print_log", "false",
        "--train_feeder_args", f"data_path={clips}", "--test_feeder_args",
        f"data_path={clips}", "--num_epoch", "1"]))
    assert t.device.type == "cuda" and t.copier.card is not None
    t._ensure_steps()
    seen = {name: [] for name in t.steps}
    for name, step in list(t.steps.items()):
        def recorded(*args, step=step, name=name):
            seen[name].append([a.clone() for a in args])  # on the step's stream
            return step(*args)
        t.steps[name] = recorded
    t.train_epoch(0)
    t.test_epoch()
    torch.cuda.synchronize()
    n_train, n_eval = len(t.loaders["train"]), len(t.loaders["test"])
    assert (n_train, n_eval) == (318, 8)
    assert _counts() == (n_train + n_eval, 0, 0)

    t.copier = Copier("cpu")  # the plain path, on the same loaders' batches
    t.loaders["train"].set_epoch(0)
    for name, split in (("train", "train"), ("eval", "test")):
        plain = [t._put(b) for b in t.loaders[split]]
        assert len(plain) == len(seen[name])
        for (inputs, label, _), got in zip(plain, seen[name]):
            want = [*inputs, label]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.cpu().equal(w)
