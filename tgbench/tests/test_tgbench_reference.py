"""The plain reference against the program at small sizes on the CPU: the
network in float64 (evaluation and training mode), the graphs, the two
feeders' batches bit for bit, the loader's order and one SGD step."""
import numpy as np
import pytest
import torch

from tgbench import clips, program, weights
from tgbench.reference import feeders, graphs, model as ref, sgd

CONFIGS = {
    "nucla": dict(num_class=10, num_point=20, num_person=1, graph="ucla", base_channel=8),
    "ntu": dict(num_class=60, num_point=25, num_person=2, graph="ntu_rgb_d", base_channel=8),
}


def port_model(cfg):
    from tamgcn_tpu_torch.models import get_model

    return get_model("ctrgcn", num_class=cfg["num_class"], num_point=cfg["num_point"],
                     num_person=cfg["num_person"], graph=cfg["graph"],
                     graph_args={"labeling_mode": "spatial"}, base_channel=cfg["base_channel"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_network_matches_the_program_in_float64(name):
    cfg = CONFIGS[name]
    model = port_model(cfg).double()
    w = {k: v.double() for k, v in weights.make(cfg, 3, "cpu").items()}
    program.load(model, w)
    x = torch.randn(3, 3, 16, cfg["num_point"], cfg["num_person"], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    for train in (False, True):
        model.train(train)
        got, want = model(x), ref.forward(cfg, w, x, train=train)
        assert torch.allclose(got, want, rtol=1e-10, atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["ucla", "ntu_rgb_d"])
def test_graphs(name):
    from tamgcn_tpu_torch.graphs import get_graph

    np.testing.assert_array_equal(graphs.spatial_graph(name),
                                  get_graph(name, labeling_mode="spatial").A)


def _port_feeder(kind, root, split, **args):
    from tamgcn_tpu_torch.data import get_feeder

    return get_feeder(kind, data_path=root, split=split, **args)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_nucla_batches_bit_for_bit(tmp_path, backend):
    data = {"layout": "nucla", "splits": "data/nucla_splits.json", "num_point": 20, "limit": 64}
    written = clips.write(str(tmp_path), data, 2 ** 33 + 1)
    for split, train in (("train", True), ("val", False)):
        feeder = _port_feeder("nucla_gcn", str(tmp_path), split, debug=True, seed=2 ** 33 + 1,
                              repeat=2 if train else 1, backend=backend)
        if backend == "native" and feeder.backend != "native":
            pytest.skip("the native core does not build here")
        from tamgcn_tpu_torch.data import Loader

        loader = Loader(feeder, batch_size=8, shuffle=train, drop_last=train, seed=2 ** 33 + 1)
        loader.set_epoch(1)
        order = feeders.order(len(feeder), 2 ** 33 + 1, 1) if train else np.arange(len(feeder))
        s = written[split]
        for k, (x, y, _) in enumerate(loader):
            want, labels = feeders.batch(s.clips, s.labels, order[8 * k:8 * k + 8], train=train,
                                         seed=2 ** 33 + 1, epoch=1, steps=52, persons=1)
            np.testing.assert_array_equal(x, want)
            np.testing.assert_array_equal(y, labels)


def test_two_person_batches_bit_for_bit(tmp_path):
    data = {"layout": "skeleton", "num_point": 25, "num_class": 60, "mutual_from": 50,
            "frames": [30, 90], "train_clips": 64, "val_clips": 8}
    written = clips.write(str(tmp_path), data, 5)
    from tamgcn_tpu_torch.data import Loader

    for split, train in (("train", True), ("val", False)):
        feeder = _port_feeder("skeleton_gcn", str(tmp_path), split, seed=5, time_steps=64,
                              num_person=2)
        loader = Loader(feeder, batch_size=8, shuffle=train, drop_last=train, seed=5)
        order = feeders.order(len(feeder), 5, 0) if train else np.arange(len(feeder))
        s = written[split]
        if train:  # the mutual classes' clips hold two persons
            assert any(c.ndim == 4 for c in s.clips) and any(c.ndim == 3 for c in s.clips)
        for k, (x, y, _) in enumerate(loader):
            want, labels = feeders.batch(s.clips, s.labels, order[8 * k:8 * k + 8], train=train,
                                         seed=5, epoch=0, steps=64, persons=2)
            np.testing.assert_array_equal(x, want)
            np.testing.assert_array_equal(y, labels)


def test_sgd_step_matches_the_packed_step():
    """One step of the program's packed SGD (float64, on the CPU) against
    the reference's, from the same weights and batch."""
    from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step

    cfg = CONFIGS["nucla"]
    model = port_model(cfg).double().train()
    w = {k: v.double() for k, v in weights.make(cfg, 4, "cpu").items()}
    model.load_state_dict(w)
    state = PackedTrainState(model, "SGD", nesterov=True, weight_decay=1e-4)
    state.set_lr(0.05)
    x = torch.randn(4, 3, 16, 20, 1, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 2, 3, 4])
    step = make_fused_train_step(state)
    step(x, y)
    step(x, y)
    losses, first, after, _ = sgd.train_steps(lambda ww, xx: ref.forward(cfg, ww, xx, train=True), w,
                                           [(x, y), (x, y)], [0.05, 0.05], 1e-4)
    for name, p in model.named_parameters():
        assert torch.allclose(p, after[name], rtol=1e-9, atol=1e-12), name


def test_learning_rate_matches_the_program():
    from tamgcn_tpu_torch.train.optim import make_lr_schedule

    schedule = make_lr_schedule(0.1, [35, 55], 0.1, 10, 5)
    for k in (0, 9, 10, 49, 50, 349, 350, 551):
        assert sgd.learning_rate(k, base_lr=0.1, steps_per_epoch=10, warm_up_epoch=5,
                                 decay_epochs=[35, 55], decay_rate=0.1) == schedule(k)
