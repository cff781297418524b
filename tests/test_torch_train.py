"""The port's training against the JAX package's, on the CPU.

  * one train-mode step of the port's CTR-GCN (base_channel 8, batch 16,
    T=52) from the perturbed, converted variables: the loss, every parameter gradient and
    the updated BatchNorm running stats against `jax.value_and_grad` of the
    JAX model with `mutable=["batch_stats"]`;
  * the lr schedule and the flat-space SGD/Adam updates against
    tamgcn_tpu.train.optim (optax);
  * a trajectory: the port's RecognitionTrainer on configs/nucla/smoke.yaml
    (--use_gpu false, base_channel 8, --weights of the converted variables)
    runs 3 steps; its loss per step, final parameters and BN stats are held
    against a reference built eagerly from the JAX package's pieces
    (`model.apply`, `make_optimizer`, the same synthetic batches in the same
    shuffled order);
  * --resume gives what an uninterrupted run gives, and the CLI train phase
    writes its checkpoints, progress csv and score pickle.

The model comparisons run in float64 on both sides (the port's model
`.double()`, JAX with x64): through ten blocks of train-mode BatchNorm the
scalar alphas' gradients are ill-conditioned, and f32 alone moves them by
percent, so f32 could not tell a semantics bug from rounding; in f64 the
agreement is ~1e-9 and the tolerances below are tight. The optimizer
comparisons run in f32 at rtol 1e-5.
"""
import contextlib
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.data import Loader as JaxLoader
from tamgcn_tpu.data.synthetic import SyntheticSkeletonFeeder as JaxSynthetic
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.train import optim as jax_optim
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.train import optim
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
from _numerics import perturb_offset_convs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8


def _perturbed(variables, seed=6):
    """alpha and the offset convs perturbed (tests/_numerics.py) and every
    gcn1/bn/scale O(1), as test_torch_model.py:perturbed_variables moves
    them; every value rounded to f32 and widened, so that the f32 weight
    file of the trainer holds them exactly."""
    rs = np.random.RandomState(seed)
    params = perturb_offset_convs(variables["params"], scale=0.3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: 1.0 + 0.1 * rs.randn(*v.shape)
        if "/".join(k.key for k in p[-3:]) == "gcn1/bn/scale" else v, params)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(np.asarray(a, np.float32), np.float64),
        {"params": params, "batch_stats": variables["batch_stats"]})


@pytest.fixture(scope="module")
def start():
    """(JAX model, f64 variables, jitted value_and_grad of the train-mode
    loss), with JAX in x64 until the module's tests are done. The JAX side
    is jitted, once, at the one input shape the tests use: run eagerly, one
    train-mode value_and_grad of this model takes ~80 s on the CPU, against
    ~15 s to compile and 0.4 s to run (and init ~35 s against ~11 s)."""
    jm = jax_create(use_pallas=False, base_channel=BC)
    x = jnp.zeros((2, 3, 52, 20, 1), jnp.float32)
    init = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(2), x))
    jax.config.update("jax_enable_x64", True)
    try:
        yield jm, _perturbed(init), jax.jit(jax.value_and_grad(
            functools.partial(_jax_loss, jm), has_aux=True))
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_model(variables):
    model = create_ctrgcn_nucla(base_channel=BC).double()
    model.load_state_dict(from_flax(variables, model))
    return model


def _jax_loss(jm, params, stats, x, y):
    out, mutated = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
    loss = optax.softmax_cross_entropy_with_integer_labels(out, y).mean()
    return loss, mutated["batch_stats"]


def _close(got, want, rtol, atol_frac, what):
    """Within rtol and atol_frac * max|want|, with a floor of 1e-12: the
    biases that feed a train-mode BatchNorm, and the running means of BNs
    whose inputs have a zero batch mean, hold rounding noise only."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()) + 1e-12,
                               err_msg=what)


def test_train_step_grads_and_stats_match_jax(start):
    jm, variables, value_and_grad = start
    rs = np.random.RandomState(11)
    x = rs.randn(16, 3, 52, 20, 1)
    y = rs.randint(0, 10, size=16)
    (loss, stats), grads = value_and_grad(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    model = _port_model(variables).train()
    want = from_flax(jax.device_get({"params": grads, "batch_stats": stats}), model)
    got = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-12)
    # biases that feed a train-mode BatchNorm have gradients of rounding size
    # only (~1e-15): every gradient also gets a floor of 1e-9 x the largest
    floor = 1e-9 * max(float(np.abs(want[n].numpy()).max())
                       for n, _ in model.named_parameters())
    bad = []
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w)
        if (err > 1e-7 * np.abs(w) + 1e-9 * np.abs(w).max() + floor).any():
            bad.append(f"{name}: max err {err.max():.3e}, max|jax| {np.abs(w).max():.3e}")
    assert not bad, bad
    for name, b in model.named_buffers():
        _close(b.numpy(), want[name].numpy(), 1e-9, 1e-7, name)
    assert all(p.grad.abs().max() > 1e-3 for n, p in model.named_parameters()
               if n.endswith("gcn1.alpha"))


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=0.1, decay_epochs=[3, 5], decay_rate=0.1,
              steps_per_epoch=4, warm_up_epoch=2)
    ours = optim.make_lr_schedule(**kw)
    ref = jax_optim.make_lr_schedule(**kw)
    got = [ours(k) for k in range(32)]
    want = [float(ref(k)) for k in range(32)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.05 and got[4] == 0.1 and abs(got[12] - 0.01) < 1e-12
    assert abs(got[20] - 0.001) < 1e-12  # both boundaries passed


@pytest.mark.parametrize("name,nesterov", [("SGD", True), ("SGD", False), ("Adam", True)])
def test_optimizer_updates_match_optax(name, nesterov):
    """The flat-space optimiser (train/optim.py) on one flat buffer of the
    parameters against the optax chain on the same leaves, the lr of each
    step from the schedule through the 0-d lr tensor. optax runs with x64
    on, as it does after the module fixture: its lr and Adam's bias
    corrections in f64, as the port computes them (in f32, 1 - 0.999^k
    keeps 3 digits)."""
    rs = np.random.RandomState(5)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = {f"p{i}": rs.randn(*s).astype(np.float32) for i, s in enumerate(shapes)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    kw = dict(steps_per_epoch=2, step=[2], lr_decay_rate=0.1, warm_up_epoch=1,
              nesterov=nesterov, weight_decay=1e-2)
    with _x64():
        ref, got = _optax_and_flat(name, nesterov, params, grads, kw)
    for k, (want_k, got_k) in enumerate(zip(ref, got)):
        for (key, want), p in zip(want_k.items(), got_k):
            np.testing.assert_allclose(p.reshape(want.shape), want,
                                       rtol=1e-5, atol=1e-6, err_msg=f"{key} step {k}")


@contextlib.contextmanager
def _x64():
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _optax_and_flat(name, nesterov, params, grads, kw):
    """Per step: the optax chain's parameters and the flat optimiser's."""
    tx = jax_optim.make_optimizer(name, 0.1, **kw)
    ref = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(ref)
    flat = torch.from_numpy(np.concatenate([v.ravel() for v in params.values()]))
    opt = optim.make_optimizer(name, [flat], nesterov=nesterov, weight_decay=1e-2)
    lr = torch.zeros(())
    schedule = optim.make_lr_schedule(0.1, [2], 0.1, 2, 1)
    wants, gots = [], []
    for k, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, ref)
        ref = optax.apply_updates(ref, updates)
        lr.fill_(schedule(k))
        flat_g = torch.from_numpy(np.concatenate([g[key].ravel() for key in params]))
        opt.update([flat], [flat_g], [lr], [None])
        wants.append({key: np.asarray(v) for key, v in ref.items()})
        gots.append(np.split(flat.numpy().copy(),
                             np.cumsum([v.size for v in params.values()])[:-1]))
    return wants, gots


def _widen(inputs, label, label_np):
    return tuple(t.double() for t in inputs), label, label_np


def test_trainer_trajectory_matches_jax(start, tmp_path, monkeypatch):
    jm, variables, value_and_grad = start
    path = str(tmp_path / "converted.pt")
    torch.save(from_flax(variables, create_ctrgcn_nucla(base_channel=BC)), path)
    n_steps, batch = 3, 16
    arg = load_config([
        "-c", SMOKE, "--phase", "train", "--use_gpu", "false", "--weights", path,
        "--work_dir", str(tmp_path / "wd"), "--model_args", f"base_channel={BC}",
        "--train_feeder_args", f"num_samples={n_steps * batch}", "--num_worker", "2",
        "--num_epoch", "1", "--print_log", "false",
    ])
    trainer = RecognitionTrainer(arg)
    assert trainer.steps_per_epoch == n_steps and arg.batch_size == batch
    trainer.model.double()  # in place: the optimizer keeps its parameters
    put = trainer._put
    monkeypatch.setattr(trainer, "_put", lambda b: _widen(*put(b)))
    losses = trainer.train_epoch(0)

    # the JAX reference: the trainer's loader, optimizer and train-mode apply
    feeder = JaxSynthetic(num_samples=n_steps * batch, split="train", seed=arg.seed)
    loader = JaxLoader(feeder, batch_size=batch, shuffle=True, drop_last=True,
                       seed=arg.seed, num_workers=2)
    loader.set_epoch(0)
    tx = jax_optim.make_optimizer(
        "SGD", arg.base_lr, steps_per_epoch=n_steps, step=arg.step,
        lr_decay_rate=arg.lr_decay_rate, warm_up_epoch=arg.warm_up_epoch,
        nesterov=arg.nesterov, weight_decay=arg.weight_decay)
    params, stats = variables["params"], variables["batch_stats"]
    state = tx.init(params)
    want_losses = []
    for x, label, _ in loader:
        (loss, stats), grads = value_and_grad(
            params, stats, jnp.asarray(x, jnp.float64), jnp.asarray(label))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))
    assert len(want_losses) == n_steps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-7)
    want = from_flax(jax.device_get({"params": params, "batch_stats": stats}),
                     trainer.model)
    for name, t in trainer.model.state_dict().items():
        _close(t.numpy(), want[name].numpy(), 1e-6, 1e-8, name)


def _cli(work_dir, *extra):
    return main([
        "recognition", "-c", SMOKE, "--phase", "train", "--use_gpu", "false",
        "--work_dir", str(work_dir), "--model_args", f"base_channel={BC}",
        "--train_feeder_args", "num_samples=32", "--test_feeder_args",
        "num_samples=16", "--num_worker", "2", "--print_log", "false", *extra,
    ])


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The work dir of 2 epochs of 2 steps, checkpoints after each."""
    work_dir = tmp_path_factory.mktemp("straight")
    assert _cli(work_dir, "--num_epoch", "2", "--save_interval", "1") == 0
    return work_dir


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_resume_matches_straight_run(straight, tmp_path):
    assert _cli(tmp_path, "--num_epoch", "1") == 0
    assert _cli(tmp_path, "--num_epoch", "2", "--resume", "true") == 0
    a = _load(straight / "checkpoints" / "epoch2.pt")
    b = _load(tmp_path / "checkpoints" / "epoch2.pt")
    assert a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["optimizer"]["state"].items():
        assert torch.equal(v["momentum_buffer"], b["optimizer"]["state"][k]["momentum_buffer"])


def test_cli_train_phase_writes_its_files(straight):
    rows = np.loadtxt(straight / "progress_info.csv", delimiter=",")
    assert rows.shape == (2, 4) and np.isfinite(rows).all()
    for n in (1, 2):
        ckpt = _load(straight / "checkpoints" / f"epoch{n}.pt")
        assert set(ckpt) == {"model", "optimizer", "step"} and ckpt["step"] == 2 * n
    best = _load(straight / "checkpoints" / "best.pt")
    assert set(best) == {"model", "step"}
    # the score pickle of the best epoch: the first epoch whose top-1 is the max
    epoch = int(np.argmax(rows[:, 2])) + 1
    assert best["step"] == 2 * epoch
    with open(straight / f"test_result_epoch{epoch}.pkl", "rb") as f:
        scores = pickle.load(f)
    assert len(scores) == 16 and all(v.shape == (10,) for v in scores.values())
    assert os.path.isfile(straight / "log.txt")


def test_weights_take_a_training_checkpoint(straight, tmp_path):
    """--weights accepts best.pt and evaluates its model state."""
    path = str(straight / "checkpoints" / "best.pt")
    argv = ["recognition", "-c", SMOKE, "--phase", "test", "--use_gpu", "false",
            "--weights", path, "--work_dir", str(tmp_path),
            "--model_args", f"base_channel={BC}", "--save_result", "true",
            "--test_feeder_args", "num_samples=16", "--num_worker", "2",
            "--print_log", "false"]
    assert main(argv) == 0
    with open(tmp_path / "test_result.pkl", "rb") as f:
        scores = pickle.load(f)
    model = create_ctrgcn_nucla(base_channel=BC)
    model.load_state_dict(_load(path)["model"])
    feeder = JaxSynthetic(num_samples=16, split="val", seed=1)
    x = torch.from_numpy(np.stack([feeder[i][0] for i in range(16)]))
    with torch.no_grad():
        want = model.eval()(x).numpy()
    got = np.stack([scores[name] for name in feeder.sample_name])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_dropout_raises_in_training(tmp_path):
    """drop_out trains: the CLI train phase with drop_out 0.5 runs, and its
    trainer's step draws from the seeded stream (a training forward outside
    one raises)."""
    model = create_ctrgcn_nucla(base_channel=BC, drop_out=0.5)
    x = torch.zeros((2, 3, 8, 20, 1))
    with torch.no_grad():
        assert model.eval()(x).shape == (2, 10)
    with pytest.raises(RuntimeError, match="seeded stream"):
        model.train()(x)
    assert main(["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir",
                 str(tmp_path), "--model_args", f"base_channel={BC}", "drop_out=0.5",
                 "--num_epoch", "1", "--batch_size", "8", "--train_feeder_args",
                 "num_samples=16", "--test_feeder_args", "num_samples=8",
                 "--num_worker", "1", "--print_log", "false"]) == 0
    tree = torch.load(tmp_path / "checkpoints" / "epoch1.pt", weights_only=True)
    assert tree["step"] == 2 and all(torch.isfinite(v).all() for v in tree["model"].values())
