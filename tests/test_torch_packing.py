"""The port's packed train state and fused step against the JAX package's.

  * `make_fused_train_step` (tamgcn_tpu_torch/train/packing.py) on a
    CTR-GCN at base_channel 8 against the JAX `make_fused_train_step`
    (tamgcn_tpu/train/packing.py) with the optax chain of
    tamgcn_tpu/train/optim.py, on the same weights (`convert.from_flax`) and
    batches, 3 steps in f64: the losses, every parameter, the optimiser's
    state (SGD's momentum; Adam's moments and step) and the BatchNorm
    statistics after the last step. SGD (Nesterov) with an lr that decays
    within the 3 steps, and Adam. The JAX step is jitted once per optimiser
    at one shape (eager, a train-mode value_and_grad of this model takes
    ~80 s on the CPU);
  * `freeze_mask_for` against the JAX one on the same path prefixes, and a
    CLI train run with `--freeze_params l1` (the model and batches widened
    to f64 around `__main__.main`) against the JAX fused step with the same
    mask: frozen parameters (l1 and l10, as JAX's prefix match takes them)
    unchanged, their momentum advancing as JAX's;
  * the packing itself: every gradient stays a view of the flat gradient
    after the step and after a `backward()`; `load_state_dict` and
    `--resume` write the flat buffers in place (no `data_ptr` moves); a
    checkpoint holds each tensor in its own storage; a model cast after
    packing is refused; the fast-eval step folds the weights it runs with.

Tolerances as tests/test_torch_train.py's trajectory: f64 on both sides,
losses within rtol 1e-7, each tensor within rtol 1e-6 and 1e-8 x its max
(+1e-12: the biases that feed a train-mode BatchNorm hold rounding noise).
Adam divides each update by its gradient's size, so its parameters also
get 1e-5 of the lrs' sum (ADAM_ATOL), and its run starts with those
BatchNorm-fed biases away from zero (_bn_fed_biases_moved).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tamgcn_tpu.data import Loader as JaxLoader
from tamgcn_tpu.data.synthetic import SyntheticSkeletonFeeder as JaxSynthetic
from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.train import optim as jax_optim
from tamgcn_tpu.train import packing as jax_packing
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import flax_param_paths, from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval, make_fast_eval_step
from tamgcn_tpu_torch.train import optim
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.graphs import GraphedStep
from tamgcn_tpu_torch.train.packing import (
    PackedTrainState, _layout, freeze_mask_for, make_fused_train_step)
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
from test_torch_train import BC, SMOKE, _close, _perturbed

torch.set_num_threads(1)
STEPS, BATCH = 3, 16
# the lr of each step: 0.1, 0.1, then 0.01 (one step an epoch, decay at epoch 2)
SCHEDULE = dict(steps_per_epoch=1, step=[2], lr_decay_rate=0.1, warm_up_epoch=0,
                nesterov=True, weight_decay=1e-4)
ADAM_ATOL = 1e-5 * (0.1 + 0.1 + 0.01)  # 1e-5 of the lrs' sum


@pytest.fixture(scope="module")
def start():
    """(JAX model, f64 perturbed variables), JAX in x64 until the module's
    tests are done."""
    jm = jax_create(use_pallas=False, base_channel=BC)
    x = jnp.zeros((2, 3, 52, 20, 1), jnp.float32)
    init = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(2), x))
    jax.config.update("jax_enable_x64", True)
    try:
        yield jm, _perturbed(init)
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_run(jm, variables, tx, batches, freeze=()):
    """The JAX fused step (jitted once) over `batches`: (losses, params,
    stats, optimiser state as {leaf name: params-shaped tree})."""
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p, s, inputs, label, rng):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, *inputs, train=True,
                                mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(out, label).mean()
        return loss, (out, mutated["batch_stats"])

    mask = jax_packing.freeze_mask_for(params, tuple(freeze))
    step, pstate, unravel_p, unravel_s = jax_packing.make_fused_train_step(
        loss_fn, tx, params, stats, freeze_mask=mask)
    step = jax.jit(step)
    losses = []
    for x, y in batches:
        pstate, loss, _ = step(pstate, (jnp.asarray(x, jnp.float64),), jnp.asarray(y),
                               jax.random.PRNGKey(0))
        losses.append(float(loss))
    opt = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(pstate.opt_state)[0]:
        name = getattr(path[-1], "name", None)
        if name in ("trace", "mu", "nu"):
            opt[name] = unravel_p(leaf)
        elif name == "count":
            opt[name] = int(leaf)
    return (losses, unravel_p(pstate.flat_params), unravel_s(pstate.flat_stats), opt)


def _port_tree(params, stats, model):
    """{port name: tensor} of a JAX params (and stats) tree."""
    return from_flax(jax.device_get({"params": params, "batch_stats": stats}), model)


def _batches(seed=11):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, 3, 52, 20, 1), rs.randint(0, 10, size=BATCH))
            for _ in range(STEPS)]


def _port_model(variables):
    model = create_ctrgcn_nucla(base_channel=BC).double()
    model.load_state_dict(from_flax(variables, model))
    return model.train()


# the biases of the convs that feed a train-mode BatchNorm: their gradient
# is rounding noise (the BatchNorm removes a per-channel shift)
BN_FED_BIASES = ("down_conv/bias", "offset_conv/bias", "prefix_conv/bias",
                 "tconv_conv/bias", "pw_conv/bias", "residual/conv/bias")


def _bn_fed_biases_moved(variables, seed=3):
    """The variables with every BN-fed bias drawn from N(0, 0.1^2) (they
    start at zero). Adam divides an update by its gradient's own size, so a
    bias whose gradient is rounding noise would step by +-lr in a direction
    the rounding picks; with the bias away from zero, the weight decay's
    term sets the direction."""
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: 0.1 * rs.randn(*v.shape)
        if "/".join(k.key for k in p).endswith(BN_FED_BIASES) else v,
        variables["params"])
    return dict(variables, params=params)


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_packed_step_matches_jax_fused_step(start, name):
    jm, variables = start
    if name == "Adam":
        variables = _bn_fed_biases_moved(variables)
    batches = _batches()
    tx = jax_optim.make_optimizer(name, 0.1, **SCHEDULE)
    want_losses, params, stats, opt = _jax_run(jm, variables, tx, batches)

    model = _port_model(variables)
    state = PackedTrainState(model, name, weight_decay=SCHEDULE["weight_decay"])
    step = make_fused_train_step(state)
    schedule = optim.make_lr_schedule(0.1, SCHEDULE["step"], 0.1, 1)
    assert [schedule(k) for k in range(STEPS)] == pytest.approx([0.1, 0.1, 0.01])
    losses, hits = [], []
    for k, (x, y) in enumerate(batches):
        state.set_lr(schedule(k))
        loss, hit = step(torch.from_numpy(x), torch.from_numpy(y))
        losses.append(loss.item())
        hits.append(int(hit))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-7)
    assert all(0 <= h <= BATCH for h in hits)
    want = _port_tree(params, stats, model)
    names = [n for n, _ in model.named_parameters()]
    for key, t in model.state_dict().items():
        if name == "Adam" and key in names:
            # Adam divides by the gradient's own size: a gradient known to
            # 1e-5 of itself (tests/test_torch_train.py holds an element to
            # 1e-7 of itself + 1e-9 of its tensor's largest) moves a
            # parameter by lr x 1e-5 at most
            w = want[key].numpy()
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, err_msg=key,
                                       atol=1e-8 * np.abs(w).max() + ADAM_ATOL)
        else:
            _close(t.numpy(), want[key].numpy(), 1e-6, 1e-8, key)
    got = state.optimizer_state_dict()["state"]
    pairs = {"SGD": [("momentum_buffer", "trace")],
             "Adam": [("exp_avg", "mu"), ("exp_avg_sq", "nu")]}[name]
    for ours, theirs in pairs:
        want = _port_tree(opt[theirs], stats, model)
        for i, key in enumerate(names):
            _close(got[i][ours].numpy(), want[key].numpy(), 1e-6, 1e-8, f"{ours} {key}")
    if name == "Adam":
        assert all(float(got[i]["step"]) == opt["count"] == STEPS for i in range(len(names)))


def _jax_mask_tree(params, prefixes):
    mask = jax_packing.freeze_mask_for(params, prefixes)
    _, unravel = jax.flatten_util.ravel_pytree(params)
    return unravel(mask)


@pytest.mark.parametrize("prefixes", [("l1",), ("l2/gcn1", "fc"), ("data_bn/scale",),
                                      ("l5/tcn1/branch0",)])
def test_freeze_mask_matches_jax(start, prefixes):
    jm, variables = start
    model = _port_model(variables)
    want = _port_tree(_jax_mask_tree(variables["params"], prefixes),
                      variables["batch_stats"], model)
    masks = freeze_mask_for(model, prefixes)
    named = list(model.named_parameters())
    _, _, slots = _layout([p for _, p in named])
    n_frozen = 0
    for (key, p), (g, o, n) in zip(named, slots):
        got = masks[g][o:o + n].view(p.shape).numpy()
        np.testing.assert_array_equal(got, want[key].numpy(), err_msg=key)
        n_frozen += int(not got.any())
    assert 0 < n_frozen < len(named)
    assert freeze_mask_for(model, ()) is None


def test_flax_param_paths_are_the_jax_paths(start):
    jm, variables = start
    paths = flax_param_paths(_port_model(variables))
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    want = {"/".join(str(k.key) for k in path) for path, _ in flat}
    assert set(paths.values()) == want and len(paths) == len(want)


def _cli_argv(work_dir, weights, *extra):
    return ["recognition", "-c", SMOKE, "--phase", "train", "--use_gpu", "false",
            "--weights", weights, "--work_dir", str(work_dir),
            "--model_args", f"base_channel={BC}",
            "--train_feeder_args", f"num_samples={BATCH}",
            "--test_feeder_args", "num_samples=8", "--test_batch_size", "8",
            "--batch_size", str(BATCH), "--num_worker", "2", "--print_log", "false",
            "--num_epoch", str(STEPS), "--eval_interval", str(STEPS),
            "--save_interval", str(STEPS), "--base_lr", "0.1",
            "--step", *map(str, SCHEDULE["step"]), "--lr_decay_rate", "0.1",
            "--warm_up_epoch", "0", "--weight_decay", str(SCHEDULE["weight_decay"]),
            *extra]


def _widened(monkeypatch):
    """RecognitionTrainer with its model and batches in f64 (the model cast
    before the steps are built, so the packed state is f64)."""
    load_model, put = RecognitionTrainer._load_model, RecognitionTrainer._put

    def load_model_f64(self):
        load_model(self)
        self.model.double()

    def put_f64(self, batch):
        inputs, label, label_np = put(self, batch)
        return tuple(t.double() for t in inputs), label, label_np

    monkeypatch.setattr(RecognitionTrainer, "_load_model", load_model_f64)
    monkeypatch.setattr(RecognitionTrainer, "_put", put_f64)


def test_cli_freeze_params_matches_jax(start, tmp_path, monkeypatch):
    """`--freeze_params l1` in the train phase: 3 epochs of one step through
    __main__.main (in f64) against the JAX fused step with the freeze mask
    of ("l1",) on the same batches: every tensor and the momentum after the
    last step; l1 and l10 keep their weights and their momentum moves."""
    jm, variables = start
    weights = str(tmp_path / "converted.pt")
    torch.save(from_flax(variables, create_ctrgcn_nucla(base_channel=BC)), weights)
    _widened(monkeypatch)
    assert main(_cli_argv(tmp_path / "wd", weights, "--freeze_params", "l1")) == 0
    ckpt = torch.load(tmp_path / "wd" / "checkpoints" / f"epoch{STEPS}.pt",
                      weights_only=True)
    assert ckpt["step"] == STEPS

    feeder = JaxSynthetic(num_samples=BATCH, split="train", seed=1)
    loader = JaxLoader(feeder, batch_size=BATCH, shuffle=True, drop_last=True, seed=1,
                       num_workers=2)
    batches = []
    for epoch in range(STEPS):
        loader.set_epoch(epoch)
        batches += [(x, y) for x, y, _ in loader]
    tx = jax_optim.make_optimizer("SGD", 0.1, **SCHEDULE)
    _, params, stats, opt = _jax_run(jm, variables, tx, batches, freeze=("l1",))
    model = create_ctrgcn_nucla(base_channel=BC).double()
    want = _port_tree(params, stats, model)
    for key, t in ckpt["model"].items():
        _close(t.numpy(), want[key].numpy(), 1e-6, 1e-8, key)
    start_state = from_flax(variables, model)
    momentum = _port_tree(opt["trace"], stats, model)
    names = [n for n, _ in model.named_parameters()]
    frozen = [n for n in names if n.startswith(("l1.", "l10."))]
    assert frozen and any(n.startswith("l10.") for n in frozen)
    for i, key in enumerate(names):
        got = ckpt["optimizer"]["state"][i]["momentum_buffer"]
        _close(got.numpy(), momentum[key].numpy(), 1e-6, 1e-8, f"momentum {key}")
        if key in frozen:
            assert torch.equal(ckpt["model"][key], start_state[key]), key
    assert all(ckpt["optimizer"]["state"][names.index(k)]["momentum_buffer"].abs().max() > 0
               for k in frozen if k.endswith("conv3.weight"))


def _small_state(freeze=()):
    model = create_ctrgcn_nucla(base_channel=BC, generator=torch.Generator().manual_seed(4))
    return model.train(), PackedTrainState(model, "SGD", freeze_prefixes=freeze)


def _xy(n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, 16, 20, 1, generator=g), torch.randint(0, 10, (n,), generator=g)


def test_frozen_parameters_keep_their_values_and_momentum_advances():
    model, state = _small_state(freeze=("l1", "fc"))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state.set_lr(0.1)
    make_fused_train_step(state)(*_xy())
    momentum = state.optimizer_state_dict()["state"]
    n_frozen = 0
    for i, (n, p) in enumerate(model.named_parameters()):
        # after one step the momentum is the decayed gradient, frozen or not
        d = torch.add(p.grad, before[n], alpha=1e-4)
        torch.testing.assert_close(momentum[i]["momentum_buffer"], d, rtol=0, atol=0)
        if n.startswith(("l1.", "l10.", "fc.")):
            assert torch.equal(p, before[n]), n
            n_frozen += 1
        else:  # Nesterov's first update: d + 0.9 d
            torch.testing.assert_close(p, before[n] - 0.1 * (d + 0.9 * d), rtol=1e-6,
                                       atol=1e-9, msg=n)
    assert n_frozen == 30 + 26 + 2


def test_gradient_views_stay_views_after_backward():
    """Each parameter's .grad is its slot of the flat gradient: after the
    fused step (which gathers its gradients) and after a backward() by hand
    (which accumulates into them in place), it holds the gradient, and the
    flat buffer holds them all."""
    model, state = _small_state()
    x, y = _xy()
    slots = state.params.views(state.grads)

    def on_slots():
        return all(p.grad.data_ptr() == s.data_ptr() and p.grad.shape == s.shape
                   for p, s in zip(state.params.tensors, slots))

    params = state.params.tensors
    loss = torch.nn.functional.cross_entropy(model(x), y)
    want = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    state.set_lr(0.0)
    make_fused_train_step(state)(x, y)
    assert on_slots()
    for p, w in zip(params, want):
        torch.testing.assert_close(p.grad, w, rtol=1e-6, atol=1e-9)
    assert float(sum(g.abs().sum() for g in state.grads)) > 0
    for g in state.grads:
        g.zero_()
    torch.nn.functional.cross_entropy(model(x), y).backward()
    assert on_slots()
    for p, w in zip(params, want):
        torch.testing.assert_close(p.grad, w, rtol=1e-6, atol=1e-9)
    state.check()


def test_cast_after_packing_is_refused():
    model, state = _small_state()
    state.check()
    model.double()
    with pytest.raises(RuntimeError, match="no longer view"):
        state.check()


def _trainer(tmp_path, *extra):
    arg = load_config(["-c", SMOKE, "--phase", "train", "--use_gpu", "false",
                       "--work_dir", str(tmp_path), "--model_args", f"base_channel={BC}",
                       "--train_feeder_args", "num_samples=8", "--batch_size", "4",
                       "--test_feeder_args", "num_samples=4", "--num_worker", "1",
                       "--print_log", "false", *extra])
    return RecognitionTrainer(arg)


def _pointers(trainer):
    state = trainer.state
    return ([t.data_ptr() for t in state.tensors()]
            + [p.data_ptr() for p in trainer.model.parameters()]
            + [b.data_ptr() for b in trainer.model.buffers()])


def test_load_state_dict_and_resume_keep_the_flat_buffers(tmp_path):
    trainer = _trainer(tmp_path / "a", "--num_epoch", "1", "--save_interval", "1")
    trainer.start()
    ptrs = _pointers(trainer)
    ckpt = torch.load(tmp_path / "a" / "checkpoints" / "epoch1.pt", weights_only=True)
    # load_state_dict copies into the flat buffers
    other = {k: torch.randn_like(v) for k, v in ckpt["model"].items()}
    trainer.model.load_state_dict(other)
    assert _pointers(trainer) == ptrs
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, other[k]), k
    # --resume restores model and momentum in place
    momentum = [torch.full_like(f, 7.0) for f in trainer.state.optimizer.state["momentum_buffer"]]
    trainer.state.optimizer.state["momentum_buffer"][0].copy_(momentum[0])
    assert trainer.resume() == 1
    assert _pointers(trainer) == ptrs
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    got = trainer.state.optimizer_state_dict()["state"]
    for i, entry in ckpt["optimizer"]["state"].items():
        assert torch.equal(got[i]["momentum_buffer"], entry["momentum_buffer"]), i
    assert trainer.step == ckpt["step"] == 2


def test_resume_takes_a_torch_optim_checkpoint(tmp_path):
    """An optimizer state_dict in torch.optim.SGD's layout (as checkpoints of
    the port's earlier trainer hold) restores the flat momentum."""
    model, state = _small_state()
    sgd = torch.optim.SGD([torch.nn.Parameter(p.detach().clone()) for p in model.parameters()],
                          lr=0.1, momentum=0.9, nesterov=True)
    for p in sgd.param_groups[0]["params"]:
        p.grad = torch.randn_like(p)
    sgd.step()
    state.load_optimizer_state_dict(sgd.state_dict())
    got = state.optimizer_state_dict()["state"]
    for i, p in enumerate(sgd.param_groups[0]["params"]):
        assert torch.equal(got[i]["momentum_buffer"], sgd.state[p]["momentum_buffer"])


def test_checkpoint_tensors_have_their_own_storage(tmp_path):
    trainer = _trainer(tmp_path, "--num_epoch", "1", "--save_interval", "1")
    trainer.start()
    ckpt = torch.load(tmp_path / "checkpoints" / "epoch1.pt", weights_only=True)
    tensors = list(ckpt["model"].values()) + [
        t for entry in ckpt["optimizer"]["state"].values() for t in entry.values()]
    assert len(tensors) > 300
    for t in tensors:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    trainer._save_checkpoint("best")
    best = torch.load(tmp_path / "checkpoints" / "best.pt", weights_only=True)
    for t in best["model"].values():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_fast_eval_step_folds_the_weights_it_runs_with():
    model, _ = _small_state()
    model.eval()
    x, y = _xy(seed=2)
    step = make_fast_eval_step(model)
    with torch.inference_mode():
        step(x, y)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * torch.randn_like(p))
        loss, logits = step(x, y)
        want = make_fast_eval(model)(x)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    torch.testing.assert_close(loss, torch.nn.functional.cross_entropy(want, y))


def test_graphs_take_only_the_card():
    step = GraphedStep(lambda x: (x + 1,), "cpu")
    with pytest.raises(ValueError, match="on the card"):
        step(torch.zeros(2))
