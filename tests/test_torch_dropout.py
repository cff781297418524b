"""Seeded dropout (tamgcn_tpu_torch/ops/dropout.py) on the CPU.

  * statistics: the kept share of a mask at p = 0.1 and 0.5 lies within 5
    sigma of its binomial, the kept elements are scaled by 1 / (1 - p) and
    the rest are 0; eval and p = 0 are the identity;
  * keying: a mask is a function of (seed, step, site, element); another
    step, seed or site gives another mask, whose agreement with the first
    is that of two independent masks; the step as an int or as the packed
    state's device counter gives the same mask;
  * the packed train step draws each step's masks from its device counter
    and advances it (a graph replay reads it), and leaves the step of a
    model without dropout as it was;
  * resume: 4 train steps unbroken against 2, a checkpoint, a resume and 2
    more: losses, parameters, momentum and BatchNorm statistics bit for bit;
  * held against JAX with JAX's masks: the masks Flax's nn.Dropout draws
    inside the JAX model (recovered by an interceptor that applies each
    Dropout to ones) are handed to the port's sites (the test-only `masks`
    of `stream`), and the f64 loss, every gradient and the BatchNorm
    statistics agree within 1e-9: CTR-GCN `drop_out`, ST-GCN `dropout` and
    `block_dropout`, a small ResNet's `block_dropout`. Each JAX
    value_and_grad is jitted once, at one input shape.
"""
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.models import create_ctrgcn_nucla as jax_ctrgcn
from tamgcn_tpu.models import create_stgcn_nucla as jax_stgcn
from tamgcn_tpu.models import resnet as jax_resnet
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import create_ctrgcn_nucla, create_stgcn_nucla, resnet
from tamgcn_tpu_torch.ops import dropout
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.packing import PackedTrainState, make_fused_train_step
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer
from _numerics import perturb_offset_convs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8


def _five_sigma(n_kept, n, q):
    return abs(n_kept - q * n) <= 5 * np.sqrt(n * q * (1 - q))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_share_and_scaling(p):
    n = 200_000
    keep = dropout.keep_mask((n,), p, seed=3, step=7, site=0)
    assert keep.dtype == torch.bool
    assert _five_sigma(int(keep.sum()), n, 1 - p)
    x = torch.randn(400, 500, dtype=torch.float64) + 3.0  # no zeros
    with dropout.stream(3, 7):
        y = dropout.dropout(x, p, training=True)
    kept = y != 0
    assert torch.equal(kept, dropout.keep_mask(x.shape, p, 3, 7, 0))
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert _five_sigma(int(kept.sum()), x.numel(), 1 - p)
    site = dropout.SeededDropout(p)
    assert site.eval()(x) is x
    assert dropout.SeededDropout(0.0).train()(x) is x
    assert torch.equal(dropout.dropout(x, 1.0, True), torch.zeros_like(x))


def test_masks_are_keyed_on_seed_step_and_site():
    p, n = 0.5, 100_000
    base = dropout.keep_mask((n,), p, seed=0, step=4, site=1)
    assert torch.equal(base, dropout.keep_mask((n,), p, seed=0, step=4, site=1))
    # the step as the packed state's 0-d int64 counter
    assert torch.equal(base, dropout.keep_mask((n,), p, 0, torch.tensor(4), 1))
    for other in (dict(seed=1, step=4, site=1), dict(seed=0, step=5, site=1),
                  dict(seed=0, step=4, site=2), dict(seed=0, step=2 ** 20 + 4, site=1)):
        m = dropout.keep_mask((n,), p, **other)
        agree = int((m == base).sum())
        # two independent masks agree in p^2 + (1-p)^2 of the elements
        assert _five_sigma(agree, n, p * p + (1 - p) * (1 - p)), other
    # a shape is read in row-major order: a mask of (4, n/4) is the flat one
    assert torch.equal(dropout.keep_mask((4, n // 4), p, 0, 4, 1).reshape(-1), base)


def test_training_forward_outside_a_stream_raises():
    model = create_ctrgcn_nucla(base_channel=BC, drop_out=0.5)
    x = torch.randn(2, 3, 8, 20, 1)
    with pytest.raises(RuntimeError, match="seeded stream"):
        model.train()(x)
    with dropout.stream(0, 0) as s:
        model(x)
    assert s.sites == 1
    with dropout.stream(0, 0, masks=[torch.ones(3, 256, dtype=torch.bool)]):
        with pytest.raises(ValueError, match="shape"):
            model(x)


def test_packed_step_advances_the_counter_only_with_dropout():
    x = torch.randn(4, 3, 8, 20, 1)
    y = torch.tensor([0, 1, 2, 3])
    masks = []
    model = create_ctrgcn_nucla(base_channel=BC, drop_out=0.5).train()
    model.dropout.register_forward_hook(lambda m, a, out: masks.append(out != 0))
    state = PackedTrainState(model, seed=11)
    assert state.draws and state.tensors()[-1] is state.step
    step = make_fused_train_step(state)
    for k in range(3):
        step(x, y)
        assert int(state.step) == k + 1
    # the hook sees the pooled features after dropout; none is 0 before it
    for k, m in enumerate(masks):
        assert torch.equal(m, dropout.keep_mask(m.shape, 0.5, 11, k, 0)), k
    assert not torch.equal(masks[0], masks[1])

    plain = create_ctrgcn_nucla(base_channel=BC).train()
    state = PackedTrainState(plain)
    assert not state.draws and not any(t is state.step for t in state.tensors())
    make_fused_train_step(state)(x, y)
    assert int(state.step) == 0


def _trainer(work_dir, *extra):
    arg = load_config([
        "-c", SMOKE, "--phase", "train", "--use_gpu", "false", "--work_dir", str(work_dir),
        "--model_args", f"base_channel={BC}", "drop_out=0.5", "--num_epoch", "2",
        "--batch_size", "8", "--train_feeder_args", "num_samples=16",
        "--test_feeder_args", "num_samples=8", "--num_worker", "1", "--print_log", "false",
        "--seed", "5", *extra])
    return RecognitionTrainer(arg)


def test_resumed_run_draws_the_unbroken_runs_masks(tmp_path):
    # with --debug_nans: its backups and finiteness flag change no number
    straight = _trainer(tmp_path / "straight", "--debug_nans", "true")
    losses = np.concatenate([straight.train_epoch(0), straight.train_epoch(1)])
    assert len(losses) == 4 and int(straight.state.step) == 4

    first = _trainer(tmp_path / "resumed")
    first.train_epoch(0)
    first._save_checkpoint("epoch1")
    again = _trainer(tmp_path / "resumed", "--resume", "true")
    assert again.resume() == 1
    assert int(again.state.step) == 2
    rest = again.train_epoch(1)
    np.testing.assert_array_equal(rest, losses[2:])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            again.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.state.optimizer.state["momentum_buffer"],
                    again.state.optimizer.state["momentum_buffer"]):
        assert torch.equal(a, b)
    # a resume that left the counter at 0 would draw steps 0-1's masks again
    wrong = _trainer(tmp_path / "resumed", "--resume", "true")
    wrong.resume()
    wrong.state.set_step(0)
    assert not np.array_equal(wrong.train_epoch(1), losses[2:])


# -- held against JAX with JAX's masks ---------------------------------------


def _jax_loss_and_masks(jm, params, stats, x, y, rng):
    """The train-mode loss with every nn.Dropout of the model intercepted:
    each is applied to ones (its mask, scaled), and its input is dropped
    with that mask as flax does; returns (loss, (new stats, masks))."""
    masks = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            scaled = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(scaled != 0)
            return jnp.where(scaled != 0, args[0] / (1 - context.module.rate), 0)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(intercept):
        out, mutated = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"], rngs={"dropout": rng})
    loss = optax.softmax_cross_entropy_with_integer_labels(out, y).mean()
    return loss, (mutated["batch_stats"], masks)


def _hold_against_jax(jm, variables, port, x, y, n_sites):
    """JAX's f64 loss, gradients, statistics and masks against the port's
    model `port` (f64, the same variables) run with those masks."""
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        value_and_grad = jax.jit(jax.value_and_grad(
            functools.partial(_jax_loss_and_masks, jm), has_aux=True))
        (loss, (stats, masks)), grads = value_and_grad(
            v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y),
            jax.random.PRNGKey(3))
        port.load_state_dict(from_flax(v, port))
        want = from_flax(jax.device_get({"params": grads, "batch_stats": stats}), port)
    masks = [torch.from_numpy(np.array(m)) for m in masks]
    assert len(masks) == n_sites
    assert all(0 < float(m.float().mean()) < 1 for m in masks)
    with dropout.stream(0, 0, masks=masks) as s:
        got = F.cross_entropy(port.train()(torch.from_numpy(x)), torch.from_numpy(y))
    assert s.sites == n_sites
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-9)
    top = max(float(want[n].abs().max()) for n, _ in port.named_parameters())
    bad = []
    for name, p in port.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w)
        if (err > 1e-9 * np.abs(w) + 1e-9 * top).any():
            bad.append(f"{name}: max err {err.max():.3e}, max|jax| {np.abs(w).max():.3e}")
    assert not bad, bad
    for name, b in port.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            w = want[name].numpy()
            np.testing.assert_allclose(b.numpy(), w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max() + 1e-12, err_msg=name)


def test_ctrgcn_drop_out_matches_jax_with_its_masks():
    rs = np.random.RandomState(8)
    x = rs.randn(4, 3, 16, 20, 1)
    y = rs.randint(0, 10, size=4)
    plain = jax_ctrgcn(use_pallas=False, base_channel=BC)
    init = jax.device_get(jax.jit(functools.partial(plain.init, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x[:2], jnp.float32)))
    # alpha and the offset convs off their zero init, so that M is not A; in
    # training the running statistics only receive the batch's
    variables = {"params": perturb_offset_convs(init["params"], scale=0.3),
                 "batch_stats": init["batch_stats"]}
    jm = jax_ctrgcn(use_pallas=False, base_channel=BC, drop_out=0.5)
    port = create_ctrgcn_nucla(base_channel=BC, drop_out=0.5).double()
    _hold_against_jax(jm, variables, port, x, y, n_sites=1)


def test_stgcn_dropout_and_block_dropout_match_jax_with_their_masks():
    rs = np.random.RandomState(9)
    x = rs.randn(4, 3, 16, 20, 1)
    y = rs.randint(0, 10, size=4)
    plain = jax_stgcn()
    variables = jax.device_get(plain.init(jax.random.PRNGKey(2),
                                          jnp.asarray(x[:2], jnp.float32), train=False))
    jm = jax_stgcn(dropout=0.5, block_dropout=0.2)
    port = create_stgcn_nucla(dropout=0.5, block_dropout=0.2).double()
    _hold_against_jax(jm, variables, port, x, y, n_sites=11)


def test_resnet_block_dropout_matches_jax_with_its_masks():
    rs = np.random.RandomState(10)
    x = rs.randn(4, 3, 32, 32)
    y = rs.randint(0, 10, size=4)
    kw = dict(block=jax_resnet.BasicBlock, layers=(1, 1, 1, 1), num_classes=10)
    variables = jax.device_get(jax_resnet.ResNet(**kw).init(
        jax.random.PRNGKey(3), jnp.asarray(x[:2], jnp.float32), train=False))
    jm = jax_resnet.ResNet(block_dropout=0.1, **kw)
    port = resnet.ResNet(block=resnet.BasicBlock, layers=(1, 1, 1, 1), num_classes=10,
                         block_dropout=0.1).double()
    _hold_against_jax(jm, variables, port, x, y, n_sites=8)
