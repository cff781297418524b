"""The port's fast eval (models/ctrgcn_infer.py, ops/gcn_tcn_block.py)
against the JAX package's, on the CPU.

A CTR-GCN at base_channel 8 with alpha, the TAM offset convs, the gcn1/bn
scales and the BatchNorm running stats moved off their init values (with
those the aggregation and the folding are invisible: alpha = 0, a zero
offset conv, a 1e-6 BN scale, mean 0 and var 1) is built on the port's side
and handed to the JAX package as Flax variables, the inverse of
`tamgcn_tpu_torch.convert.from_flax` (checked by a round trip); the tree's
structure comes from `jax.eval_shape` of the JAX init, which compiles
nothing. Inputs are made with numpy from a seed.
Tolerances, f32 on both sides: the folded weights within rtol 1e-6 and atol
1e-6 * max|JAX| (one product and one sum each, in another library); the
block and the logits within rtol 1e-4 and atol 1e-4 * max|JAX| (products of
up to 3*C terms summed in another order, through up to ten blocks). The JAX
engine is called with use_pallas=True (the whole-block Pallas kernel, in
interpret mode here) and use_pallas=False, never with its default, which
skips the kernel at V <= 20.
"""
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.models.ctrgcn_infer import _fold_block as jax_fold_block
from tamgcn_tpu.models.ctrgcn_infer import make_fast_eval as jax_make_fast_eval
from tamgcn_tpu.ops.pallas.gcn_tcn_block import gcn_tcn_block_fused as jax_block
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.data import SyntheticSkeletonFeeder
from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.models.ctrgcn_infer import (
    _fold_block, make_fast_eval, make_fast_eval_fn)
from tamgcn_tpu_torch.ops.cuda import ctr_gc
from tamgcn_tpu_torch.ops.cuda import gcn_tcn_block as k5
from tamgcn_tpu_torch.ops.gcn_tcn_block import gcn_tcn_block_fused, gcn_tcn_block_plain
from tamgcn_tpu_torch.ops.norm import BatchNorm
from tamgcn_tpu_torch.train.config import load_config
from tamgcn_tpu_torch.train.trainer import RecognitionTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()), err_msg=err_msg)


def _perturbed_model(seed=3):
    """The port's seeded init with alpha, the offset convs and the gcn1/bn
    scales perturbed, and running stats from one train-mode pass over a
    random batch (momentum 1), each then scaled by its own noise."""
    model = create_ctrgcn_nucla(base_channel=BC,
                                generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("gcn1.alpha"):
                t.copy_(0.3 * noise)
            elif "offset_conv.weight" in name:
                t.add_(0.3 * noise)
            elif name.endswith("gcn1.bn.weight"):
                t.copy_(1.0 + 0.1 * noise)
        for bn in bns:
            bn.momentum = 1.0
        model.train()(torch.randn((4, 3, 16, 20, 1), generator=g))
        for bn in bns:
            bn.momentum = 0.1
            bn.running_mean.mul_(1.0 + 0.1 * torch.randn(bn.num_features, generator=g))
            bn.running_var.mul_(1.0 + 0.25 * torch.randn(bn.num_features, generator=g).abs())
    return model.eval()


def _to_flax(model, shapes):
    """Flax variables shaped as `shapes` from the port's state dict: the
    inverse of convert.from_flax's layouts."""
    state = model.state_dict()
    leaf_names = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                  ("batch_stats", "mean"): "running_mean",
                  ("batch_stats", "var"): "running_var"}

    def leaf(path, shape):
        keys = [getattr(k, "key", k) for k in path]
        name = leaf_names.get((keys[0], keys[-1]), keys[-1])
        value = state[".".join(keys[1:-1] + [name])].numpy()
        if keys[-1] == "kernel":
            value = (value.T[None, None] if value.ndim == 2 and len(shape.shape) == 4
                     else value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T)
        assert value.shape == shape.shape, keys
        return np.ascontiguousarray(value, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, Flax variables, the port model they come from, x)."""
    jm = jax_create(use_pallas=False, base_channel=BC)
    x = np.random.RandomState(0).randn(2, 3, 16, 20, 1).astype(np.float32)
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, train=False),
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, x.dtype))
    model = _perturbed_model()
    variables = jax.tree_util.tree_map(np.asarray, dict(_to_flax(model, shapes)))
    for k, v in from_flax(variables, create_ctrgcn_nucla(base_channel=BC)).items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0, msg=k)
    return jm, variables, model, x


# (block, in_ch, out_ch, stride, block residual): a down conv from Cin=3 with
# no block residual, identity throughout, a down conv with a strided block
# residual
FOLD_BLOCKS = [("l1", 3, BC, 1, False), ("l2", BC, BC, 1, True),
               ("l5", BC, 2 * BC, 2, True)]


@pytest.mark.parametrize("block", FOLD_BLOCKS, ids=lambda b: b[0])
def test_fold_block_matches_jax(pair, block):
    _, variables, model, _ = pair
    name, cin, cout, stride, resid = block
    want = jax_fold_block(
        variables["params"][name], variables["batch_stats"][name], in_ch=cin,
        out_ch=cout, stride=stride, block_residual=resid, kernel_size=5,
        dilations=(1, 2))
    got = _fold_block(getattr(model, name))
    assert got["res"] == want["res"] and got["stride"] == stride
    assert (got["wd"] is None) == (want["wd"] is None) == (cin == cout)
    keys = [k for k, v in want.items()
            if k not in ("branches", "res", "stride", "S", "C") and v is not None]
    assert {"gy", "wo", "wp", "wpw", "mp_scale"} <= set(keys)
    for k in keys:
        _close(got[k].numpy(), want[k], 1e-6, err_msg=k)
    assert len(got["branches"]) == len(want["branches"]) == 2
    for (pad, dil, kern, bias), (ks, wdil, wkern, wbias) in zip(
            got["branches"], want["branches"]):
        assert dil == wdil and pad == (ks + (ks - 1) * (dil - 1) - 1) // 2
        # the port's (out, in, k, 1) against Flax's HWIO (k, 1, in, out)
        _close(kern.permute(2, 3, 1, 0).numpy(), wkern, 1e-6, err_msg="branch kernel")
        _close(bias.numpy(), wbias, 1e-6, err_msg="branch bias")


def _block_inputs(n, t, v, cin, c, r, identity, seed):
    """K5's inputs in numpy, with alpha != 0, b4 != 0, a random
    non-symmetric A and a BN affine gy far from (1, 0)."""
    rs = np.random.RandomState(seed)
    S, P, BCh = 3, 3 * c // 4, c // 4

    def w(*shape, fan):
        return (rs.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    args = dict(
        x=rs.randn(n, t, v, cin).astype(np.float32),
        x1s=rs.randn(n, S, v, r).astype(np.float32),
        x2s=rs.randn(n, S, v, r).astype(np.float32),
        w3=w(cin, S * c, fan=cin), b3=w(S * c, fan=4),
        w4s=w(S, r, c, fan=r), b4s=w(S, c, fan=4),
        alpha=np.asarray([0.7], np.float32),
        As=rs.rand(S, v, v).astype(np.float32),
        gy=np.stack([1.0 + 0.5 * rs.randn(c), 0.3 * rs.randn(c)]).astype(np.float32),
        wo=w(c, c, fan=c), bo=w(c, fan=4), wp=w(c, P, fan=c), bp=w(P, fan=4),
        wpw=w(c, BCh, fan=c), bpw=w(BCh, fan=4),
        wd=None if identity else w(cin, c, fan=cin),
        bd=None if identity else w(c, fan=4),
    )
    return args


BLOCK_CASES = {
    "identity": (2, 8, 20, 16, 16, 4, True),
    "down-cin3": (2, 8, 20, 3, 16, 8, False),
    "V25": (2, 6, 25, 32, 32, 4, True),
    "oddT-N3": (3, 7, 20, 24, 16, 3, False),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_plain_matches_jax_kernel(case):
    n, t, v, cin, c, r, identity = BLOCK_CASES[case]
    args = _block_inputs(n, t, v, cin, c, r, identity, seed=len(case))
    want = jax_block(**{k: None if a is None else jnp.asarray(a) for k, a in args.items()})
    got = gcn_tcn_block_plain(**{k: None if a is None else torch.from_numpy(a)
                                 for k, a in args.items()})
    for name, g, w in zip(("prefix", "pw"), got, want):
        assert g.shape == (n, t, v, w.shape[-1])
        _close(g.numpy(), w, 1e-4, err_msg=name)
    # the refinement and the offset branch are visible at these inputs
    args["alpha"] = np.zeros(1, np.float32)
    no_alpha = gcn_tcn_block_plain(**{k: None if a is None else torch.from_numpy(a)
                                      for k, a in args.items()})
    assert (no_alpha[0] - got[0]).abs().max() > 1e-2 * got[0].abs().max()


@pytest.fixture(scope="module")
def jax_logits(pair):
    jm, variables, _, x = pair
    return {p: np.asarray(jax_make_fast_eval(jm, variables, use_pallas=p)(jnp.asarray(x)))
            for p in (True, False)}


@pytest.mark.parametrize("use_kernel", [None, False], ids=["kernel", "folded"])
@pytest.mark.parametrize("layout", ["NCTVM", "NTVC"])
def test_fast_eval_matches_jax_and_the_unfused_model(pair, jax_logits, use_kernel, layout):
    _, _, model, x = pair
    xt = torch.from_numpy(x)
    if layout == "NTVC":  # the NW-UCLA feeder's (N, T, V*C)
        xt = torch.from_numpy(np.transpose(x[..., 0], (0, 2, 3, 1)).reshape(2, 16, 60))
    before = (ctr_gc.launches, k5.launches)
    with torch.no_grad():
        got = make_fast_eval(model, use_kernel=use_kernel)(xt).numpy()
        unfused = model(torch.from_numpy(x)).numpy()
    assert (ctr_gc.launches, k5.launches) == before  # the CPU launches no kernel
    assert got.shape == (2, 10)
    _close(got, jax_logits[True], 1e-4, err_msg="JAX use_pallas=True")
    _close(got, jax_logits[False], 1e-4, err_msg="JAX use_pallas=False")
    _close(got, unfused, 1e-4, err_msg="the port's unfused model")


def test_make_fast_eval_fn_takes_only_ctrgcn():
    with pytest.raises(TypeError, match="CTRGCN"):
        make_fast_eval_fn(torch.nn.Linear(2, 2))


def test_dispatcher_raises_on_other_devices():
    args = _block_inputs(1, 2, 20, 8, 8, 2, True, seed=0)
    meta = {k: None if a is None else torch.from_numpy(a).to("meta")
            for k, a in args.items()}
    with pytest.raises(NotImplementedError, match="meta"):
        gcn_tcn_block_fused(**meta)
    # a CPU tensor takes the plain version
    cpu = {k: None if a is None else torch.from_numpy(a) for k, a in args.items()}
    for a, b in zip(gcn_tcn_block_fused(**cpu), gcn_tcn_block_plain(**cpu)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_test_phase_with_fast_eval_scores_as_without(pair, tmp_path):
    """--phase test --fast_eval true --use_gpu false scores every sample as
    the run without the flag does."""
    _, _, model, _ = pair
    weights = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), weights)
    scores = {}
    for flag in ("false", "true"):
        work = tmp_path / flag
        assert main([
            "recognition", "-c", SMOKE, "--phase", "test", "--use_gpu", "false",
            "--weights", weights, "--work_dir", str(work), "--save_result", "true",
            "--model_args", f"base_channel={BC}", "--test_feeder_args",
            "num_samples=12", "--test_batch_size", "8", "--num_worker", "1",
            "--fast_eval", flag]) == 0
        with open(work / "test_result.pkl", "rb") as f:
            scores[flag] = pickle.load(f)
    assert list(scores["true"]) == list(scores["false"]) and len(scores["true"]) == 12
    want = np.stack(list(scores["false"].values()))
    _close(np.stack(list(scores["true"].values())), want, 1e-4)


def test_train_phase_fast_eval_sees_the_trained_weights(tmp_path):
    """One epoch of --phase train --fast_eval true: its evaluation scores the
    weights after the epoch (the unfused model on them), not a fold of the
    weights the run started from."""
    arg = load_config([
        "recognition", "-c", SMOKE, "--use_gpu", "false", "--fast_eval", "true",
        "--model_args", f"base_channel={BC}", "--work_dir", str(tmp_path),
        "--num_epoch", "1", "--train_feeder_args", "num_samples=16",
        "--test_feeder_args", "num_samples=8", "--batch_size", "8",
        "--test_batch_size", "8", "--num_worker", "1"][1:])
    trainer = RecognitionTrainer(arg)
    start = copy.deepcopy(trainer.model)
    trainer.start()
    feeder = SyntheticSkeletonFeeder(num_samples=8, split="val", seed=arg.seed)
    x = torch.from_numpy(np.stack([feeder[i][0] for i in range(8)]))
    with torch.no_grad():
        trained = trainer.model.eval()(x).numpy()
        stale = make_fast_eval(start.eval())(x).numpy()
    _close(trainer.result_scores, trained, 1e-4)
    assert np.abs(stale - trained).max() > 1e-2 * np.abs(trained).max()
