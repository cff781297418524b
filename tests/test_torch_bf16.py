"""The port's bf16 mixed precision (`model_args.dtype: bfloat16`,
configs/nucla/gcn_bf16.yaml) against the JAX package's, on the CPU.

bf16 here is the JAX package's policy: parameters, BatchNorm statistics,
logits and loss in f32; activations and conv/matmul operands in bf16. The
unit op in bf16 follows the JAX kernels' bf16 bodies, which the JAX package
runs on the TPU and, in interpret mode, on the CPU; its XLA reference
`unit_ctr_gc_xla` rounds elsewhere (tanh in bf16, an f32 output), so the op
and the model are held to the Pallas bodies in interpret mode.

Inputs and weights come from numpy seeds (the model's are the perturbed,
calibrated variables of tests/test_torch_model.py, base_channel 8, T=16,
V=20). Tolerances:
  * the unit op (forward, x3 gradient, parameter gradients) against
    `unit_ctr_gc_fwd_pallas` / `unit_ctr_gc_bwd_pallas` on bf16 inputs: bf16
    outputs within 2^-7 of their max |value| and equal to JAX's in all but
    1% of their elements (one rounding of f32 sums taken in another order
    flips a value only at a near-tie; M's product on unrounded operands
    changes more than that, test_unit_op_bf16_rounds_stage_one_operands),
    f32 outputs within rtol
    1e-4 and atol 1e-4 * max (dalpha, one sum of every term, rtol 1e-3);
    each in the JAX dtype;
  * BatchNorm in bf16, train and eval mode, against tamgcn_tpu/ops/norm.py
    with dtype=bfloat16: the output as the bf16 outputs above, the running
    stats within rtol 1e-5; the same input through one `F.batch_norm`
    (normalised in f32, rounded once) must miss that bound;
  * the model's logits against the JAX bf16 model (use_pallas=True): within
    2^-5 of max |logit| of the JAX f32 model, and the port's distance from
    JAX bf16 at most half of JAX bf16's distance from JAX f32, which shows
    that the port rounds where JAX rounds rather than merely landing near
    f32;
  * one train-mode step (batch 4, T=8) against jax.value_and_grad of the
    JAX bf16 model (use_pallas=True, jitted once, at one input shape,
    without XLA's excess precision, so that it rounds as the op-by-op model
    does). In bf16 the gradients of this ten-block train-mode model carry
    rounding noise of the order of their max |value| (JAX bf16 against JAX
    f32), so each tensor is held to the size of that noise: every gradient
    and running stat within 4x max |JAX bf16 - JAX f32| of JAX bf16, plus
    1e-4 of the largest f32 gradient (or 1e-6 of the buffer's max |value|);
    the alphas' gradients (each one sum over every term, ill-conditioned
    already in f32, where the JAX bf16 and f32 values of one alpha can lie
    far apart or happen to agree) as one vector, within half its distance
    |JAX bf16 - JAX f32|; the loss within 2^-5 of itself (one bf16 rounding
    of a logit moves it by up to ~1e-2). And the port must share JAX's
    rounding: its distance from JAX bf16 at most half of JAX bf16's from JAX
    f32, over the other gradients pooled (each tensor scaled by its f32 max
    |value|; leaving out the biases that feed a train-mode BatchNorm, whose
    f32 gradients are rounding noise below 1e-4 of the largest) in L2, and as
    the median over the running stats of the same ratio per buffer;
  * the fast eval of a bf16 model follows JAX's default `auto` policy: at
    V=20 the bf16 model's own forward, bitwise, held to JAX's default
    `make_fast_eval_fn(model)` as the logits are; past V=20 the f32 engine,
    bitwise the fast eval of the same weights in an f32 model. The engine
    itself (use_kernel=False) is f32 from the f32 parameters: within rtol
    1e-4 and atol 1e-4 * max of JAX's `make_fast_eval_fn(model,
    use_pallas=False)`, and bitwise the f32 model's.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tamgcn_tpu.models import create_ctrgcn_nucla as jax_create
from tamgcn_tpu.models.ctrgcn_infer import make_fast_eval_fn as jax_make_fast_eval_fn
from tamgcn_tpu.ops.norm import BatchNorm as JaxBatchNorm
from tamgcn_tpu.ops.pallas.ctr_gc import unit_ctr_gc_bwd_pallas, unit_ctr_gc_fwd_pallas
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.convert import from_flax
from tamgcn_tpu_torch.models import CTRGC, create_ctrgcn_nucla, get_model
from tamgcn_tpu_torch.models.ctrgcn_infer import make_fast_eval
from tamgcn_tpu_torch.ops import aggregation as port
from tamgcn_tpu_torch.ops.cuda import ctr_gc
from tamgcn_tpu_torch.ops.norm import BatchNorm
from tamgcn_tpu_torch.tools import bf16_convergence
from tamgcn_tpu_torch.train.config import load_config
from test_torch_model import perturbed_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
BC = 8
BF16_TOL = 2.0 ** -7
BF16_SHARE = 0.01
LOGIT_TOL = 2.0 ** -5
HALF = 0.5


def _bf16_gap(got, want):
    """(max |got - want| / max |want|, the share of elements that differ)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max(), float((got != want).mean())


def _bf16_close(got, want, what):
    """A bf16 result within 2^-7 of the reference's max |value|, and equal to
    it in all but BF16_SHARE of its elements."""
    assert np.isfinite(np.asarray(got, np.float32)).all(), what
    rel, share = _bf16_gap(got, want)
    assert rel <= BF16_TOL and share <= BF16_SHARE, (what, rel, share)


def _f32(t):
    """A torch tensor or a JAX array as an f32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---- the unit op --------------------------------------------------------------

OP_SHAPES = [dict(n=2, t=9, v=20, c=128, r=16),  # S*C = 384: the tile form
             dict(n=2, t=16, v=20, c=16, r=8)]   # narrow: the broadcast form


def _unit_inputs(n, t, v, c, r, s=3, seed=0):
    """(x1s, x2s, x3s, g) as bf16-valued f32 arrays and (w4s, b4s, alpha, As)
    in f32, with alpha != 0, b4 != 0 and a random A."""
    rs = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    acts = (bf16(rs.randn(n, s, v, r)), bf16(rs.randn(n, s, v, r)),
            bf16(rs.randn(n, t, v, s * c)), bf16(rs.randn(n, t, v, c)))
    params = ((rs.randn(s, r, c) * 0.1).astype(np.float32),
              (rs.randn(s, c) * 0.1).astype(np.float32),
              np.asarray([0.7], np.float32), rs.rand(s, v, v).astype(np.float32))
    return acts, params


def _jax_args(acts, params):
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in acts],
            [jnp.asarray(p) for p in params])


def _torch_args(acts, params, grad=False):
    return ([torch.from_numpy(a).bfloat16().requires_grad_(grad) for a in acts],
            [torch.from_numpy(p).requires_grad_(grad) for p in params])


@pytest.mark.parametrize("shape", OP_SHAPES, ids=["tile", "bcast"])
def test_unit_op_bf16_matches_pallas_interpret(shape):
    acts, params = _unit_inputs(**shape)
    (jx1, jx2, jx3, _), jp = _jax_args(acts, params)
    want = unit_ctr_gc_fwd_pallas(jx1, jx2, jx3, *jp)
    (x1s, x2s, x3s, _), tp = _torch_args(acts, params)
    with torch.no_grad():
        got = port.unit_ctr_gc(x1s, x2s, x3s, *tp)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _bf16_close(_f32(got), _f32(want), "out")
    assert ctr_gc.launches == ctr_gc.launches_bf16 == 0


@pytest.mark.parametrize("shape", OP_SHAPES, ids=["tile", "bcast"])
def test_unit_op_bf16_gradients_match_pallas_interpret(shape):
    """UnitCtrGc's backward (the plain K2 and K3 on the CPU) returns every
    gradient in its primal's dtype: bf16 for x1s, x2s and x3s, f32 for w4s,
    b4s, alpha and As, as unit_ctr_gc_bwd_pallas does."""
    acts, params = _unit_inputs(**shape, seed=1)
    (jx1, jx2, jx3, jg), (jw4, jb4, ja, jA) = _jax_args(acts, params)
    want = dict(zip(("x1s", "x2s", "x3s", "w4s", "b4s", "alpha", "As"),
                    unit_ctr_gc_bwd_pallas(jx1, jx2, jg, jx3, jw4, jb4, ja, jA)))
    (x1s, x2s, x3s, g), tp = _torch_args(acts, params, grad=True)
    port.unit_ctr_gc(x1s, x2s, x3s, *tp).backward(g.detach())
    got = dict(zip(("x1s", "x2s", "x3s", "w4s", "b4s", "alpha", "As"),
                   (t.grad for t in (x1s, x2s, x3s, *tp))))
    for name in ("x1s", "x2s", "x3s"):
        assert got[name].dtype == torch.bfloat16 and want[name].dtype == jnp.bfloat16, name
        _bf16_close(_f32(got[name]), _f32(want[name]), f"d{name}")
    for name in ("w4s", "b4s", "alpha", "As"):
        assert got[name].dtype == torch.float32 and want[name].dtype == jnp.float32, name
        w = _f32(want[name])
        rtol, atol = (1e-3, 0.0) if name == "alpha" else (1e-4, 1e-4 * np.abs(w).max())
        np.testing.assert_allclose(_f32(got[name]), w, rtol=rtol, atol=atol,
                                   err_msg=f"d{name}")


def test_unit_op_bf16_rounds_stage_one_operands():
    """The bf16 plain version rounds D and w4 before M's product: with them
    left in f32 (and the output rounded once) more than BF16_SHARE of the
    outputs change, so the checks above see where the rounding happens."""
    acts, params = _unit_inputs(n=2, t=9, v=20, c=128, r=16)
    (x1s, x2s, x3s, _), (w4s, b4s, alpha, As) = _torch_args(acts, params)
    with torch.no_grad():
        got = port.unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As)
        f32 = port.unit_ctr_gc_plain(x1s.float(), x2s.float(), x3s.float(), w4s, b4s,
                                     alpha, As)
    assert _bf16_gap(_f32(f32.bfloat16()), _f32(got))[1] > BF16_SHARE


# ---- BatchNorm ---------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_bf16_matches_jax(train):
    """Channels whose |mean| is far above their spread, where the JAX order
    (mean rounded to bf16 before the subtraction) differs from one rounding
    of the f32 normalisation."""
    rs = np.random.RandomState(5)
    C = 12
    x = (rs.randn(4, 3, 5, C) * (0.5 + rs.rand(C)) + 8.0 * rs.randn(C)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16()
    params = {"scale": (rs.rand(C) + 0.5).astype(np.float32),
              "bias": rs.randn(C).astype(np.float32)}
    stats = {"mean": (8.0 * rs.randn(C)).astype(np.float32),
             "var": (rs.rand(C) + 0.5).astype(np.float32)}
    jbn = JaxBatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)
    want, mutated = jbn.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(_f32(x)).astype(jnp.bfloat16),
                              use_running_average=not train, mutable=["batch_stats"])
    bn = BatchNorm(C, dtype=torch.bfloat16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        ref = F.batch_norm(x.reshape(-1, C), bn.running_mean.clone(), bn.running_var.clone(),
                           bn.weight, bn.bias, training=train, eps=1e-5).reshape(x.shape)
        got = bn.train(train)(x)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _bf16_close(_f32(got), _f32(want), "y")
    rel, share = _bf16_gap(_f32(ref), _f32(want))
    assert rel > BF16_TOL or share > BF16_SHARE, (rel, share)
    for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(mutated["batch_stats"][name]),
                                   rtol=1e-5, err_msg=name)


# ---- the model ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def variables():
    """(JAX f32 model, perturbed calibrated f32 variables, input)."""
    jm32 = jax_create(use_pallas=False, base_channel=BC)
    x = np.random.RandomState(0).randn(2, 3, 16, 20, 1).astype(np.float32)
    init = jax.device_get(jax.jit(functools.partial(jm32.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    return jm32, perturbed_variables(jm32, init), x


def _port_model(variables, dtype="bfloat16"):
    model = create_ctrgcn_nucla(base_channel=BC, dtype=dtype)
    model.load_state_dict(from_flax(variables, model))
    return model


def test_bf16_model_has_f32_parameters_and_logits(variables):
    _, v, x = variables
    model = _port_model(v).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        feat, _ = model.extract_feature(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
    assert feat.dtype == torch.bfloat16
    # the logits are widened bf16 values
    assert torch.equal(out, out.bfloat16().float())


def test_bf16_logits_match_jax_pallas(variables):
    jm32, v, x = variables
    want32 = _f32(jax.jit(functools.partial(jm32.apply, train=False))(v, jnp.asarray(x)))
    # bf16 op by op, as each operation rounds (see _jax_step)
    jm = jax_create(use_pallas=True, base_channel=BC, dtype=jnp.bfloat16)
    want = _f32(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _f32(_port_model(v).eval()(torch.from_numpy(x)))
    scale = np.abs(want32).max()
    port_gap, jax_gap = np.abs(got - want).max(), np.abs(want - want32).max()
    assert port_gap <= LOGIT_TOL * scale, (port_gap, scale)
    assert port_gap <= HALF * jax_gap, (port_gap, jax_gap)


def _jax_loss(jm, params, stats, x, y):
    out, mutated = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
    return optax.softmax_cross_entropy_with_integer_labels(out, y).mean(), mutated["batch_stats"]


def _jax_step(jm, v, x, y):
    """(loss, {name: gradient or running stat} in the port's names), from
    jax.value_and_grad jitted once at this shape without XLA's excess
    precision (so that bf16 values are rounded after every operation, as
    the op-by-op model rounds them)."""
    args = (v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    step = jax.jit(jax.value_and_grad(functools.partial(_jax_loss, jm), has_aux=True))
    step = step.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
    (loss, stats), grads = step(*args)
    tree = jax.device_get({"params": grads, "batch_stats": stats})
    return float(loss), from_flax(tree, create_ctrgcn_nucla(base_channel=BC))


def _noise_close(got, want, want32, floor, what):
    """Each tensor within 4x max |want - want32| of want, plus `floor`."""
    for n in got:
        err = np.abs(got[n] - want[n]).max()
        limit = 4 * np.abs(want[n] - want32[n]).max() + floor(n)
        assert err <= limit, (what, n, err, limit)


def test_bf16_train_step_matches_jax_pallas(variables):
    jm32, v, _ = variables
    rs = np.random.RandomState(11)
    x = rs.randn(4, 3, 8, 20, 1).astype(np.float32)
    y = rs.randint(0, 10, size=4)
    loss32, ref32 = _jax_step(jm32, v, x, y)
    loss_bf, ref = _jax_step(jax_create(use_pallas=True, base_channel=BC,
                                        dtype=jnp.bfloat16), v, x, y)
    model = _port_model(v).train()
    loss = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - loss_bf) <= LOGIT_TOL * abs(loss_bf), (loss.item(), loss_bf)

    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    want = {n: ref[n].numpy() for n in grads}
    want32 = {n: ref32[n].numpy() for n in grads}
    top = max(np.abs(w).max() for w in want32.values())
    alphas = [n for n in grads if n.endswith("gcn1.alpha")]
    others = {n: g for n, g in grads.items() if n not in alphas}
    _noise_close(others, want, want32, lambda n: 1e-4 * top, "gradient")
    a, a_want, a_want32 = (np.concatenate([d[n] for n in alphas])
                           for d in (grads, want, want32))
    assert np.linalg.norm(a - a_want) <= HALF * np.linalg.norm(a_want - a_want32), (
        a, a_want, a_want32)
    signal = [n for n in others if np.abs(want32[n]).max() >= 1e-4 * top]

    def pooled(a):
        return np.concatenate([a[n].ravel() / np.abs(want32[n]).max() for n in signal])

    port_gap = np.linalg.norm(pooled(grads) - pooled(want))
    jax_gap = np.linalg.norm(pooled(want) - pooled(want32))
    assert port_gap <= HALF * jax_gap, (port_gap, jax_gap)

    stats = {n: b.numpy() for n, b in model.named_buffers()}
    want = {n: ref[n].numpy() for n in stats}
    want32 = {n: ref32[n].numpy() for n in stats}
    _noise_close(stats, want, want32, lambda n: 1e-6 * np.abs(want32[n]).max(), "stat")
    ratios = [np.linalg.norm(stats[n] - want[n])
              / max(np.linalg.norm(want[n] - want32[n]), 1e-30) for n in stats]
    assert np.median(ratios) <= HALF, sorted(ratios)


def test_bf16_fast_eval_is_the_f32_engine(variables):
    """The folded engine (asked for with use_kernel=False, as JAX's with
    use_pallas=False) computes in f32 from the f32 parameters of a bf16
    model."""
    _, v, x = variables
    jm = jax_create(use_pallas=False, base_channel=BC, dtype=jnp.bfloat16)
    want = _f32(jax_make_fast_eval_fn(jm, use_pallas=False)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = make_fast_eval(_port_model(v).eval(), use_kernel=False)(torch.from_numpy(x))
        f32 = make_fast_eval(_port_model(v, dtype=None).eval(),
                             use_kernel=False)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    assert torch.equal(got, f32)


def test_bf16_fast_eval_follows_the_jax_auto_policy(variables, monkeypatch):
    """The default fast eval of a bf16 model is what JAX's default
    `make_fast_eval_fn(model)` computes: at V=20 (its `auto` policy returns
    the model's own eval forward) the bf16 forward, held to JAX's as the
    logits are (test_bf16_logits_match_jax_pallas; jitted without XLA's
    excess precision, see _jax_step); past V=20 the f32 engine."""
    jm32, v, x = variables
    monkeypatch.delenv("TAMGCN_FAST_EVAL_BLOCKS", raising=False)
    want32 = _f32(jax.jit(functools.partial(jm32.apply, train=False))(v, jnp.asarray(x)))
    jm = jax_create(use_pallas=True, base_channel=BC, dtype=jnp.bfloat16)
    args = (v, jnp.asarray(x))
    fast = jax_make_fast_eval_fn(jm).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = _f32(fast(*args))
    model = _port_model(v)
    with torch.no_grad():
        got = make_fast_eval(model)(torch.from_numpy(x))
        assert torch.equal(got, model.eval()(torch.from_numpy(x)))
    got = _f32(got)
    port_gap, jax_gap = np.abs(got - want).max(), np.abs(want - want32).max()
    assert port_gap <= LOGIT_TOL * np.abs(want32).max(), port_gap
    assert port_gap <= HALF * jax_gap, (port_gap, jax_gap)

    def wide(dtype):
        return create_ctrgcn_nucla(base_channel=BC, num_point=25, graph="synthetic",
                                   graph_args={"labeling_mode": "spatial", "num_node": 25},
                                   dtype=dtype).eval()

    x25 = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 8, 25, 1).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(make_fast_eval(wide("bfloat16"))(x25), make_fast_eval(wide(None))(x25))


# ---- what the slice refuses ---------------------------------------------------------


def test_bf16_refusals(monkeypatch):
    """What bf16 takes and what it refuses: TAMGCN_FUSE_CONV3=1 with bf16
    activations takes K6's bf16 form (on the CPU its plain version), whose
    forward is the unfused one bit for bit; the standalone CTRGC takes bf16
    (K4's bf16 form, an f32 output). Refused: float16 and other model
    dtypes, mixed or float16 activations of the unit op's kernels. (K6-bf16
    and K4-bf16 are held to JAX in tests/test_torch_bf16_forms.py.)"""
    rs = np.random.RandomState(3)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)

    x, w3, b3 = t(1, 4, 20, 64), t(64, 3 * 128), t(3 * 128)
    x1s, x2s = t(1, 3, 20, 8), t(1, 3, 20, 8)
    params = (t(3, 8, 128, dtype=torch.float32), t(3, 128, dtype=torch.float32),
              t(1, dtype=torch.float32), t(3, 20, 20, dtype=torch.float32))
    monkeypatch.setenv("TAMGCN_FUSE_CONV3", "1")
    leaves = [a.clone().requires_grad_() for a in (x, w3, b3)]
    fused = port.unit_ctr_gc_conv3(*leaves, x1s, x2s, *params)
    fused.float().sum().backward()
    assert fused.dtype == torch.bfloat16 and fused.grad_fn.name() == "UnitCtrGcConv3Backward"
    assert all(a.grad.dtype == torch.bfloat16 and torch.isfinite(a.grad.float()).all()
               for a in leaves)
    monkeypatch.setenv("TAMGCN_FUSE_CONV3", "0")
    unfused = port.unit_ctr_gc_conv3(x, w3, b3, x1s, x2s, *params)
    assert unfused.dtype == torch.bfloat16 and torch.equal(unfused, fused.detach())
    for dtype in ("float16", "float64"):
        with pytest.raises(NotImplementedError, match="float32 or in bfloat16"):
            get_model("ctrgcn", dtype=dtype, graph="ucla")
    module = CTRGC(16, 32, dtype="bfloat16")
    assert {p.dtype for p in module.parameters()} == {torch.float32}
    out = module(t(1, 4, 20, 16, dtype=torch.float32), torch.rand(20, 20), torch.ones(1))
    assert out.dtype == torch.float32 and out.shape == (1, 4, 20, 32)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        CTRGC(16, 32, dtype="float16")
    named = (("x1s", x1s, None), ("x2s", x2s.half(), None))
    with pytest.raises(TypeError, match="one dtype"):
        ctr_gc._activation_dtype("unit_ctr_gc_fwd", named, ("x1s", "x2s"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ctr_gc._activation_dtype("unit_ctr_gc_fwd", named[1:], ("x2s",))
    assert ctr_gc._activation_dtype("unit_ctr_gc_fwd", named[:1], ("x1s",)) == torch.bfloat16


# ---- the entry point and the convergence tool ---------------------------------------


def _cli(work_dir, *extra, phase="train"):
    return main(["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir",
                 str(work_dir), "--phase", phase, "--print_log", "false",
                 "--num_epoch", "1", "--train_feeder_args", "num_samples=32",
                 "--test_feeder_args", "num_samples=16", *extra])


def test_cli_bf16_checkpoints_hold_f32_and_load_across_dtypes(tmp_path):
    """A bf16 run's checkpoints hold the same f32 tensors as an f32 run's, so
    --weights takes either in either dtype."""
    ckpts = {}
    for dtype in ("float32", "bfloat16"):
        assert _cli(tmp_path / dtype, "--model_args", "base_channel=8", f"dtype={dtype}") == 0
        tree = torch.load(tmp_path / dtype / "checkpoints" / "epoch1.pt", weights_only=True)
        ckpts[dtype] = {k: (v.dtype, tuple(v.shape)) for k, v in tree["model"].items()}
    assert ckpts["bfloat16"] == ckpts["float32"]
    assert {d for d, _ in ckpts["bfloat16"].values()} <= {torch.float32, torch.int64}
    for dtype, other in (("float32", "bfloat16"), ("bfloat16", "float32")):
        weights = tmp_path / other / "checkpoints" / "epoch1.pt"
        assert _cli(tmp_path / f"test_{dtype}", "--weights", str(weights), "--model_args",
                    "base_channel=8", f"dtype={dtype}", phase="test") == 0


def test_gcn_bf16_config_builds_a_bf16_model_and_reaches_the_feeder(tmp_path):
    arg = load_config(["-c", os.path.join(REPO, "configs", "nucla", "gcn_bf16.yaml")])
    model = get_model(arg.model, **dict(arg.model_args, base_channel=BC))
    assert model.dtype == torch.bfloat16
    errors = {}
    for name in ("gcn", "gcn_bf16"):
        with pytest.raises(FileNotFoundError) as e:
            main(["recognition", "-c", os.path.join(REPO, "configs", "nucla", f"{name}.yaml"),
                  "--use_gpu", "false", "--print_log", "false",
                  "--work_dir", str(tmp_path / name)])
        errors[name] = str(e.value)
    assert errors["gcn_bf16"] == errors["gcn"]


def test_convergence_tool_on_the_cpu(capsys):
    rc = bf16_convergence.main(["--device", "cpu", "--epochs", "1", "--samples", "32",
                                "--batch", "16", "--base_channel", "8"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if record["within_tol"] else 1)
    for run in ("f32", "bf16"):
        assert len(record[run]["train_loss"]) == 1
        assert np.isfinite(record[run]["train_loss"]).all()
        assert not any(record[run]["launches"].values())  # the CPU runs the plain versions
    assert record["best_top1_delta"] == abs(record["f32"]["best_top1"]
                                            - record["bf16"]["best_top1"])
