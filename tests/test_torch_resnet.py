"""The port's ResNet family (models/resnet.py, resnet_only.py) and its
importers against the JAX package on the CPU.

From JAX-initialised variables (BatchNorm scales and biases perturbed, the
running statistics those of a calibration batch of 16) through
convert.from_flax, at 32 x 32:
  * eval logits of ResNet with BasicBlock and with Bottleneck at
    layers=(1,1,1,1) and of resnet50, on a batch that is not the
    calibration batch, within 1e-4 * max |logit|;
  * train-mode logits and BatchNorm statistics: the small ResNets in f32
    within 1e-4 * max, resnet50 in f64 within 1e-9 (in f32 the JAX model
    alone moves its train-mode resnet50 logits by ~2e-3 of their max from
    its own f64 values: four samples per channel at layer4);
  * f64 gradients of the small ResNets within 1e-9 relative;
  * bf16 logits of the small ResNets within 2^-5 * max of JAX's eager bf16
    (resnet50 at this random init is ill-conditioned in bf16: JAX's own
    bf16 logits lie 0.62 * max from its f32 ones, and the two packages' bf16
    logits 0.21 * max apart, so there a bf16 comparison would test rounding
    order, not the port);
  * the importers (torchvision names, conv1 inflated 3 -> 15, the fusion
    state dict, `load_torch_resnet_npz`) element for element against JAX's;
  * `block_dropout > 0` is the identity in eval and draws from the seeded
    dropout stream in training (tests/test_torch_dropout.py holds it to
    JAX's masks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _weight_forms import reference_fusion_state, reference_resnet_state
from tamgcn_tpu.models import resnet as jax_resnet
from tamgcn_tpu.utils import torch_import as jax_import
from tamgcn_tpu_torch.convert import flax_param_paths, from_flax
from tamgcn_tpu_torch.models import get_model, resnet
from tamgcn_tpu_torch.models.resnet_only import ResNetOnly
from tamgcn_tpu_torch.ops import dropout
from tamgcn_tpu_torch.utils import torch_import

torch.set_num_threads(2)
S = 32  # image size
ARCHS = {
    "basic": (lambda **kw: jax_resnet.ResNet(block=jax_resnet.BasicBlock,
                                             layers=(1, 1, 1, 1), **kw),
              lambda **kw: resnet.ResNet(block=resnet.BasicBlock, layers=(1, 1, 1, 1), **kw)),
    "bottleneck": (lambda **kw: jax_resnet.ResNet(block=jax_resnet.Bottleneck,
                                                  layers=(1, 1, 1, 1), **kw),
                   lambda **kw: resnet.ResNet(block=resnet.Bottleneck, layers=(1, 1, 1, 1),
                                              **kw)),
    "resnet50": (jax_resnet.resnet50, resnet.resnet50),
}


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), np.asarray(v)) for k, v in tree.items()}


def calibrated(jm, seed=0, image=S, channels=3):
    """JAX-initialised variables with the BatchNorm scales and biases
    perturbed and the running statistics of a calibration batch of 16 (a
    train-mode pass from zeroed statistics leaves 0.1 x the batch's);
    returns (variables, calibration batch)."""
    rs = np.random.RandomState(seed)
    x_cal = rs.randn(16, channels, image, image).astype(np.float32)
    init = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x_cal[:2]),
                                  train=False))
    params = _map(init["params"], lambda p, v: (v + 0.1 * rs.randn(*v.shape)).astype(
        np.float32) if p[-1] in ("scale", "bias") and "bn" in p[-2] else v)
    zero = _map(init["batch_stats"], lambda p, v: np.zeros_like(v))
    _, new = jm.apply({"params": params, "batch_stats": zero}, jnp.asarray(x_cal),
                      train=True, mutable=["batch_stats"])
    stats = _map(jax.device_get(new["batch_stats"]), lambda p, v: 10.0 * v)
    return {"params": params, "batch_stats": stats}, x_cal


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    make_jax, make_port = ARCHS[arch]
    jm = make_jax(num_classes=10)
    variables, x_cal = calibrated(jm)
    model = make_port(num_classes=10)
    model.load_state_dict(from_flax(variables, model))
    return jm, variables, model, x_cal


def _stats(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_eval_and_train_mode_match_jax(arch):
    jm, variables, model, x_cal = _pair(arch)
    x = np.random.RandomState(9).randn(4, 3, S, S).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (4, 10) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4, "eval logits")
    # NHWC input takes the same path
    with torch.no_grad():
        _close(model(torch.from_numpy(x.transpose(0, 2, 3, 1).copy())).numpy(), want, 1e-4)

    f64 = arch == "resnet50"
    dt = np.float64 if f64 else np.float32
    rtol = 1e-9 if f64 else 1e-4
    port = ARCHS[arch][1](num_classes=10).to(torch.float64 if f64 else torch.float32)
    with jax.enable_x64(f64):
        v = _map(variables, lambda p, a: a.astype(dt))
        want, new = jm.apply(v, jnp.asarray(x_cal.astype(dt)), train=True,
                             mutable=["batch_stats"])
        want_stats = _stats(from_flax({"params": v["params"], **jax.device_get(new)}, port))
    port.load_state_dict(from_flax(v, port))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x_cal.astype(dt)))
    _close(got.numpy(), want, rtol, "train-mode logits")
    for k, b in _stats(port.state_dict()).items():
        _close(b.numpy(), want_stats[k].numpy(), rtol, k)


def _jax_loss(jm, params, stats, x, y):
    out, mutated = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])
    return optax.softmax_cross_entropy_with_integer_labels(out, y).mean(), mutated


@pytest.mark.parametrize("arch", ["basic", "bottleneck"])
def test_f64_gradients_match_jax(arch):
    jm, variables, _, x_cal = _pair(arch)
    y = np.random.RandomState(3).randint(0, 10, size=8)
    x = x_cal[:8].astype(np.float64)
    with jax.enable_x64(True):
        v = _map(variables, lambda p, a: a.astype(np.float64))
        (loss, _), grads = jax.value_and_grad(functools.partial(_jax_loss, jm), has_aux=True)(
            v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(y))
        model = ARCHS[arch][1](num_classes=10).double()
        model.load_state_dict(from_flax(v, model))
        want = from_flax({"params": jax.device_get(grads), "batch_stats": v["batch_stats"]},
                         model)
    got = F.cross_entropy(model.train()(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-12)
    top = max(float(want[n].abs().max()) for n, _ in model.named_parameters())
    bad = []
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w)
        if (err > 1e-9 * np.abs(w) + 1e-9 * top).any():
            bad.append(f"{name}: max err {err.max():.3e}, max|jax| {np.abs(w).max():.3e}")
    assert not bad, bad


@pytest.mark.parametrize("arch", ["basic", "bottleneck"])
def test_bf16_logits_within_2_to_the_minus_5(arch):
    jm_f32, variables, _, _ = _pair(arch)
    jm = ARCHS[arch][0](num_classes=10, dtype=jnp.bfloat16)
    model = ARCHS[arch][1](num_classes=10, dtype="bfloat16")
    model.load_state_dict(from_flax(variables, model))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = np.random.RandomState(4).randn(4, 3, S, S).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    gap = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert gap <= 2.0 ** -5, gap


def _equal_trees(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _equal_trees(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == np.asarray(want[k]).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("case", ["resnet50", "resnet50-inflated-15", "resnet18", "skip-fc"])
def test_resnet_importer_equals_jax(case):
    layers, bottleneck, arch = {"resnet18": ((2, 2, 2, 2), False, "resnet18")}.get(
        case, ((3, 4, 6, 3), True, "resnet50"))
    sd = reference_resnet_state(5, layers=layers, bottleneck=bottleneck)
    kw = dict(arch=arch, bottleneck=bottleneck, skip_fc=case == "skip-fc",
              in_channels_rgb=15 if case.endswith("15") else 3)
    got = torch_import.import_resnet_state_dict(sd, **kw)
    _equal_trees(got, jax_import.import_resnet_state_dict(sd, **kw))
    if case.endswith("15"):
        w = got["params"]["conv1"]["kernel"]
        assert w.shape == (7, 7, 15, 64)
        np.testing.assert_array_equal(w[:, :, 3:6], w[:, :, :3])


def test_fusion_importer_and_npz_loader_equal_jax(tmp_path):
    sd = reference_fusion_state(6)
    _equal_trees(torch_import.import_fusion_state_dict(sd),
                 jax_import.import_fusion_state_dict(sd))
    tv = reference_resnet_state(7)
    np.savez(tmp_path / "tv.npz", **tv)
    base = {"params": {"other": {"kernel": np.ones(2, np.float32)}}, "batch_stats": {}}
    for kw in (dict(submodule="model", skip_fc=True), dict(submodule=None, skip_fc=False),
               dict(submodule="resnet", in_channels_rgb=15)):
        _equal_trees(torch_import.load_torch_resnet_npz(str(tmp_path / "tv.npz"), base, **kw),
                     jax_import.load_torch_resnet_npz(str(tmp_path / "tv.npz"), base, **kw))


def test_resnet_only_imports_and_loads_pretrained(tmp_path):
    """import_state_dict("resnet_only") takes torchvision names or the
    reference ResNetOnly's (`model.` prefix) and equals JAX's importer
    grafted under `model`; load_pretrained loads the trunk, fc kept."""
    model = ResNetOnly(num_class=10)
    sd = reference_resnet_state(8)
    want = from_flax({"params": {"model": jax_import.import_resnet_state_dict(sd)["params"]},
                      "batch_stats": {"model": jax_import.import_resnet_state_dict(sd)[
                          "batch_stats"]}}, model)
    for names in (sd, {f"model.{k}": v for k, v in sd.items()},
                  {f"module.model.{k}": v for k, v in sd.items()}):
        got = torch_import.import_state_dict("resnet_only", names, model)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    np.savez(tmp_path / "tv.npz", **sd)
    fresh = ResNetOnly(num_class=10, pretrained=str(tmp_path / "tv.npz"))
    fc = fresh.model.fc.weight.clone()
    fresh.load_pretrained()
    for k, v in fresh.state_dict().items():
        if k.startswith("model.fc."):
            continue
        assert torch.equal(v, want[k]), k
    assert torch.equal(fresh.model.fc.weight, fc)


def test_flax_paths_and_init():
    model = get_model("resnet_only", num_class=10, generator=torch.Generator().manual_seed(2))
    paths = flax_param_paths(model)
    assert paths["model.layer2_0.downsample_conv.weight"] == "model/layer2_0/downsample_conv/kernel"
    assert paths["model.layer4_2.bn3.weight"] == "model/layer4_2/bn3/scale"
    assert paths["model.fc.weight"] == "model/fc/kernel"
    w = model.model.layer3_1.conv2.weight  # (256, 256, 3, 3): fan_out 256 * 9
    assert abs(w.std().item() - np.sqrt(2 / (256 * 9))) < 0.02 * np.sqrt(2 / (256 * 9))
    bound = 1 / np.sqrt(2048)
    assert model.model.fc.weight.abs().max().item() <= bound
    assert model.model.fc.weight.abs().max().item() > 0.9 * bound
    assert all(torch.equal(m.weight, torch.ones_like(m.weight))
               for m in model.modules() if type(m).__name__ == "BatchNorm")
    # the JAX tree and the port's name the same parameters
    jm = jax_resnet.ResNet(block=jax_resnet.Bottleneck, layers=(1, 1, 1, 1), num_classes=10)
    init = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, S, S)),
                                          train=False))
    leaves = {"/".join(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(init["params"])[0]}
    port = resnet.ResNet(block=resnet.Bottleneck, layers=(1, 1, 1, 1), num_classes=10)
    assert set(flax_param_paths(port).values()) == leaves


def test_block_dropout_raises_in_training_only():
    """block_dropout is the identity in eval; in training it draws from the
    seeded stream (outside one it raises), two sites a BasicBlock."""
    model = resnet.ResNet(block=resnet.BasicBlock, layers=(1, 1, 1, 1), num_classes=10,
                          block_dropout=0.1)
    x = torch.randn(2, 3, S, S)
    with torch.no_grad():
        plain = resnet.ResNet(block=resnet.BasicBlock, layers=(1, 1, 1, 1), num_classes=10)
        plain.load_state_dict(model.state_dict())
        assert torch.equal(model.eval()(x), plain.eval()(x))
        with pytest.raises(RuntimeError, match="seeded stream"):
            model.train()(x)
        with dropout.stream(0, 0) as s:
            dropped = model(x)
        with dropout.stream(0, 0):
            assert torch.equal(model(x), dropped)
        assert s.sites == 8 and not torch.equal(dropped, plain.train()(x))
