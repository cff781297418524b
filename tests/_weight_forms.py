"""The three weight forms of the port's --weights, for tests and chip_smoke.py.

numpy and the port only (no JAX), so that chip_smoke.py can write them:

  * `reference_ctrgcn_state` / `reference_stgcn_state` /
    `reference_resnet_state` / `reference_fusion_state`: random state dicts
    named and shaped as the reference's models/ctrgcn.py, models/stgcn.py,
    torchvision's ResNet and models/resnet_gcn_attention.py (built from the
    reference layer shapes, independently of the port), with BatchNorm
    `num_batches_tracked` counters as torch writes them;
  * `to_reference_state`: the inverse of the importer, a port state dict
    (CTR-GCN or ST-GCN) under the reference's names and layouts;
  * `to_flax_arrays`: the inverse of convert.from_flax, a port state dict
    as "/"-joined Flax paths under params/ and batch_stats/, the layout
    tools/export_flax_npz.py writes.
"""
from __future__ import annotations

import numpy as np
import torch

# (in factor, out factor, stride) per CTR-GCN block in base_channel units, 0
# for the input channels; (in, out, stride, residual) per ST-GCN block
# (reference models/ctrgcn.py:296-305, models/stgcn.py:140-150)
CTRGCN_BLOCKS = [(0, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 2, 2),
                 (2, 2, 1), (2, 2, 1), (2, 4, 2), (4, 4, 1), (4, 4, 1)]
STGCN_BLOCKS = [(3, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True),
                (64, 64, 1, True), (64, 128, 2, True), (128, 128, 1, True),
                (128, 128, 1, True), (128, 256, 2, True), (256, 256, 1, True),
                (256, 256, 1, True)]


class _Random:
    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.sd = {}

    def conv(self, name, out, cin, kh=1, bias=True):
        self.sd[f"{name}.weight"] = (self.rs.randn(out, cin, kh, 1)
                                     / np.sqrt(cin * kh)).astype(np.float32)
        if bias:
            self.sd[f"{name}.bias"] = 0.1 * self.rs.randn(out).astype(np.float32)

    def bn(self, name, c):
        self.sd[f"{name}.weight"] = (1 + 0.1 * self.rs.randn(c)).astype(np.float32)
        self.sd[f"{name}.bias"] = (0.1 * self.rs.randn(c)).astype(np.float32)
        self.sd[f"{name}.running_mean"] = (0.1 * self.rs.randn(c)).astype(np.float32)
        self.sd[f"{name}.running_var"] = self.rs.uniform(0.5, 2.0, c).astype(np.float32)
        self.sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    def raw(self, name, *shape, scale=1.0):
        self.sd[name] = (scale * self.rs.randn(*shape)).astype(np.float32)


def reference_ctrgcn_state(seed=0, in_channels=3, base_channel=64, num_class=10,
                           num_point=20, num_person=1, subsets=3):
    """A reference models/ctrgcn.py state dict of random arrays."""
    r = _Random(seed)
    r.bn("data_bn", num_person * num_point * in_channels)
    for i, (fi, fo, stride) in enumerate(CTRGCN_BLOCKS, start=1):
        cin = in_channels if fi == 0 else fi * base_channel
        c = fo * base_channel
        rel = 8 if cin in (3, 9) else cin // 8
        g = f"l{i}.gcn1"
        for s in range(subsets):
            r.conv(f"{g}.convs.{s}.conv1", rel, cin)
            r.conv(f"{g}.convs.{s}.conv2", rel, cin)
            r.conv(f"{g}.convs.{s}.conv3", c, cin)
            r.conv(f"{g}.convs.{s}.conv4", c, rel)
        r.raw(f"{g}.PA", subsets, num_point, num_point, scale=0.3)
        r.raw(f"{g}.alpha", 1, scale=0.5)
        r.bn(f"{g}.bn", c)
        if cin != c:
            r.conv(f"{g}.down.0", c, cin)
            r.bn(f"{g}.down.1", c)
        r.conv(f"{g}.offset_conv.0", c, c)
        r.bn(f"{g}.offset_conv.1", c)
        t, bc = f"l{i}.tcn1", c // 4
        for b in range(4):  # two dilated branches, max-pool, 1x1
            r.conv(f"{t}.branches.{b}.0", bc, c)
            r.bn(f"{t}.branches.{b}.1", bc)
        for b in range(2):
            r.conv(f"{t}.branches.{b}.3.conv", bc, bc, kh=5)
            r.bn(f"{t}.branches.{b}.3.bn", bc)
        r.bn(f"{t}.branches.2.4", bc)
        if i > 1 and (cin != c or stride != 1):
            r.conv(f"l{i}.residual.conv", c, cin)
            r.bn(f"l{i}.residual.bn", c)
    r.raw("fc.weight", num_class, 4 * base_channel, scale=0.1)
    r.raw("fc.bias", num_class, scale=0.1)
    return r.sd


def reference_stgcn_state(seed=0, in_channels=3, num_class=10, num_point=20,
                          partitions=3):
    """A reference models/stgcn.py state dict of random arrays, with edge
    importance."""
    r = _Random(seed)
    r.bn("data_bn", num_point * in_channels)
    for i, (cin, c, stride, residual) in enumerate(STGCN_BLOCKS):
        cin = in_channels if i == 0 else cin
        t = f"st_gcn_networks.{i}"
        r.conv(f"{t}.gcn.conv", partitions * c, cin)
        r.bn(f"{t}.tcn.0", c)
        r.conv(f"{t}.tcn.2", c, c, kh=9)
        r.bn(f"{t}.tcn.3", c)
        if residual and (cin != c or stride != 1):
            r.conv(f"{t}.residual.0", c, cin)
            r.bn(f"{t}.residual.1", c)
        r.sd[f"edge_importance.{i}"] = (1 + 0.2 * r.rs.randn(
            partitions, num_point, num_point)).astype(np.float32)
    r.conv("fcn", num_class, 256)
    return r.sd


def reference_resnet_state(seed=0, layers=(3, 4, 6, 3), bottleneck=True, in_channels=3,
                           num_classes=10, width_per_group=64, prefix=""):
    """A torchvision ResNet state dict of random arrays (conv1 taking
    `in_channels`), its names under `prefix`."""
    r = _Random(seed)
    w = r.rs

    def conv(name, out, cin, k):
        r.sd[f"{prefix}{name}.weight"] = (w.randn(out, cin, k, k)
                                          * np.sqrt(2.0 / (out * k * k))).astype(np.float32)

    def bn(name, c):
        r.bn(f"{prefix}{name}", c)

    conv("conv1", 64, in_channels, 7)
    bn("bn1", 64)
    expansion = 4 if bottleneck else 1
    inplanes = 64
    for li, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers, (1, 2, 2, 2)),
                                             start=1):
        for bi in range(n):
            t = f"layer{li}.{bi}"
            s = stride if bi == 0 else 1
            if bottleneck:
                width = planes * width_per_group // 64
                for ci, (o, i_, k) in enumerate(((width, inplanes, 1), (width, width, 3),
                                                 (planes * 4, width, 1)), start=1):
                    conv(f"{t}.conv{ci}", o, i_, k)
                    bn(f"{t}.bn{ci}", o)
            else:
                for ci, i_ in enumerate((inplanes, planes), start=1):
                    conv(f"{t}.conv{ci}", planes, i_, 3)
                    bn(f"{t}.bn{ci}", planes)
            if bi == 0 and (s != 1 or inplanes != planes * expansion):
                conv(f"{t}.downsample.0", planes * expansion, inplanes, 1)
                bn(f"{t}.downsample.1", planes * expansion)
            inplanes = planes * expansion
    r.raw(f"{prefix}fc.weight", num_classes, inplanes, scale=0.02)
    r.raw(f"{prefix}fc.bias", num_classes, scale=0.02)
    return r.sd


def reference_fusion_state(seed=0, num_class=10, in_channels_rgb=15, base_channel=64,
                           num_point=20):
    """A reference models/resnet_gcn_attention.py state dict of random arrays:
    its CTR-GCN under `gcn.` (with the dead `fc`), ResNet-50 under `resnet.`
    (conv1 inflated, torchvision's 1000-class `fc`), the attention MLP and
    the classifier."""
    sd = {f"gcn.{k}": v for k, v in reference_ctrgcn_state(
        seed, base_channel=base_channel, num_class=num_class, num_point=num_point).items()}
    sd.update(reference_resnet_state(seed + 1, in_channels=in_channels_rgb,
                                     num_classes=1000, prefix="resnet."))
    r = _Random(seed + 2)
    gcn_dim = 4 * base_channel
    for name, (o, i_) in (("attention_transform.0", (1024, gcn_dim)),
                          ("attention_transform.3", (2048, 1024)),
                          ("classifier", (num_class, 2048))):
        r.raw(f"{name}.weight", o, i_, scale=1 / np.sqrt(i_))
        r.raw(f"{name}.bias", o, scale=0.1)
    r.bn("attention_transform.1", 1024)
    sd.update(r.sd)
    return sd


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _conv(w):
    """A port conv weight, (out, in) or (out, in, k, 1), as the reference's
    (out, in, kh, kw)."""
    w = _np(w)
    return w[:, :, None, None] if w.ndim == 2 else w


def _bn(out, sd, port, ref, sl=slice(None)):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{ref}.{leaf}"] = _np(sd[f"{port}.{leaf}"])[sl]


def _conv_into(out, sd, port, ref, sl=slice(None)):
    out[f"{ref}.weight"] = _conv(sd[f"{port}.weight"])[sl]
    out[f"{ref}.bias"] = _np(sd[f"{port}.bias"])[sl]


def to_reference_state(sd, model_name: str) -> dict:
    """A port state dict as the reference's state dict (numpy): the inverse
    of utils/torch_import.import_state_dict for "ctrgcn" or "stgcn"."""
    sd = {k: v for k, v in sd.items()}
    out = {}
    if model_name == "stgcn":
        _bn(out, sd, "data_bn", "data_bn")
        for i in range(len(STGCN_BLOCKS)):
            p, t = f"blocks_{i}", f"st_gcn_networks.{i}"
            _conv_into(out, sd, f"{p}.gcn.conv", f"{t}.gcn.conv")
            _bn(out, sd, f"{p}.tcn_bn1", f"{t}.tcn.0")
            _conv_into(out, sd, f"{p}.tcn_conv", f"{t}.tcn.2")
            _bn(out, sd, f"{p}.tcn_bn2", f"{t}.tcn.3")
            if f"{p}.res_conv.weight" in sd:
                _conv_into(out, sd, f"{p}.res_conv", f"{t}.residual.0")
                _bn(out, sd, f"{p}.res_bn", f"{t}.residual.1")
            if f"edge_importance_{i}" in sd:
                out[f"edge_importance.{i}"] = _np(sd[f"edge_importance_{i}"])
        _conv_into(out, sd, "fcn", "fcn")
        return out
    if model_name != "ctrgcn":
        raise ValueError(model_name)
    _bn(out, sd, "data_bn", "data_bn")
    for i in range(1, 11):
        p = f"l{i}.gcn1"
        S, R, C = _np(sd[f"{p}.conv4_kernel"]).shape
        for s in range(S):
            for j, conv in enumerate(("conv1", "conv2")):
                rows = slice((j * S + s) * R, (j * S + s + 1) * R)
                _conv_into(out, sd, f"{p}.conv12", f"{p}.convs.{s}.{conv}", rows)
            _conv_into(out, sd, f"{p}.conv3", f"{p}.convs.{s}.conv3", slice(s * C, (s + 1) * C))
            w4 = _np(sd[f"{p}.conv4_kernel"])[s].T  # (R, C) -> (C, R)
            out[f"{p}.convs.{s}.conv4.weight"] = w4[:, :, None, None]
            out[f"{p}.convs.{s}.conv4.bias"] = _np(sd[f"{p}.conv4_bias"])[s]
        out[f"{p}.PA"] = _np(sd[f"{p}.PA"])
        out[f"{p}.alpha"] = _np(sd[f"{p}.alpha"])
        _bn(out, sd, f"{p}.bn", f"{p}.bn")
        if f"{p}.down_conv.weight" in sd:
            _conv_into(out, sd, f"{p}.down_conv", f"{p}.down.0")
            _bn(out, sd, f"{p}.down_bn", f"{p}.down.1")
        _conv_into(out, sd, f"{p}.offset_conv", f"{p}.offset_conv.0")
        _bn(out, sd, f"{p}.offset_bn", f"{p}.offset_conv.1")
        t = f"l{i}.tcn1"
        bc = _np(sd[f"{t}.pw_conv.weight"]).shape[0]
        for b in range(3):  # the entry convs of the dilated and max-pool branches
            rows = slice(b * bc, (b + 1) * bc)
            _conv_into(out, sd, f"{t}.prefix_conv", f"{t}.branches.{b}.0", rows)
            _bn(out, sd, f"{t}.prefix_bn", f"{t}.branches.{b}.1", rows)
        for b in range(2):
            _conv_into(out, sd, f"{t}.branch{b}_tconv_conv", f"{t}.branches.{b}.3.conv")
        _conv_into(out, sd, f"{t}.pw_conv", f"{t}.branches.3.0")
        for b, ref in enumerate((f"{t}.branches.0.3.bn", f"{t}.branches.1.3.bn",
                                 f"{t}.branches.2.4", f"{t}.branches.3.1")):
            _bn(out, sd, f"{t}.out_bn", ref, slice(b * bc, (b + 1) * bc))
        if f"l{i}.residual.conv.weight" in sd:
            _conv_into(out, sd, f"l{i}.residual.conv", f"l{i}.residual.conv")
            _bn(out, sd, f"l{i}.residual.bn", f"l{i}.residual.bn")
    out["fc.weight"] = _np(sd["fc.weight"])
    out["fc.bias"] = _np(sd["fc.bias"])
    return out


def to_flax_arrays(sd, model: torch.nn.Module) -> dict:
    """A port state dict as {"params/<flax path>": array, "batch_stats/<owner>/
    mean|var": array}: the inverse of convert.from_flax."""
    from tamgcn_tpu_torch.convert import flax_param_paths

    dense = {name for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    out = {}
    for name, path in flax_param_paths(model).items():
        v = _np(sd[name])
        owner = name.rpartition(".")[0]
        if path.endswith("/kernel"):
            if owner in dense:
                v = v.T
            elif v.ndim == 2:  # 1x1 conv (out, in) -> (1, 1, in, out)
                v = v.T[None, None]
            else:  # (out, in, k, 1) -> (k, 1, in, out)
                v = v.transpose(2, 3, 1, 0)
        out[f"params/{path}"] = v
    for name in sd:
        owner, _, leaf = name.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            stat = "mean" if leaf == "running_mean" else "var"
            out[f"batch_stats/{owner.replace('.', '/')}/{stat}"] = _np(sd[name])
    return out
