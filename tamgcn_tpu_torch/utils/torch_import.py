"""Reference PyTorch state dicts -> the port's state dicts.

Copy of tamgcn_tpu/utils/torch_import.py (numpy only): the CTR-GCN, ST-GCN,
ResNet (torchvision names, conv1 inflated 3 -> 3k) and cross-modal fusion
importers. The reference checkpoints (models/ctrgcn.py, models/stgcn.py,
models/resnet_only.py, models/resnet_gcn_attention.py, torchvision's
resnet50, written as `.npz` by tools/export_torch_weights.py or saved as a
`.pt` state dict by torch) name and lay out their
tensors as the reference modules do; the importers map them onto the JAX
package's Flax variable tree (`{"params": ..., "batch_stats": ...}`, nested
dicts keyed by module path), and `convert.from_flax` maps that tree onto the
port's state dict. `import_state_dict(model_name, arrays, model)` does both
for the configured model, with the reference's `module.` prefix strip
(torchlight io.py:65-66).

Layout conversions into the Flax tree:
  torch Conv2d weight (O, I, kh, kw) -> Flax Conv kernel (kh, kw, I, O)
  torch Linear weight (O, I)         -> Flax Dense kernel (I, O)
  torch BatchNorm weight/bias/running_mean/running_var
      -> Flax BatchNorm scale/bias + batch_stats mean/var

`reference_named(state)` tells a state dict of reference names from one of
the port's own names (train/checkpoint.py reads a `.pt` of either).
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

Tree = dict[str, Any]


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def strip_module_prefix(state: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Drop DataParallel 'module.' prefixes (torchlight io.py:65-66)."""
    return {k.removeprefix("module."): np.asarray(v) for k, v in state.items()}


# names only the reference's modules have: CTR-GCN's per-subset `convs.i` and
# the multi-scale TCN's `branches.i` (the port packs both), ST-GCN's
# `st_gcn_networks.i`, torchvision's `layerN.i` (the port's `layerN_i`) and
# the fusion model's `attention_transform.i`
_REFERENCE_NAME = re.compile(
    r"(^|\.)(convs\.\d+\.|branches\.\d+\.|st_gcn_networks\.|layer\d\.\d+\.|"
    r"attention_transform\.)")


def reference_named(state: Mapping) -> bool:
    """Whether the tensor names of `state` are the reference's (any name
    only a reference module has), not the port's."""
    return any(_REFERENCE_NAME.search(k.removeprefix("module.")) for k in state)


class _TreeBuilder:
    """Accumulates params/batch_stats trees keyed by '/'-joined Flax paths."""

    def __init__(self):
        self.params: Tree = {}
        self.batch_stats: Tree = {}

    def _set(self, tree: Tree, path: str, value: np.ndarray):
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        v = np.asarray(value)
        # float64 passes through untouched (f64 comparisons round-trip
        # exactly); everything else (f32 checkpoints, torch int64 counters)
        # lands in f32
        node[keys[-1]] = v if v.dtype == np.float64 else v.astype(np.float32)

    def conv(self, sd: Mapping, tname: str, fpath: str, bias: bool = True):
        self._set(self.params, f"{fpath}/kernel", _conv_w(sd[f"{tname}.weight"]))
        if bias and f"{tname}.bias" in sd:
            self._set(self.params, f"{fpath}/bias", sd[f"{tname}.bias"])

    def dense(self, sd: Mapping, tname: str, fpath: str):
        self._set(self.params, f"{fpath}/kernel", sd[f"{tname}.weight"].T)
        if f"{tname}.bias" in sd:
            self._set(self.params, f"{fpath}/bias", sd[f"{tname}.bias"])

    def bn(self, sd: Mapping, tname: str, fpath: str):
        self._set(self.params, f"{fpath}/scale", sd[f"{tname}.weight"])
        self._set(self.params, f"{fpath}/bias", sd[f"{tname}.bias"])
        self._set(self.batch_stats, f"{fpath}/mean", sd[f"{tname}.running_mean"])
        self._set(self.batch_stats, f"{fpath}/var", sd[f"{tname}.running_var"])

    def raw(self, sd: Mapping, tname: str, fpath: str):
        self._set(self.params, fpath, np.asarray(sd[tname]))

    def variables(self) -> dict[str, Tree]:
        return {"params": self.params, "batch_stats": self.batch_stats}


def _import_unit_gcn(b: _TreeBuilder, sd: Mapping, t: str, f: str, in_ch, out_ch):
    """unit_gcn: the three subsets' CTRGC convs (reference
    models/ctrgcn.py:161-164, :204-207) pack into the JAX package's fused
    layout: conv12 = [conv1_s0..2 | conv2_s0..2] concatenated on output
    channels, conv3 = [conv3_s0..2], conv4 stacked (S, R, C)."""
    S = 3
    k1 = [_conv_w(sd[f"{t}.convs.{i}.conv1.weight"]) for i in range(S)]
    k2 = [_conv_w(sd[f"{t}.convs.{i}.conv2.weight"]) for i in range(S)]
    b._set(b.params, f"{f}/conv12/kernel", np.concatenate(k1 + k2, axis=-1))
    b._set(
        b.params,
        f"{f}/conv12/bias",
        np.concatenate(
            [sd[f"{t}.convs.{i}.conv1.bias"] for i in range(S)]
            + [sd[f"{t}.convs.{i}.conv2.bias"] for i in range(S)]
        ),
    )
    k3 = [_conv_w(sd[f"{t}.convs.{i}.conv3.weight"]) for i in range(S)]
    b._set(b.params, f"{f}/conv3/kernel", np.concatenate(k3, axis=-1))
    b._set(
        b.params,
        f"{f}/conv3/bias",
        np.concatenate([sd[f"{t}.convs.{i}.conv3.bias"] for i in range(S)]),
    )
    k4 = [_conv_w(sd[f"{t}.convs.{i}.conv4.weight"])[0, 0] for i in range(S)]
    b._set(b.params, f"{f}/conv4_kernel", np.stack(k4))
    b._set(
        b.params,
        f"{f}/conv4_bias",
        np.stack([sd[f"{t}.convs.{i}.conv4.bias"] for i in range(S)]),
    )
    b.raw(sd, f"{t}.PA", f"{f}/PA")
    b.raw(sd, f"{t}.alpha", f"{f}/alpha")
    b.bn(sd, f"{t}.bn", f"{f}/bn")
    if in_ch != out_ch:
        b.conv(sd, f"{t}.down.0", f"{f}/down_conv")
        b.bn(sd, f"{t}.down.1", f"{f}/down_bn")
    b.conv(sd, f"{t}.offset_conv.0", f"{f}/offset_conv")
    b.bn(sd, f"{t}.offset_conv.1", f"{f}/offset_bn")


def _import_mstcn(b: _TreeBuilder, sd: Mapping, t: str, f: str, n_dil=2,
                  residual_conv=False):
    """MultiScale_TemporalConv branches (reference models/ctrgcn.py:93-124)
    packed into the JAX package's layout: the dilated and maxpool branches'
    entry 1x1+BN concatenate into prefix_conv/prefix_bn, and all branches'
    output BNs concatenate into out_bn (order [dilated..., maxpool, 1x1], the
    concat of models/ctrgcn.py MultiScaleTCN)."""
    i_mp, i_pw = n_dil, n_dil + 1
    entry = list(range(n_dil)) + [i_mp]
    b._set(b.params, f"{f}/prefix_conv/kernel", np.concatenate(
        [_conv_w(sd[f"{t}.branches.{i}.0.weight"]) for i in entry], axis=-1))
    b._set(b.params, f"{f}/prefix_conv/bias", np.concatenate(
        [sd[f"{t}.branches.{i}.0.bias"] for i in entry]))
    for part, fpath in (("weight", "scale"), ("bias", "bias")):
        b._set(b.params, f"{f}/prefix_bn/{fpath}", np.concatenate(
            [sd[f"{t}.branches.{i}.1.{part}"] for i in entry]))
    for part, fpath in (("running_mean", "mean"), ("running_var", "var")):
        b._set(b.batch_stats, f"{f}/prefix_bn/{fpath}", np.concatenate(
            [sd[f"{t}.branches.{i}.1.{part}"] for i in entry]))
    for i in range(n_dil):
        b.conv(sd, f"{t}.branches.{i}.3.conv", f"{f}/branch{i}_tconv_conv")
    b.conv(sd, f"{t}.branches.{i_pw}.0", f"{f}/pw_conv")
    # output BNs: dilated branches' tconv.bn, maxpool's trailing bn, 1x1's bn
    out_bns = [f"{t}.branches.{i}.3.bn" for i in range(n_dil)]
    out_bns += [f"{t}.branches.{i_mp}.4", f"{t}.branches.{i_pw}.1"]
    for part, fpath in (("weight", "scale"), ("bias", "bias")):
        b._set(b.params, f"{f}/out_bn/{fpath}", np.concatenate(
            [sd[f"{bn}.{part}"] for bn in out_bns]))
    for part, fpath in (("running_mean", "mean"), ("running_var", "var")):
        b._set(b.batch_stats, f"{f}/out_bn/{fpath}", np.concatenate(
            [sd[f"{bn}.{part}"] for bn in out_bns]))
    if residual_conv:
        b.conv(sd, f"{t}.residual.conv", f"{f}/residual/conv")
        b.bn(sd, f"{t}.residual.bn", f"{f}/residual/bn")


# (in_ch_factor, out_ch_factor, stride) per block, base_channel units; factor 0
# encodes the raw input channel count.
_CTRGCN_BLOCKS = [
    (0, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 2, 2),
    (2, 2, 1), (2, 2, 1), (2, 4, 2), (4, 4, 1), (4, 4, 1),
]


def import_ctrgcn_state_dict(
    state: Mapping[str, np.ndarray], in_channels: int = 3, base_channel: int = 64
) -> dict[str, Tree]:
    """Map a reference models/ctrgcn.py state_dict onto CTR-GCN Flax variables."""
    sd = strip_module_prefix(state)
    b = _TreeBuilder()
    b.raw(sd, "data_bn.weight", "data_bn/scale")
    b.raw(sd, "data_bn.bias", "data_bn/bias")
    b._set(b.batch_stats, "data_bn/mean", sd["data_bn.running_mean"])
    b._set(b.batch_stats, "data_bn/var", sd["data_bn.running_var"])
    for i, (fi, fo, stride) in enumerate(_CTRGCN_BLOCKS, start=1):
        t, f = f"l{i}", f"l{i}"
        in_ch = in_channels if fi == 0 else fi * base_channel
        out_ch = fo * base_channel
        _import_unit_gcn(b, sd, f"{t}.gcn1", f"{f}/gcn1", in_ch, out_ch)
        _import_mstcn(b, sd, f"{t}.tcn1", f"{f}/tcn1")
        if i > 1 and (in_ch != out_ch or stride != 1):
            b.conv(sd, f"{t}.residual.conv", f"{f}/residual/conv")
            b.bn(sd, f"{t}.residual.bn", f"{f}/residual/bn")
    b.dense(sd, "fc", "fc")
    return b.variables()


_STGCN_BLOCKS = [
    (3, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True), (64, 64, 1, True),
    (64, 128, 2, True), (128, 128, 1, True), (128, 128, 1, True),
    (128, 256, 2, True), (256, 256, 1, True), (256, 256, 1, True),
]


def import_stgcn_state_dict(
    state: Mapping[str, np.ndarray],
) -> dict[str, Tree]:
    """Map a reference models/stgcn.py state_dict onto ST-GCN Flax variables."""
    sd = strip_module_prefix(state)
    b = _TreeBuilder()
    b.raw(sd, "data_bn.weight", "data_bn/scale")
    b.raw(sd, "data_bn.bias", "data_bn/bias")
    b._set(b.batch_stats, "data_bn/mean", sd["data_bn.running_mean"])
    b._set(b.batch_stats, "data_bn/var", sd["data_bn.running_var"])
    for i, (in_ch, out_ch, stride, residual) in enumerate(_STGCN_BLOCKS):
        t, f = f"st_gcn_networks.{i}", f"blocks_{i}"
        b.conv(sd, f"{t}.gcn.conv", f"{f}/gcn/conv")
        b.bn(sd, f"{t}.tcn.0", f"{f}/tcn_bn1")
        b.conv(sd, f"{t}.tcn.2", f"{f}/tcn_conv")
        b.bn(sd, f"{t}.tcn.3", f"{f}/tcn_bn2")
        if residual and (in_ch != out_ch or stride != 1):
            b.conv(sd, f"{t}.residual.0", f"{f}/res_conv")
            b.bn(sd, f"{t}.residual.1", f"{f}/res_bn")
        if f"edge_importance.{i}" in sd:
            b.raw(sd, f"edge_importance.{i}", f"edge_importance_{i}")
    # fcn is a 1x1 Conv2d in the reference (models/stgcn.py:163); the head
    # here is a Dense on pooled features: weights (O, I, 1, 1) -> (I, O)
    b._set(b.params, "fcn/kernel", np.asarray(sd["fcn.weight"])[:, :, 0, 0].T)
    b._set(b.params, "fcn/bias", sd["fcn.bias"])
    return b.variables()


# ResNet block counts per torchvision arch name
_RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def import_resnet_state_dict(
    state: Mapping[str, np.ndarray],
    arch: str = "resnet50",
    bottleneck: bool = True,
    in_channels_rgb: int = 3,
    skip_fc: bool = False,
) -> dict[str, Tree]:
    """Map a torchvision-style ResNet state_dict (reference models/resnet.py
    layout) onto the JAX package's ResNet Flax variables.

    in_channels_rgb > 3 inflates conv1 by channel replication / (k//3)
    (reference models/resnet_gcn_attention.py:37-52).
    """
    sd = strip_module_prefix(state)
    b = _TreeBuilder()

    w1 = _conv_w(np.asarray(sd["conv1.weight"]))  # (7, 7, 3, 64)
    if in_channels_rgb != 3:
        k = in_channels_rgb // 3
        w1 = np.concatenate([w1] * k, axis=2) / k
    b._set(b.params, "conv1/kernel", w1)
    b.bn(sd, "bn1", "bn1")

    layers = _RESNET_LAYERS[arch]
    n_convs = 3 if bottleneck else 2
    for li, n in enumerate(layers, start=1):
        for bi in range(n):
            t, f = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in range(1, n_convs + 1):
                b.conv(sd, f"{t}.conv{ci}", f"{f}/conv{ci}", bias=False)
                b.bn(sd, f"{t}.bn{ci}", f"{f}/bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                b.conv(sd, f"{t}.downsample.0", f"{f}/downsample_conv", bias=False)
                b.bn(sd, f"{t}.downsample.1", f"{f}/downsample_bn")
    if not skip_fc and "fc.weight" in sd:
        b.dense(sd, "fc", "fc")
    return b.variables()


def _merge_subtree(variables: dict, new: dict, submodule: str | None) -> dict:
    """Graft `new` {params, batch_stats} under variables[...][submodule]."""
    out = {k: dict(v) for k, v in variables.items()}

    def merge(dst: dict, src: dict):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                dst[k] = dict(dst[k])
                merge(dst[k], v)
            else:
                dst[k] = v

    for col in ("params", "batch_stats"):
        if col not in new:
            continue
        root = out.setdefault(col, {})
        node = root
        if submodule:
            for part in submodule.split("/"):
                node[part] = dict(node.get(part, {}))
                node = node[part]
        merge(node, new[col])
    return out


def load_torch_resnet_npz(
    path: str,
    variables: dict,
    arch: str = "resnet50",
    submodule: str | None = None,
    skip_fc: bool = True,
    in_channels_rgb: int = 3,
) -> dict:
    """Load an exported torchvision ResNet .npz and merge it into Flax-layout
    variables (nested dicts of numpy arrays; convert.from_flax maps them
    onto a port module)."""
    with np.load(path) as f:
        state = {k: f[k] for k in f.files}
    new = import_resnet_state_dict(
        state, arch=arch, in_channels_rgb=in_channels_rgb, skip_fc=skip_fc
    )
    return _merge_subtree(variables, new, submodule)


def import_fusion_state_dict(
    state: Mapping[str, np.ndarray],
    in_channels: int = 3,
    base_channel: int = 64,
) -> dict[str, Tree]:
    """Map a reference models/resnet_gcn_attention.py state_dict onto the
    JAX package's ResNetGCNAttention Flax variables (gcn + resnet trunks +
    attention MLP + classifier; reference :13-70). `base_channel` is the
    GCN's width (64 in the reference)."""
    sd = strip_module_prefix(state)
    gcn_sd = {k[len("gcn."):]: v for k, v in sd.items() if k.startswith("gcn.")}
    resnet_sd = {
        k[len("resnet."):]: v for k, v in sd.items() if k.startswith("resnet.")
    }
    gcn = import_ctrgcn_state_dict(gcn_sd, in_channels=in_channels,
                                   base_channel=base_channel)
    # the fusion model only uses gcn.extract_feature: its fc head is unused
    # (the reference keeps the dead module)
    gcn["params"].pop("fc", None)
    # conv1 already inflated inside the reference model; map 1:1
    resnet = import_resnet_state_dict(resnet_sd, skip_fc=True)

    b = _TreeBuilder()
    b.dense(sd, "attention_transform.0", "attention_transform_dense1")
    b.bn(sd, "attention_transform.1", "attention_transform_bn")
    b.dense(sd, "attention_transform.3", "attention_transform_dense2")
    b.dense(sd, "classifier", "classifier")
    variables = b.variables()
    variables["params"]["gcn"] = gcn["params"]
    variables["batch_stats"]["gcn"] = gcn["batch_stats"]
    variables["params"]["resnet"] = resnet["params"]
    variables["batch_stats"]["resnet"] = resnet["batch_stats"]
    return variables


def ctrgcn_variables(state, model):
    """import_ctrgcn_state_dict at the widths of the port's `model`."""
    unit = model.l1.gcn1
    return import_ctrgcn_state_dict(state, in_channels=unit.in_channels,
                                    base_channel=unit.out_channels)


def _resnet_only_variables(state, model):
    """A torchvision ResNet-50 state dict (`conv1.weight`, ...) or the
    reference ResNetOnly's (the same under `model.`) onto the port's
    ResNetOnly, whose trunk is its `model` (the Flax tree's `model/`)."""
    sd = strip_module_prefix(state)
    if all(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()}
    net = model.model
    trunk = import_resnet_state_dict(
        sd, arch=net.arch, bottleneck=net.bottleneck,
        in_channels_rgb=net.in_channels)
    return _merge_subtree({}, trunk, "model")


def _fusion_variables(state, model):
    """import_fusion_state_dict at the GCN widths of the port's `model`."""
    unit = model.gcn.l1.gcn1
    return import_fusion_state_dict(state, in_channels=unit.in_channels,
                                    base_channel=unit.out_channels)


# exact model names, as the JAX trainer dispatches (trainer.py:_import_npz)
_IMPORTERS = {
    "ctrgcn": ctrgcn_variables,
    "models.ctrgcn.Model": ctrgcn_variables,
    "stgcn": lambda state, model: import_stgcn_state_dict(state),
    "models.stgcn.Model": lambda state, model: import_stgcn_state_dict(state),
    "resnet_only": _resnet_only_variables,
    "models.resnet_only.Model": _resnet_only_variables,
    "resnet_gcn_attention": _fusion_variables,
    "models.resnet_gcn_attention.ResNet_GCN_Attention": _fusion_variables,
}


def import_state_dict(model_name: str, arrays: Mapping[str, np.ndarray], model) -> dict:
    """The port's state dict for `model` (the port's module registered as
    `model_name`) from a reference state dict `arrays` (numpy arrays keyed
    by the reference's tensor names, `module.` prefixes allowed). Raises on
    an unknown model name, and where the arrays leave a tensor of `model`
    unset (convert.from_flax)."""
    from ..convert import from_flax

    try:
        importer = _IMPORTERS[model_name]
    except KeyError:
        raise ValueError(
            f"no reference state-dict importer for model {model_name!r}; known: "
            f"{sorted(_IMPORTERS)}") from None
    return from_flax(importer(arrays, model), model)
