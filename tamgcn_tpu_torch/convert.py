"""Convert the JAX package's model variables into the port's state_dict.

`from_flax({"params": ..., "batch_stats": ...}, model)` takes the nested
dicts of numpy arrays that `jax.device_get` returns for a tamgcn_tpu model
(CTR-GCN, ST-GCN, ResNet, ResNetOnly, ResNetGCNAttention) and returns a
state_dict for the port's `model` of the same family. Each pair of models
shares its module names, so a Flax path `l1/gcn1/conv3/kernel` is the
port's `l1.gcn1.conv3.weight`, `blocks_3/tcn_conv/kernel` is
`blocks_3.tcn_conv.weight` and `resnet/layer2_0/downsample_conv/kernel` is
`resnet.layer2_0.downsample_conv.weight`. Layouts:

  * Flax conv kernels are HWIO: a 1x1 kernel (1, 1, in, out) becomes the
    port's (out, in) (CTR-GCN's 1x1 convs, ST-GCN's `gcn/conv` and
    `res_conv`), a temporal kernel (k, 1, in, out) becomes (out, in, k, 1)
    (CTR-GCN's branch convs, ST-GCN's 9x1 `tcn_conv`), and any kh x kw
    kernel (kh, kw, in, out) becomes (out, in, kh, kw) (the ResNet's convs,
    its 1x1 ones too, which the port keeps 4-D for `F.conv2d`);
  * Dense kernels are (in, out) and become (out, in) (CTR-GCN's `fc`,
    ST-GCN's `fcn` head, the ResNet's `fc`, the fusion model's attention
    MLP and classifier);
  * packed conv12/conv3 are packed the same way on both sides, and PA,
    alpha, conv4_kernel (S, R, C), conv4_bias (S, C) and ST-GCN's
    `edge_importance_i` (K, V, V) keep their layout;
  * BatchNorm scale/bias become weight/bias, the batch_stats mean/var the
    running_mean/running_var buffers.

It raises on a leaf it does not consume and on a port tensor it leaves unset.
`flax_param_paths(model)` maps the other way for the parameters: each
port parameter name to its Flax path (`l1.gcn1.conv3.weight` ->
`l1/gcn1/conv3/kernel`, a BatchNorm's `weight` -> `scale`), so that a
parameter-path prefix names the same parameters in both packages
(train/packing.py:freeze_mask_for).
"""
from __future__ import annotations

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_port_layout(value: np.ndarray, target_ndim: int, is_kernel: bool) -> np.ndarray:
    if not is_kernel:
        return value
    if value.ndim == 4 and target_ndim == 2:  # 1x1 conv (1, 1, in, out)
        if value.shape[:2] != (1, 1):
            raise ValueError(f"expected a 1x1 kernel, got {value.shape}")
        return value[0, 0].T
    if value.ndim == 4 and target_ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2 and target_ndim == 2:  # Dense (in, out)
        return value.T
    raise ValueError(f"no layout rule for a kernel {value.shape} -> {target_ndim}-D")


def flax_param_paths(model: torch.nn.Module) -> dict[str, str]:
    """{port parameter name: its "/"-joined Flax path in `params`}."""
    from .ops.norm import BatchNorm

    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "weight":
            is_bn = isinstance(model.get_submodule(owner), BatchNorm)
            leaf = "scale" if is_bn else "kernel"
        out[name] = "/".join(owner.split(".") + [leaf]) if owner else leaf
    return out


def from_flax(variables: dict, model: torch.nn.Module) -> dict:
    """State dict for `model` (a port model) from Flax `variables`, which
    must set every tensor of `model`."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            leaf = _LEAF.get((collection, path[-1]), path[-1])
            key = ".".join(path[:-1] + (leaf,))
            if key not in target:
                raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} has "
                               f"no port tensor ({key})")
            if key in out:
                raise KeyError(f"two Flax leaves map onto {key}")
            value = _to_port_layout(
                np.asarray(value), target[key].ndim, path[-1] == "kernel"
            )
            if tuple(value.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: Flax {value.shape} vs port "
                                 f"{tuple(target[key].shape)}")
            out[key] = torch.tensor(np.array(value), dtype=target[key].dtype)
    unset = sorted(set(target) - set(out))
    if unset:
        raise KeyError(f"port tensors left unset by the Flax variables: {unset}")
    return out
