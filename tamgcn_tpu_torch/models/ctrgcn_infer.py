"""Fast CTR-GCN inference: the blocks through the whole-block kernel K5.

Counterpart of tamgcn_tpu/models/ctrgcn_infer.py. From a `CTRGCN`'s current
weights, `make_fast_eval` folds every eval BatchNorm into the 1x1 conv
beside it (and `out_bn` into the branch convs, the max-pool affine and the
1x1 branch), once, on the model's device, and returns an eval forward equal
to ``model.eval()(x)``. Each of the ten TCN_GCN_units whose shape K5 takes
(ops/gcn_tcn_block.py:k5_takes, V <= 28 at the model's widths) runs through
ops/gcn_tcn_block.py:gcn_tcn_block_fused (K5 on the card, its plain version
on the CPU); every other block runs `_block_prefix_pw`: the same folded math
with the unit op through ops/aggregation.py:unit_ctr_gc (K1, or its
joint-tiled design at large V, on the card) and `torch.matmul` products.
The rule reads the shape, never a failed launch, as the JAX engine's `auto`
policy picks its engine from `num_point`. The dilated temporal branches, the
max-pool and the pooled head stay plain PyTorch, as the JAX engine leaves
them to XLA. ``use_kernel=True`` runs every block through K5 (and raises
where K5 does not take the shape), ``use_kernel=False`` every block through
`_block_prefix_pw`, the comparison path.

Weights change between the evaluations of a training run, so a caller folds
anew (calls `make_fast_eval` again) after every change, or takes
`make_fast_eval_step`, which folds inside the step, as the JAX trainer's
jitted fast-eval step calls `fast_fn(variables, ...)` inside its jit
(tamgcn_tpu/train/trainer.py:355-366). Folding reads no value back to the
host and branches on shapes only, so the step can be captured in a CUDA
graph (train/graphs.py) that scores whatever weights the model holds at
each replay.

The engine computes in f32 from the model's f32 parameters whatever the
model's compute dtype. On a bf16 model (`model_args.dtype: bfloat16`) the
default (use_kernel None) follows the JAX package's `auto` policy
(tamgcn_tpu/models/ctrgcn_infer.py:make_fast_eval_fn, which never reads the
model's dtype): at num_point <= 20, where that policy returns the model's
own eval forward, the fast eval is the bf16 model's own forward (bf16
arithmetic through K1's bf16 form); at num_point > 20 it is the f32 engine,
as the JAX engine is. An f32 model keeps the engine at every num_point: the
two compute the same function in f32. So no bf16 form of K5 runs on any
path.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops.aggregation import unit_ctr_gc
from ..ops.gcn_tcn_block import gcn_tcn_block_fused, gcn_tcn_block_plain, k5_takes
from .ctrgcn import CTRGCN


def fold_bn(bn):
    """Eval BatchNorm as a per-channel affine: y = x * scale + bias."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


def _fold_conv_bn(kernel, bias, scale, shift):
    """(x @ W + b) * s + t == x @ (W s) + (b s + t); kernel (in, out)."""
    return kernel * scale[None, :], bias * scale + shift


@torch.no_grad()
def _fold_block(blk) -> dict:
    """Every folded weight of one TCN_GCN_unit (models/ctrgcn.py:TCNGCNUnit),
    with the JAX engine's keys. Products are (in, out) matrices; the branch
    kernels keep the port's (out, in, k, 1) layout."""
    gcn, tcn = blk.gcn1, blk.tcn1
    S, _, C = gcn.conv4_kernel.shape
    fb: dict[str, Any] = {"stride": tcn.stride, "S": S, "C": C}
    fb["w12"] = gcn.conv12.weight.t()
    fb["b12"] = gcn.conv12.bias
    fb["w3"] = gcn.conv3.weight.t().contiguous()
    fb["b3"] = gcn.conv3.bias
    fb["w4s"] = gcn.conv4_kernel
    fb["b4s"] = gcn.conv4_bias
    fb["alpha"] = gcn.alpha
    fb["A"] = gcn.PA
    fb["gy"] = torch.stack(fold_bn(gcn.bn))
    if hasattr(gcn, "down_conv"):
        fb["wd"], fb["bd"] = _fold_conv_bn(
            gcn.down_conv.weight.t(), gcn.down_conv.bias, *fold_bn(gcn.down_bn))
    else:
        fb["wd"] = fb["bd"] = None
    fb["wo"], fb["bo"] = _fold_conv_bn(
        gcn.offset_conv.weight.t(), gcn.offset_conv.bias, *fold_bn(gcn.offset_bn))

    # TCN: prefix conv+BN, branch convs (+ out_bn), max-pool affine, pw (+ out_bn)
    fb["wp"], fb["bp"] = _fold_conv_bn(
        tcn.prefix_conv.weight.t(), tcn.prefix_conv.bias, *fold_bn(tcn.prefix_bn))
    obn_s, obn_b = fold_bn(tcn.out_bn)
    bc, n_dil = tcn.branch_channels, tcn.n_dil
    branches = []
    for i in range(n_dil):
        conv = getattr(tcn, f"branch{i}_tconv_conv")
        sl = slice(i * bc, (i + 1) * bc)
        branches.append((conv.pad, conv.dilation,
                         conv.weight * obn_s[sl][:, None, None, None],
                         conv.bias * obn_s[sl] + obn_b[sl]))
    fb["branches"] = branches
    mp = slice(n_dil * bc, (n_dil + 1) * bc)
    fb["mp_scale"], fb["mp_bias"] = obn_s[mp], obn_b[mp]
    pw = slice((n_dil + 1) * bc, (n_dil + 2) * bc)
    fb["wpw"], fb["bpw"] = _fold_conv_bn(
        tcn.pw_conv.weight.t(), tcn.pw_conv.bias, obn_s[pw], obn_b[pw])

    # block residual: none / identity / folded strided 1x1 conv+BN
    fb["res"] = blk.res_mode
    if blk.res_mode == "conv":
        conv = blk.residual.conv
        fb["wres"], fb["bres"] = _fold_conv_bn(
            conv.weight[:, :, 0, 0].t(), conv.bias, *fold_bn(blk.residual.bn))
    return {k: v.detach().contiguous() if isinstance(v, torch.Tensor) else v
            for k, v in fb.items()}


def _block_prefix_pw(fb: dict, x, x1s, x2s):
    """The folded block up to its temporal branches with the unit op through
    `unit_ctr_gc` (K1 on the card) and torch.matmul products: the path that
    K5 is compared with."""
    return gcn_tcn_block_plain(
        x, x1s, x2s, fb["w3"], fb["b3"], fb["w4s"], fb["b4s"], fb["alpha"],
        fb["A"], fb["gy"], fb["wo"], fb["bo"], fb["wp"], fb["bp"], fb["wpw"],
        fb["bpw"], fb["wd"], fb["bd"], aggregate=unit_ctr_gc)


def block_takes_k5(fb: dict) -> bool:
    """Whether the folded block `fb` runs through K5 under the default rule
    (use_kernel=None): K5's launcher takes its shape."""
    _, R, C = fb["w4s"].shape
    return k5_takes(fb["A"].shape[-1], fb["w3"].shape[0], C, R)


def _apply_block(fb: dict, x, use_kernel: bool):
    """One folded TCN_GCN_unit forward. x (NM, T, V, Cin), contiguous."""
    S, C, stride = fb["S"], fb["C"], fb["stride"]
    R = fb["w4s"].shape[1]
    NM, T, V, _ = x.shape

    # conv12 on the T-mean (a 1x1 conv commutes with the T pool)
    e12 = torch.matmul(x.mean(dim=1), fb["w12"]) + fb["b12"]  # (NM, V, 2SR)
    x1s = e12[..., :S * R].reshape(NM, V, S, R).permute(0, 2, 1, 3).contiguous()
    x2s = e12[..., S * R:].reshape(NM, V, S, R).permute(0, 2, 1, 3).contiguous()
    if use_kernel:
        prefix, pw = gcn_tcn_block_fused(
            x, x1s, x2s, fb["w3"], fb["b3"], fb["w4s"], fb["b4s"], fb["alpha"],
            fb["A"], fb["gy"], fb["wo"], fb["bo"], fb["wp"], fb["bp"],
            fb["wpw"], fb["bpw"], fb["wd"], fb["bd"])
    else:
        prefix, pw = _block_prefix_pw(fb, x, x1s, x2s)

    n_dil = len(fb["branches"])
    bc = C // (n_dil + 2)
    outs = []
    for i, (pad, dil, kern, bias) in enumerate(fb["branches"]):
        seg = prefix[..., i * bc:(i + 1) * bc].permute(0, 3, 1, 2)
        outs.append(F.conv2d(seg, kern, bias, stride=(stride, 1),
                             padding=(pad, 0), dilation=(dil, 1)).permute(0, 2, 3, 1))
    # max_pool2d pads with -inf
    mp = F.max_pool2d(prefix[..., n_dil * bc:].permute(0, 3, 1, 2),
                      kernel_size=(3, 1), stride=(stride, 1), padding=(1, 0))
    outs.append(mp.permute(0, 2, 3, 1) * fb["mp_scale"] + fb["mp_bias"])
    outs.append(pw[:, ::stride])
    out = torch.cat(outs, dim=-1)
    if fb["res"] == "identity":
        out = out + x
    elif fb["res"] == "conv":
        out = out + (torch.matmul(x[:, ::stride], fb["wres"]) + fb["bres"])
    return F.relu(out)


def fold_model(model: CTRGCN) -> dict:
    """The folded weights of every block, the data BN and the head, from the
    model's current weights on its device."""
    with torch.no_grad():
        return {
            "blocks": [_fold_block(blk) for blk in model.blocks],
            "data_bn": fold_bn(model.data_bn),
            # a head split over a model group (parallel/sharded.py) runs as
            # itself: its forward gathers the logits
            "fc": (model.fc if getattr(model.fc, "sharded", False)
                   else (model.fc.weight.t().contiguous(), model.fc.bias.detach().clone())),
        }


def _own_forward(model: CTRGCN, use_kernel: bool | None) -> bool:
    """Whether the fast eval is the model's own forward: a bf16 model at
    num_point <= 20 under the default rule (the module docstring says why)."""
    return use_kernel is None and model.dtype == torch.bfloat16 and model.num_point <= 20


def make_fast_eval_fn(model: CTRGCN, use_kernel: bool | None = None):
    """``fn(folded, x) -> logits`` equal to ``model.eval()(x)``, `folded`
    from `fold_model(model)`; x is (N, C, T, V, M) or the NW-UCLA feeder's
    (N, T, V*C). use_kernel None runs each block whose shape K5 takes
    (block_takes_k5) through `gcn_tcn_block_fused` (K5 on the card) and the
    others through `_block_prefix_pw`; True runs every block through
    `gcn_tcn_block_fused`, False every block through `_block_prefix_pw`.
    A bf16 model at num_point <= 20 with use_kernel None gets its own eval
    forward, which ignores `folded` (the module docstring says why)."""
    if not isinstance(model, CTRGCN):
        raise TypeError(
            f"make_fast_eval_fn requires a CTRGCN model, got {type(model).__name__}")
    num_point = model.num_point
    if _own_forward(model, use_kernel):
        return lambda folded, x: model.eval()(x)

    def use_k5(fb):
        return block_takes_k5(fb) if use_kernel is None else bool(use_kernel)

    def forward(folded, x):
        if x.ndim == 3:  # (N, T, V*C) NW-UCLA feeder layout
            N, T, VC = x.shape
            x = x.reshape(N, T, num_point, VC // num_point).permute(0, 3, 1, 2)[..., None]
        N, C0, T, V, M = x.shape
        dbn_scale, dbn_bias = folded["data_bn"]
        h = x.permute(0, 2, 4, 3, 1).reshape(N, T, M * V * C0) * dbn_scale + dbn_bias
        h = h.reshape(N, T, M, V, C0).permute(0, 2, 1, 3, 4).reshape(N * M, T, V, C0)
        h = h.contiguous()
        for fb in folded["blocks"]:
            h = _apply_block(fb, h, use_k5(fb))
        h = h.reshape(N, M, -1, h.shape[-1]).mean(dim=2).mean(dim=1)
        if not isinstance(folded["fc"], tuple):
            return folded["fc"](h)
        fc_w, fc_b = folded["fc"]
        return torch.matmul(h, fc_w) + fc_b

    return forward


def make_fast_eval(model: CTRGCN, use_kernel: bool | None = None):
    """``fast(x) -> logits`` on the weights `model` holds now: folds once."""
    fn = make_fast_eval_fn(model, use_kernel=use_kernel)
    folded = fold_model(model)
    return lambda x: fn(folded, x)


class FoldedFastEval(torch.nn.Module):
    """The fast eval of `model` on its weights now, folded once, as a module
    (``FoldedFastEval(model)(x) == make_fast_eval(model)(x)``) whose folded
    tensors are buffers: what `torch.export` takes
    (tools/export_serving.py --fast_eval). Where the fast eval is the
    model's own forward (a bf16 model at num_point <= 20), that model is
    its submodule `own` and the forward."""

    def __init__(self, model: CTRGCN, use_kernel: bool | None = None):
        super().__init__()
        self.fn = make_fast_eval_fn(model, use_kernel=use_kernel)
        self.own = model if _own_forward(model, use_kernel) else None
        # the folded tree's tensors as buffers folded_<i> (copies: a view of a
        # parameter would save its whole storage), its other leaves as they are
        self.leaves, self.spec = tree_flatten(
            None if self.own is not None else fold_model(model))
        self.tensors = [i for i, leaf in enumerate(self.leaves)
                        if isinstance(leaf, torch.Tensor)]
        for i in self.tensors:
            self.register_buffer(f"folded_{i}", self.leaves[i].clone())
            self.leaves[i] = None

    def forward(self, x):
        if self.own is not None:
            return self.own(x)
        leaves = list(self.leaves)
        for i in self.tensors:
            leaves[i] = getattr(self, f"folded_{i}")
        return self.fn(tree_unflatten(leaves, self.spec), x)


def make_eval_step(model: torch.nn.Module):
    """``step(*inputs, label) -> (mean cross-entropy, logits)``: the forward
    of any model of the registry in the mode it is in (the trainer's eval
    step, and what `make_fast_eval_step` stands in for); no host read, so a
    CUDA graph can capture it."""

    def step(*args):
        *inputs, label = args
        logits = model(*inputs)
        return F.cross_entropy(logits, label), logits

    return step


def make_fast_eval_step(model: CTRGCN):
    """``step(*inputs, label) -> (mean cross-entropy, logits)``: the fast
    eval of `inputs` on the weights the model holds when the step runs,
    folded inside the step (none where the fast eval is the model's own
    forward); no host read, so a CUDA graph can capture it."""
    fn = make_fast_eval_fn(model)
    own = _own_forward(model, None)

    def step(*args):
        *inputs, label = args
        logits = fn(None if own else fold_model(model), *inputs)
        return F.cross_entropy(logits, label), logits

    return step
