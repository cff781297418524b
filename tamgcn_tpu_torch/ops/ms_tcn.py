"""The eval multi-scale TCN: its plain version and the dispatcher of T1.

Counterpart of tools/exp_ms_tcn.py (`ms_tcn_xla`, and the Pallas
`ms_tcn_fused`). In eval mode the out_bn of a MultiScaleTCN folds into the
branch convs and the max-pool affine (models/ctrgcn_infer.py:_fold_block),
and the part of the TCN after its entry conv is, on the prefix p
(N, T, V, 3*bc), for the branches i = 0, 1 with dilation d = 1 + i:

    y_i[n,t',u,o] = b[i,o] + sum_{k<5} sum_c p[n, t'*s + (k-2)*d, u, i*bc+c] w[i,k,c,o]
    y_2[n,t',u,c] = max_{j in -1,0,1} p[n, t'*s + j, u, 2*bc+c] * mp[0,c] + mp[1,c]

(frames outside [0, T) are zero for the convs and left out of the max),
concatenated to (N, ceil(T/s), V, 3*bc). On a bfloat16 prefix (the JAX
kernel's bf16 form) the prefix is widened to f32, everything runs in f32
against f32 w, b and mp (widened where they are bf16) and the output is
rounded once to bf16. `ms_tcn_fused` runs it: the plain
version for CPU tensors, the CUDA kernel T1 (ops/cuda/ms_tcn.py) for CUDA
tensors, with no fallback. The fast-eval engine (models/ctrgcn_infer.py:
_apply_block) runs the same math as the plain version does, and keeps it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DILS = (1, 2)
KS = 5


def ms_tcn_dims(prefix, w, b, mp_affine, stride: int):
    """(N, T, V, bc) of T1's operands; raises on a mismatch."""
    if prefix.ndim != 4 or prefix.shape[-1] % 3:
        raise ValueError(f"prefix must be (N, T, V, 3*bc), got {tuple(prefix.shape)}")
    N, T, V, P = prefix.shape
    bc = P // 3
    for name, t, shape in (("w", w, (2, KS, bc, bc)), ("b", b, (2, bc)),
                           ("mp_affine", mp_affine, (2, bc))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: the multi-scale TCN takes 1 or 2")
    return N, T, V, bc


def ms_tcn_plain(prefix, w, b, mp_affine, stride: int = 1):
    """Plain version of T1. prefix (N,T,V,3*bc); w (2,5,bc,bc) as (in,out);
    b (2,bc); mp_affine (2,bc) (scale, bias) -> (N, ceil(T/stride), V,
    3*bc): two F.conv2d with dilation 1 and 2 and padding 2*d, F.max_pool2d
    (3,1) with padding 1, the affine and torch.cat, as the engine runs them;
    on a bfloat16 prefix the same on the widened operands, rounded to bf16
    at the end."""
    _, _, _, bc = ms_tcn_dims(prefix, w, b, mp_affine, stride)
    if prefix.dtype == torch.bfloat16:
        return ms_tcn_plain(*(t.float() for t in (prefix, w, b, mp_affine)),
                            stride).to(torch.bfloat16)
    outs = []
    for i, d in enumerate(DILS):
        seg = prefix[..., i * bc:(i + 1) * bc].permute(0, 3, 1, 2)
        kern = w[i].permute(2, 1, 0)[..., None]  # (out, in, k, 1)
        pad = (KS - 1) * d // 2
        outs.append(F.conv2d(seg, kern, b[i], stride=(stride, 1), padding=(pad, 0),
                             dilation=(d, 1)).permute(0, 2, 3, 1))
    # max_pool2d pads with -inf
    mp = F.max_pool2d(prefix[..., 2 * bc:].permute(0, 3, 1, 2), kernel_size=(3, 1),
                      stride=(stride, 1), padding=(1, 0))
    outs.append(mp.permute(0, 2, 3, 1) * mp_affine[0] + mp_affine[1])
    return torch.cat(outs, dim=-1)


def ms_tcn_fused(prefix, w, b, mp_affine, stride: int = 1):
    """T1 on the device of the prefix: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (which raises on what it does not
    take; there is no fallback). Shapes as ms_tcn_plain; on a bfloat16
    prefix, its bf16 form (either side widens w, b and mp_affine to float32
    where they are bfloat16)."""
    args = (prefix, w, b, mp_affine, stride)
    if prefix.device.type == "cpu":
        return ms_tcn_plain(*args)
    if prefix.device.type == "cuda":
        from .cuda.ms_tcn import ms_tcn_fwd

        return ms_tcn_fwd(*args)
    raise NotImplementedError(f"ms_tcn_fused on device {prefix.device}")


def ms_tcn_operands(fb: dict):
    """T1's operands (w, b, mp_affine, stride) from one folded block of
    models/ctrgcn_infer.py:_fold_block: w[i] = kern_i[:, :, :, 0] permuted to
    (k, in, out), the branch biases and (mp_scale, mp_bias)."""
    branches = fb["branches"]
    if [(pad, dil) for pad, dil, _, _ in branches] != [(2 * d, d) for d in DILS]:
        raise ValueError("T1 takes two branches of kernel 5 with dilations 1 and 2")
    w = torch.stack([kern[:, :, :, 0].permute(2, 1, 0) for _, _, kern, _ in branches])
    b = torch.stack([bias for _, _, _, bias in branches])
    mp = torch.stack([fb["mp_scale"], fb["mp_bias"]])
    return w.contiguous(), b.contiguous(), mp.contiguous(), fb["stride"]
