"""CTR-GC graph aggregation: plain PyTorch versions and the kernel dispatcher.

Counterpart of tamgcn_tpu/ops/aggregation.py. Activations are NTVC (batch,
time, vertex, channel), as in the JAX package. The unit op

    out[n,t,u,c] = sum_s sum_v M_s[n,u,v,c] * x3s[n,t,v,s*C+c]
    M_s = (tanh(x1s[n,s,u,:] - x2s[n,s,v,:]) @ w4s[s] + b4s[s]) * alpha + As[s,u,v]

(reference models/ctrgcn.py:174-176, summed over the three subsets) runs
through `unit_ctr_gc`, the autograd Function `UnitCtrGc`: for CPU tensors the
plain versions below (forward, x3 gradient, parameter gradients), for CUDA
tensors the hand-written CUDA kernels K1, K2 and K3 (ops/cuda/ctr_gc.py).
The forward is the custom op `tamgcn::unit_ctr_gc` (`unit_ctr_gc_op`), so
that `torch.export` keeps it as one node of an exported graph
(tools/export_serving.py); training, the CUDA graphs and the export share
that one route.

The activations of the unit op (x1s, x2s, x3s, its output and their
gradients) are float32 or, under the JAX package's bf16 mixed precision,
bfloat16, with w4s, b4s, alpha and As float32 in both. The plain versions
then follow the JAX kernels' bf16 bodies (tamgcn_tpu/ops/pallas/ctr_gc.py
`mm_dtype`), not the XLA reference: D = tanh(x1 - x2) in f32 from the bf16
values; M's product over r on D and w4s rounded to bf16, summed in f32; the
aggregation in f32; each bf16 output rounded once. The parameter gradients
use the f32 D and w4s and stay f32; dx1s and dx2s are rounded to bf16.

`unit_ctr_gc_conv3` spans the packed conv3 that makes x3s as well; with the
JAX package's switch TAMGCN_FUSE_CONV3=1 it takes `UnitCtrGcConv3`, whose
backward is K6 (the x3 gradient carried through conv3's VJP on the chip) and
K3, in f32 or bf16; K6's bf16 form follows the JAX kernel's bf16 body: its x3
gradient stays f32, is rounded to bf16 once as the operand of the dx and dw3
products (f32 sums, each output rounded once) and enters db3 unrounded.

`ctr_gc_fused` is the standalone single-subset op of the `CTRGC` module (K4
in the JAX package): in f32 through K1 and K2 at S = 1; on bf16 x1, x2 and
x3 through K4's bf16 form, which follows the JAX K4 on bf16 operands: D =
bf16(tanh(bf16(x1 - x2))), w4 and the product f32, the output f32.

`stgcn_aggregate` is ST-GCN's 3-partition spatial aggregation, a plain
contraction in the JAX package too (no Pallas kernel), so it is one
`torch.einsum` on every device.
"""
from __future__ import annotations

import os

import torch
from torch.autograd.function import once_differentiable


def _operand(t, operand_dtype):
    """`t` rounded to `operand_dtype` and widened back (as is where None)."""
    return t if operand_dtype is None else t.to(operand_dtype).to(t.dtype)


def ctr_gc_dynamic_adjacency(x1, x2, w4, b4, alpha, A, operand_dtype=None):
    """Channel-wise refined adjacency M[n,u,v,c] = (tanh(x1-x2)@w4 + b4)*alpha + A.

    x1 (N,U,R), x2 (N,V,R), w4 (R,C), b4 (C,) or None, alpha (1,), A (U,V).
    With `operand_dtype` (bfloat16), D = tanh(x1-x2) and w4 are rounded to it
    before their product, which sums in the dtype of x1.
    """
    d = torch.tanh(x1[:, :, None, :] - x2[:, None, :, :])  # (N, U, V, R)
    m = torch.matmul(_operand(d, operand_dtype), _operand(w4, operand_dtype))  # (N, U, V, C)
    if b4 is not None:
        m = m + b4
    return m * alpha + A[None, :, :, None]


def ctr_gc_aggregate(m, x3):
    """out[n,t,u,c] = sum_v m[n,u,v,c] * x3[n,t,v,c] (reference 'ncuv,nctv->nctu')."""
    return torch.einsum("nuvc,ntvc->ntuc", m, x3)


def _widened(*activations):
    """(the activations' dtype, the bf16 operand dtype of stage 1 or None, the
    activations widened to float32 where they are bfloat16)."""
    dtype = activations[0].dtype
    if dtype != torch.bfloat16:
        return dtype, None, activations
    return dtype, torch.bfloat16, tuple(a.float() for a in activations)


def unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As, stage1=None):
    """Plain version of the unit op (counterpart of `unit_ctr_gc_xla`; in
    bfloat16, of the JAX kernel's bf16 body, as the module docstring says).

    x1s/x2s (N,S,V,R); x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha (1,);
    As (S,V,V) -> (N,T,V,C) in the dtype of x3s. `stage1` (bfloat16) rounds
    stage 1's operands on f32 activations too: the whole block's bf16 form
    (ops/gcn_tcn_block.py), whose x3 stays f32.
    """
    S = x1s.shape[1]
    C = x3s.shape[-1] // S
    dtype, operand, (x1s, x2s, x3s) = _widened(x1s, x2s, x3s)
    operand = operand or stage1
    out = None
    for s in range(S):
        m = ctr_gc_dynamic_adjacency(
            x1s[:, s], x2s[:, s], w4s[s], b4s[s], alpha, As[s], operand
        )
        y = ctr_gc_aggregate(m, x3s[..., s * C:(s + 1) * C])
        out = y if out is None else out + y
    return out.to(dtype)


@torch.library.custom_op("tamgcn::unit_ctr_gc", mutates_args=(), device_types="cpu")
def unit_ctr_gc_op(x1s: torch.Tensor, x2s: torch.Tensor, x3s: torch.Tensor,
                   w4s: torch.Tensor, b4s: torch.Tensor, alpha: torch.Tensor,
                   As: torch.Tensor) -> torch.Tensor:
    """The unit op's forward as the custom op `tamgcn::unit_ctr_gc`, one node
    of a `torch.export` graph: on the CPU its plain version
    (unit_ctr_gc_plain), on a CUDA device K1 in either design and form
    (ops/cuda/ctr_gc.py:unit_ctr_gc_fwd, which counts its launches and
    raises on what it does not take: no fallback). Shapes as
    unit_ctr_gc_plain; the output is contiguous."""
    return unit_ctr_gc_plain(x1s, x2s, x3s, w4s, b4s, alpha, As).contiguous()


@unit_ctr_gc_op.register_kernel("cuda")
def _unit_ctr_gc_cuda(x1s, x2s, x3s, w4s, b4s, alpha, As):
    from .cuda import ctr_gc

    return ctr_gc.unit_ctr_gc_fwd(x1s, x2s, x3s, w4s, b4s, alpha, As)


@unit_ctr_gc_op.register_fake
def _unit_ctr_gc_fake(x1s, x2s, x3s, w4s, b4s, alpha, As):
    N, T, V, _ = x3s.shape
    return x3s.new_empty((N, T, V, w4s.shape[-1]))


def unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As):
    """Plain version of K2, the unit op's x3 gradient:
    dx3s[n,t,v,s*C+c] = sum_u M_s[n,u,v,c] * g[n,t,u,c].

    x1s/x2s (N,S,V,R); g (N,T,V,C); w4s (S,R,C); b4s (S,C); alpha (1,);
    As (S,V,V) -> (N,T,V,S*C) in the dtype of g. Stage 1 follows the dtype
    of x1s and x2s: on bf16 x1s/x2s with an f32 g, the x3 gradient of
    K6-bf16, f32 and unrounded.
    """
    _, operand, (x1s, x2s) = _widened(x1s, x2s)
    dtype = g.dtype
    if dtype == torch.bfloat16:
        g = g.float()
    return torch.cat([
        torch.einsum(
            "nuvc,ntuc->ntvc",
            ctr_gc_dynamic_adjacency(x1s[:, s], x2s[:, s], w4s[s], b4s[s], alpha,
                                     As[s], operand),
            g,
        )
        for s in range(x1s.shape[1])
    ], dim=-1).to(dtype)


def unit_ctr_gc_param_grads_plain(x1s, x2s, g, x3s, w4s, b4s, alpha):
    """Plain version of K3, the unit op's other gradients (docs/KERNELS.md
    "Fully-fused backward"), per subset s:

        dm[n,u,v,c] = sum_t g[n,t,u,c] * x3s[n,t,v,s*C+c]
        D = tanh(x1s[n,s,u,:] - x2s[n,s,v,:])
        dA = sum_{n,c} dm;  db4 = alpha sum_{n,u,v} dm;  dw4 = alpha D^T dm
        dalpha = sum dm * (D @ w4 + b4)
        dpre = alpha (dm @ w4^T) (1 - D^2);  dx1 = sum_v dpre;  dx2 = -sum_u dpre

    Returns (dx1s, dx2s, dw4s, db4s, dalpha, dAs) shaped as x1s, x2s, w4s,
    b4s, alpha and (S,V,V); in bfloat16, the f32 arithmetic on the widened
    activations, with dx1s and dx2s rounded to bfloat16 and the rest f32.
    """
    S = x1s.shape[1]
    C = x3s.shape[-1] // S
    dtype, _, (x1s, x2s, g, x3s) = _widened(x1s, x2s, g, x3s)
    dx1s, dx2s, dw4s, db4s, dAs = [], [], [], [], []
    dalpha = torch.zeros_like(alpha)
    for s in range(S):
        dm = torch.einsum("ntuc,ntvc->nuvc", g, x3s[..., s * C:(s + 1) * C])
        d = torch.tanh(x1s[:, s, :, None, :] - x2s[:, s, None, :, :])  # (N,U,V,R)
        dAs.append(dm.sum(dim=(0, 3)))
        db4s.append(alpha * dm.sum(dim=(0, 1, 2)))
        dw4s.append(alpha * torch.einsum("nuvr,nuvc->rc", d, dm))
        dalpha = dalpha + (dm * (torch.matmul(d, w4s[s]) + b4s[s])).sum()
        dpre = alpha * torch.matmul(dm, w4s[s].t()) * (1 - d * d)
        dx1s.append(dpre.sum(dim=2))
        dx2s.append(-dpre.sum(dim=1))
    return (torch.stack(dx1s, dim=1).to(dtype), torch.stack(dx2s, dim=1).to(dtype),
            torch.stack(dw4s), torch.stack(db4s), dalpha, torch.stack(dAs))


def unit_ctr_gc_bwd_conv3_plain(x1s, x2s, g, x, w3, w4s, b4s, alpha, As):
    """Plain version of K6: the unit op's x3 gradient carried through the
    packed conv3 x3s = x @ w3 + b3 (counterpart of the non-tile branch of
    unit_ctr_gc_bwd_conv3_pallas, tamgcn_tpu/ops/pallas/ctr_gc.py:1401-1411):

        dx3s = unit_ctr_gc_dx3_plain(...);  dx = dx3s @ w3^T
        dw3 = x^T dx3s (summed over n, t, v);  db3 = sum_{n,t,v} dx3s

    x (N,T,V,Cin); w3 (Cin,S*C); the rest as unit_ctr_gc_dx3_plain ->
    (dx, dw3, db3) shaped as x, w3 and (S*C,), in the activations' dtype.
    In bfloat16 (x1s, x2s, g, x and w3), the JAX kernel's bf16 body
    (tamgcn_tpu/ops/pallas/ctr_gc.py:510-558, the tile branch): dx3s in f32,
    unrounded; rounded once to bf16 as the operand of both products, which
    sum in f32 over the bf16 x and w3; db3 summed from the unrounded dx3s;
    dx, dw3 and db3 each rounded once to bf16.
    """
    dtype = g.dtype
    if dtype != torch.bfloat16:
        dx3s = unit_ctr_gc_dx3_plain(x1s, x2s, g, w4s, b4s, alpha, As)
        dx = torch.matmul(dx3s, w3.t())
        dw3 = torch.einsum("ntvi,ntvo->io", x, dx3s)
        return dx, dw3, dx3s.sum(dim=(0, 1, 2))
    dx3s = unit_ctr_gc_dx3_plain(x1s, x2s, g.float(), w4s, b4s, alpha, As)  # f32
    operand = dx3s.to(dtype).float()
    dx = torch.matmul(operand, w3.float().t())
    dw3 = torch.einsum("ntvi,ntvo->io", x.float(), operand)
    return dx.to(dtype), dw3.to(dtype), dx3s.sum(dim=(0, 1, 2)).to(dtype)


def _kernels(device):
    """(forward, x3 gradient, parameter gradients) for tensors on `device`:
    the forward is the custom op `unit_ctr_gc_op` on both; the gradients are
    the plain versions on the CPU, the CUDA kernels (which raise on what
    they do not take; there is no fallback) on a CUDA device."""
    if device.type == "cpu":
        return unit_ctr_gc_op, unit_ctr_gc_dx3_plain, unit_ctr_gc_param_grads_plain
    if device.type == "cuda":
        from .cuda import ctr_gc

        return (unit_ctr_gc_op, ctr_gc.unit_ctr_gc_bwd_dx3,
                ctr_gc.unit_ctr_gc_bwd_param)
    raise NotImplementedError(f"unit_ctr_gc on device {device}")


class UnitCtrGc(torch.autograd.Function):
    """The unit op with its gradient (counterpart of the JAX package's
    custom_vjp `_unit_ctr_gc_pallas`, ops/aggregation.py:106-130): K1
    forward, K2 and K3 backward on a CUDA device, their plain versions on the
    CPU. Saves the inputs, never M. Its gradients come in the primal dtypes
    (bf16 for bf16 activations, f32 for the parameters). Its backward is
    not itself differentiable (the kernels' outputs have no graph), so a
    second-order gradient through it raises on both devices."""

    @staticmethod
    def forward(ctx, x1s, x2s, x3s, w4s, b4s, alpha, As):
        ctx.save_for_backward(x1s, x2s, x3s, w4s, b4s, alpha, As)
        return _kernels(x3s.device)[0](x1s, x2s, x3s, w4s, b4s, alpha, As)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x1s, x2s, x3s, w4s, b4s, alpha, As = ctx.saved_tensors
        need = ctx.needs_input_grad
        _, dx3_fn, param_fn = _kernels(x3s.device)
        g = g.contiguous()
        dx3s = dx3_fn(x1s, x2s, g, w4s, b4s, alpha, As) if need[2] else None
        dx1s = dx2s = dw4s = db4s = dalpha = dAs = None
        if any(need[i] for i in (0, 1, 3, 4, 5, 6)):
            dx1s, dx2s, dw4s, db4s, dalpha, dAs = param_fn(
                x1s, x2s, g, x3s, w4s, b4s, alpha)
        grads = (dx1s, dx2s, dx3s, dw4s, db4s, dalpha, dAs)
        return tuple(d if n else None for d, n in zip(grads, need))


def unit_ctr_gc(x1s, x2s, x3s, w4s, b4s, alpha, As):
    """The unit op through `UnitCtrGc`, dispatched on the device of x3s: a
    CPU tensor takes the plain versions, a CUDA tensor launches the CUDA
    kernels (which raise on what they do not take; there is no fallback)."""
    return UnitCtrGc.apply(x1s, x2s, x3s, w4s, b4s, alpha, As)


def conv3_matmul(x, w3, b3):
    """The packed conv3 1x1 as a matmul: x (N,T,V,Cin) @ w3 (Cin,S*C) + b3."""
    return torch.matmul(x, w3) + b3


def _conv3_kernel(device):
    """K6 for tensors on `device`: its plain version on the CPU, the CUDA
    kernel (which raises on what it does not take) on a CUDA device."""
    if device.type == "cpu":
        return unit_ctr_gc_bwd_conv3_plain
    if device.type == "cuda":
        from .cuda import ctr_gc

        return ctr_gc.unit_ctr_gc_bwd_conv3
    raise NotImplementedError(f"unit_ctr_gc_conv3 on device {device}")


class UnitCtrGcConv3(torch.autograd.Function):
    """conv3 and the unit op with one gradient (counterpart of the JAX
    package's custom_vjp `_unit_ctr_gc_conv3_pallas`, ops/aggregation.py:
    214-243): forward conv3_matmul then K1; backward K6 for (dx, dw3, db3)
    and K3 for the rest, on a CUDA device; their plain versions on the CPU.
    Saves x and x3s, never the x3 gradient or M. Once differentiable, as
    `UnitCtrGc`."""

    @staticmethod
    def forward(ctx, x, w3, b3, x1s, x2s, w4s, b4s, alpha, As):
        x3s = conv3_matmul(x, w3, b3)
        ctx.save_for_backward(x, w3, x1s, x2s, x3s, w4s, b4s, alpha, As)
        return _kernels(x3s.device)[0](x1s, x2s, x3s, w4s, b4s, alpha, As)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w3, x1s, x2s, x3s, w4s, b4s, alpha, As = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        grads = [None] * 9
        if any(need[:3]):
            grads[:3] = _conv3_kernel(g.device)(x1s, x2s, g, x, w3, w4s, b4s,
                                                alpha, As)
        if any(need[3:]):
            grads[3:] = _kernels(g.device)[2](x1s, x2s, g, x3s, w4s, b4s, alpha)
        return tuple(d if n else None for d, n in zip(grads, need))


def unit_ctr_gc_conv3(x, w3, b3, x1s, x2s, w4s, b4s, alpha, As):
    """conv3 and the unit op: out = unit_ctr_gc(conv3_matmul(x, w3, b3), ...)
    (counterpart of the JAX package's `unit_ctr_gc_conv3`, ops/aggregation.py:
    246-284). x (N,T,V,Cin); w3 (Cin,S*C); b3 (S*C,); the rest as
    `unit_ctr_gc`. With the JAX package's switch TAMGCN_FUSE_CONV3=1, read
    here and nowhere else, and where the JAX package takes its fused kernel
    (C >= 128, S*C >= 384, V <= 32) it takes `UnitCtrGcConv3` (K6 in the
    backward on the card, in f32 or bf16); everywhere else conv3_matmul +
    `unit_ctr_gc`. The device of the tensors picks kernels or plain
    versions in either case."""
    S, V = x1s.shape[1], x1s.shape[2]
    C = w3.shape[-1] // S
    fuse = os.environ.get("TAMGCN_FUSE_CONV3", "0") == "1"
    if fuse and C >= 128 and S * C >= 384 and V <= 32:
        return UnitCtrGcConv3.apply(x, w3, b3, x1s, x2s, w4s, b4s, alpha, As)
    return unit_ctr_gc(x1s, x2s, conv3_matmul(x, w3, b3), w4s, b4s, alpha, As)


def _fused_bf16(x1, x2, x3):
    """Whether the single-subset op takes K4's bf16 form: x1, x2 and x3 all
    bfloat16 (True) or none of them (False); raises on a mix."""
    bf16 = [t.dtype == torch.bfloat16 for t in (x1, x2, x3)]
    if any(bf16) and not all(bf16):
        raise TypeError(
            f"x1, x2 and x3 are {x1.dtype}, {x2.dtype} and {x3.dtype}: the single-subset "
            "op takes them all in bfloat16 (K4's bf16 form) or none of them")
    return all(bf16)


def ctr_gc_fused_adjacency(x1, x2, w4, b4, alpha, A):
    """M of the single-subset op: ctr_gc_dynamic_adjacency, and on bfloat16
    x1/x2 K4's bf16 form, as the JAX K4 computes on bf16 operands: the
    difference and the tanh each rounded to bf16, then w4, b4, alpha and A in
    f32 -> (N,U,V,C) float32."""
    if x1.dtype != torch.bfloat16:
        return ctr_gc_dynamic_adjacency(x1, x2, w4, b4, alpha, A)
    diff = (x1.float()[:, :, None, :] - x2.float()[:, None, :, :]).bfloat16()
    d = torch.tanh(diff.float()).bfloat16().float()  # (N, U, V, R)
    m = torch.matmul(d, w4)
    if b4 is not None:
        m = m + b4
    return m * alpha + A[None, :, :, None]


def ctr_gc_fused_plain(x1, x2, x3, w4, b4, alpha, A):
    """Plain single-subset CTR-GC refine + aggregate (counterpart of
    `ctr_gc_fused_xla`): x1/x2 (N,V,R); x3 (N,T,V,C); w4 (R,C); b4 (C,) or
    None; alpha (1,); A (V,V) -> (N,T,V,C). On bfloat16 x1, x2 and x3 (f32
    parameters) the plain version of K4's bf16 form: M of
    ctr_gc_fused_adjacency, the aggregation in f32, the output float32."""
    m = ctr_gc_fused_adjacency(x1, x2, w4, b4, alpha, A)
    return ctr_gc_aggregate(m, x3.float() if _fused_bf16(x1, x2, x3) else x3)


def ctr_gc_fused_dx3_plain(x1, x2, g, w4, b4, alpha, A):
    """Plain version of the single-subset op's x3 gradient (the JAX K4 with
    `transpose_m`): dx3[n,t,v,c] = sum_u M[n,u,v,c] g[n,t,u,c], with M of
    ctr_gc_fused_adjacency, in the dtype of g (float32 for bf16 x1/x2)."""
    return torch.einsum("nuvc,ntuc->ntvc", ctr_gc_fused_adjacency(x1, x2, w4, b4, alpha, A), g)


def _fused_kernels(device, bf16):
    """(forward, x3 gradient) of the single-subset op on `device`: K4's bf16
    form (ctr_gc_fused_bf16, ctr_gc_fused_t_bf16) or, in f32, K1 and K2 at
    S = 1 on a CUDA device; their plain versions on the CPU."""
    if bf16 and device.type == "cuda":
        from .cuda import ctr_gc

        return ctr_gc.ctr_gc_fused_bf16, ctr_gc.ctr_gc_fused_t_bf16
    if bf16 and device.type == "cpu":
        return ctr_gc_fused_plain, ctr_gc_fused_dx3_plain
    fwd, dx3, _ = _kernels(device)

    def forward(x1, x2, x3, w4, b4, alpha, A):
        return fwd(x1[:, None], x2[:, None], x3, w4[None], b4[None], alpha, A[None])

    def x3_gradient(x1, x2, g, w4, b4, alpha, A):
        return dx3(x1[:, None], x2[:, None], g, w4[None], b4[None], alpha, A[None])

    return forward, x3_gradient


class CtrGcFused(torch.autograd.Function):
    """The single-subset op with its gradient (counterpart of the JAX
    package's custom_vjp `ctr_gc_fused_pallas`, ops/pallas/ctr_gc.py:193-231,
    whose kernel is K4): in f32 the forward is the unit op at S = 1 (K1 on a
    CUDA device), the x3 gradient its x3 gradient at S = 1 (K2; the JAX
    kernel's `transpose_m`), both on views of the operands; on bf16 x1, x2
    and x3 both are K4's bf16 form (float32 output, the x3 gradient from the
    f32 g, handed back in bf16). A zero b4 stands in where b4 is None. The
    other gradients are plain PyTorch on both devices, as the JAX `_bwd`
    computes them outside its kernel (in bf16 with its dtypes: D in bf16, 1
    - D^2 rounded to bf16, dm and the products f32), each in its primal's
    dtype, which is the JAX XLA path's (the JAX Pallas backward hands back
    f32 for bf16 primals and fails there). Once differentiable."""

    @staticmethod
    def forward(ctx, x1, x2, x3, w4, b4, alpha, A):
        ctx.has_b4 = b4 is not None
        ctx.bf16 = _fused_bf16(x1, x2, x3)
        b4v = b4 if ctx.has_b4 else w4.new_zeros(x3.shape[-1])
        ctx.save_for_backward(x1, x2, x3, w4, b4v, alpha, A)
        return _fused_kernels(x3.device, ctx.bf16)[0](x1, x2, x3, w4, b4v, alpha, A)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x1, x2, x3, w4, b4v, alpha, A = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        dx3 = None
        if need[2]:
            dx3 = _fused_kernels(g.device, ctx.bf16)[1](x1, x2, g, w4, b4v, alpha,
                                                        A).to(x3.dtype)
        dx1 = dx2 = dw4 = db4 = dalpha = dA = None
        if any(need[i] for i in (0, 1, 3, 4, 5, 6)):
            dm = torch.einsum("ntuc,ntvc->nuvc", g, x3.to(g.dtype))
            # D and 1 - D^2 in the dtype of x1 and x2 (rounded in bf16, as _bwd
            # computes them), the rest in the dtype of g
            d = torch.tanh(x1[:, :, None, :] - x2[:, None, :, :])  # (N,U,V,R)
            d_sq = (1 - d * d).to(g.dtype)
            d = d.to(g.dtype)
            dA = dm.sum(dim=(0, 3))
            dp = dm * alpha  # the gradient of P = D @ w4 + b4
            dalpha = (dm * (torch.matmul(d, w4) + b4v)).sum().reshape(alpha.shape)
            db4 = dp.sum(dim=(0, 1, 2)) if ctx.has_b4 else None
            dw4 = torch.einsum("nuvr,nuvc->rc", d, dp)
            dpre = torch.matmul(dp, w4.t()) * d_sq
            dx1, dx2 = dpre.sum(dim=2).to(x1.dtype), (-dpre.sum(dim=1)).to(x2.dtype)
        grads = (dx1, dx2, dx3, dw4, db4, dalpha, dA)
        return tuple(t if n else None for t, n in zip(grads, need))


def ctr_gc_fused(x1, x2, x3, w4, b4, alpha, A):
    """The single-subset op through `CtrGcFused`, dispatched on the device of
    x3 (counterpart of the JAX package's `ctr_gc_fused`, ops/aggregation.py:
    287-314): a CPU tensor takes the plain versions, a CUDA tensor K1 and K2
    (f32) or K4's bf16 form (bf16 x1, x2, x3), which raise outside their
    limits (R <= 32, C % 4 == 0, V as K1 takes it); there is no fallback."""
    return CtrGcFused.apply(x1, x2, x3, w4, b4, alpha, A)


def stgcn_aggregate(x, A):
    """out[n,t,w,c] = sum_{k,v} x[n,t,v,k,c] * A[k,v,w].

    ST-GCN's 3-partition spatial aggregation (reference models/stgcn.py:62,
    'nkctv,kvw->nctw'), in NTVC layout with the partition axis k next to the
    channels; counterpart of tamgcn_tpu/ops/aggregation.py:stgcn_aggregate.
    Computed and returned in the wider of the two dtypes and float32 (a
    bf16 x with an f32 A sums in f32, as the JAX einsum's
    preferred_element_type)."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, A.dtype), torch.float32)
    return torch.einsum("ntvkc,kvw->ntwc", x.to(dtype), A.to(dtype))
