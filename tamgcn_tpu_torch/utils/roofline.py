"""Speed-of-light (roofline) bounds on an NVIDIA H100.

Counterpart of tamgcn_tpu/utils/roofline.py, with the H100 in place of the
TPU table. The bound of a call is the larger of two times: the bytes it
must move (each input read once, each output written once) over the card's
memory rate, and the operations it does (an FMA counts two) over the peak
rate for their type. The unit op's bounds take the activations' item size
(`act_bytes`: 4 in f32, 2 in bf16; the parameters and K3's parameter
gradients stay f32). Each product is held to the rate of the unit that runs
it on the card. In bf16, stage 1 of K1 and K2 (the (V*V, R) @ (R, C)
product that builds M) is a bf16 x bf16 product with f32 accumulation
(tamgcn_tpu/ops/pallas/ctr_gc.py:401-404), held to the bf16 tensor-core
peak, and their aggregation (an f32 M times a bf16 operand, exact in TF32:
two TF32 terms, csrc/unit_ctr_gc_whole.cuh and unit_ctr_gc_tiled.cuh) to
the TF32 peak over two. In f32 both designs of K1 and K2 run their products
on the tensor cores as 3xTF32 (three TF32 products per f32 product), so
the f32 work of K1 and K2, in either design since they compute the same
function, is held to the TF32 tensor-core peak over three: 165 TFLOP/s,
not the 67 TFLOP/s of the CUDA cores, which would read above what the
card can do. The f32 K3's sums stay at the f32 peak outside the tensor
cores, where its design runs them; K3's bf16 form runs dm = sum_t g x3s (a
bf16 x bf16 product) at the bf16 peak and P = D^T dm, DD = dm w4^T (f32
products) as 3xTF32 (csrc/unit_ctr_gc_bwd_param_bf16.cu). K5
(the whole eval block) and K6 (the x3 gradient through conv3) run their
1x1-conv products, most of their work, on the tensor cores as 3xTF32
(csrc/mma_tf32x3.cuh), and the rest of their work is K1's or K2's: all
their f32 FMAs are held to the same 165 TFLOP/s. The bf16 forms of K6 and
K4 hold each product to the rate of the unit that runs it: K6-bf16's two
1x1-conv products (bf16 x bf16, f32 accumulation, as the JAX kernel's
bf16 body takes them) and its stage 1 at the bf16 peak, its aggregation (an
f32 M times a bf16 g, exact in TF32) as two TF32 terms, db3's adds at the
3xTF32 rate; K4-bf16's stage 1 (a bf16 D, exact in TF32,
times an f32 w4) and its forward aggregation (an f32 M times a bf16 x3) as
two TF32 terms, at the TF32 peak over two (247.5 TFLOP/s), its transposed
aggregation (an f32 M times an f32 g) at the 3xTF32 rate. T1 (the eval
multi-scale TCN) runs its two dilated branches as implicit GEMMs on the
tensor cores as 3xTF32, so its FMAs are held to 165 TFLOP/s too; T2 (the
stage-2 aggregation from a given M) runs its FMAs on the CUDA cores, at 67.
The bf16 forms of K5 and T1 move 2-byte activations (K5's x, prefix and
pw; T1's prefix and output) and f32 parameters: K5-bf16's stage 1 and its
five 1x1-conv products are bf16 x bf16 products (the JAX kernel's bf16
body), at the bf16 peak, its aggregation (f32 M times the f32 x3) at the
3xTF32 rate; T1-bf16's branches multiply a bf16 prefix (exact in TF32) by
f32 weights, two TF32 terms, at the TF32 peak over two.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W limit: 80 GB
of HBM3 at 3.35 TB/s, 989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor
cores, 67 TFLOP/s f32 outside them. A card set below 700 W runs slower
under load; a roofline share is stated against these peaks with the card's
limit beside it.
"""
from __future__ import annotations

import math

HBM_BW = 3.35e12  # bytes/s
F32_FLOPS = 67e12  # FLOP/s, f32 outside the tensor cores
BF16_FLOPS = 989e12  # FLOP/s, bf16 on the tensor cores (f32 accumulation)
TF32X3_FLOPS = 495e12 / 3  # FLOP/s, f32 products on the tensor cores as 3xTF32
# FLOP/s, products of a bf16 value (exact in TF32) and an f32 value on the
# tensor cores as two TF32 terms
TF32X2_FLOPS = 495e12 / 2


def bound(elems: int, flops: int, *, itemsize: int = 4, bf16_flops: int = 0,
          f32_peak: float = F32_FLOPS, tf32x2_flops: int = 0):
    """(ms, 'bytes' | 'operations'): `elems` values of `itemsize` bytes over
    the memory rate, or `flops` over `f32_peak` (the f32 peak outside the
    tensor cores unless given) plus `bf16_flops` over the bf16 tensor-core
    peak plus `tf32x2_flops` over TF32X2_FLOPS, whichever is larger."""
    bytes_ms = itemsize * elems / HBM_BW * 1e3
    ops_ms = (flops / f32_peak + bf16_flops / BF16_FLOPS + tf32x2_flops / TF32X2_FLOPS) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _unit_bound(act_elems: int, param_elems: int, aggregation: int, stage1: int,
                act_bytes: int):
    """bound() of K1 or K2: act_elems activations of act_bytes bytes and
    param_elems f32 values; in bf16 the `stage1` FLOPs at the bf16 peak and
    the `aggregation` FLOPs as two TF32 terms, in f32 both at the 3xTF32
    rate."""
    nbytes = act_bytes * act_elems + 4 * param_elems
    if act_bytes == 2:
        return bound(nbytes, 0, itemsize=1, bf16_flops=stage1, tf32x2_flops=aggregation)
    return bound(nbytes, aggregation + stage1, itemsize=1, f32_peak=TF32X3_FLOPS)


def unit_ctr_gc_sol(n: int, t: int, v: int, c: int, r: int, s: int = 3, *,
                    act_bytes: int = 4):
    """The unit CTR-GC forward (K1): x1s, x2s, x3s, w4s, b4s, alpha, As in,
    (n,t,v,c) out; the FMAs of M (stage 1, v*v*r*c per sample and subset)
    and of the aggregation (stage 2, t*v*v*c), at the rates _unit_bound
    gives them. Returns bound()'s (ms, by)."""
    acts = 2 * n * s * v * r + n * t * v * s * c + n * t * v * c
    params = s * r * c + s * c + 1 + s * v * v
    return _unit_bound(acts, params, 2 * n * s * t * v * v * c, 2 * n * s * v * v * r * c,
                       act_bytes)


def unit_ctr_gc_dx3_sol(n: int, t: int, v: int, c: int, r: int, s: int = 3, *,
                        act_bytes: int = 4):
    """The unit op's x3 gradient (K2): x1s, x2s, g, w4s, b4s, alpha, As in,
    (n,t,v,s*c) out; the FMAs of M and of the aggregation, as K1's."""
    acts = 2 * n * s * v * r + n * t * v * c + n * t * v * s * c
    params = s * r * c + s * c + 1 + s * v * v
    return _unit_bound(acts, params, 2 * n * s * t * v * v * c, 2 * n * s * v * v * r * c,
                       act_bytes)


def unit_ctr_gc_param_sol(n: int, t: int, v: int, c: int, r: int, s: int = 3, *,
                          act_bytes: int = 4):
    """The unit op's parameter gradients (K3): g, x3s, x1s, x2s, w4s, b4s,
    alpha in; dx1s, dx2s, dw4s, db4s, dalpha, dAs out (the bytes of the JAX
    cost estimate, tamgcn_tpu/ops/pallas/ctr_gc.py:1360). FMAs: dm = sum_t
    g x3 (t*v*v*c per sample and subset), then D^T dm and dm w4^T (v*v*r*c
    each); dalpha reuses P = D^T dm as sum w4*P + b4*sum(dm), so it needs no
    third v*v*r*c product (the JAX estimate counts one). g, x3s, x1s, x2s,
    dx1s and dx2s are activations. In f32 every FMA at the f32 peak (the f32
    design's FFMA); in bf16 dm at the bf16 peak and D^T dm, dm w4^T at the
    3xTF32 rate (the bf16 design's tensor-core products). Returns bound()'s
    (ms, by)."""
    acts = n * t * v * c + n * t * v * s * c + 4 * n * s * v * r
    params = 2 * (s * r * c + s * c + 1) + s * v * v
    dm, p_dd = 2 * n * s * t * v * v * c, 4 * n * s * v * v * r * c
    nbytes = act_bytes * acts + 4 * params
    if act_bytes == 2:
        return bound(nbytes, p_dd, itemsize=1, bf16_flops=dm, f32_peak=TF32X3_FLOPS)
    return bound(nbytes, dm + p_dd, itemsize=1)


def ms_tcn_sol(n: int, t: int, v: int, bc: int, stride: int = 1, *, act_bytes: int = 4):
    """The eval multi-scale TCN (T1) on a prefix (n,t,v,3*bc): the prefix,
    w (2,5,bc,bc), b (2,bc) and the max-pool affine (2,bc) in, (n,ceil(t/
    stride),v,3*bc) out; per output frame and joint 2*5*bc*bc FMAs of the two
    dilated branches and, per max-pool output, two maxima and one FMA, all at
    the 3xTF32 rate: the branches' products, nearly all of the work, run on
    the tensor cores as 3xTF32 (csrc/ms_tcn.cu). With act_bytes=2 (the bf16
    form) the prefix and the output take 2 bytes a value, the parameters 4,
    and the work is held to two TF32 terms a product (a bf16 prefix value is
    exact in TF32)."""
    t_out = math.ceil(t / stride)
    rows = n * t_out * v
    acts = n * t * v * 3 * bc + rows * 3 * bc
    params = 2 * 5 * bc * bc + 4 * bc
    flops = 2 * rows * 2 * 5 * bc * bc + 4 * rows * bc
    if act_bytes == 2:
        return bound(2 * acts + 4 * params, 0, itemsize=1, tf32x2_flops=flops)
    return bound(acts + params, flops, f32_peak=TF32X3_FLOPS)


def stage2_sol(n: int, t: int, v: int, l: int, subsets: int = 1, *, itemsize: int = 4):
    """The stage-2 aggregation (T2) from a given M (v,v,l) on x3 (n,t,v,l):
    out (n,t,v,l), or (n,t,v,l/subsets) with the subset sum; v FMAs per
    output joint and channel. Returns bound()'s (ms, by)."""
    elems = v * v * l + n * t * v * l + n * t * v * (l // subsets)
    return bound(elems, 2 * n * t * v * v * l, itemsize=itemsize)


def unit_ctr_gc_bwd_conv3_sol(n: int, t: int, v: int, cin: int, c: int, r: int,
                              s: int = 3):
    """The x3 gradient through conv3's VJP (K6): x1s, x2s, g, x, w3, w4s,
    b4s, alpha, As in; dx, dw3, db3 out. FMAs of M and the aggregation (as
    K2), of dx = dx3s w3^T and dw3 = x^T dx3s (the JAX cost estimate,
    tamgcn_tpu/ops/pallas/ctr_gc.py:1475), and db3's adds; at the 3xTF32
    rate. Returns bound()'s (ms, by)."""
    elems = (2 * n * s * v * r + n * t * v * c + 2 * n * t * v * cin + 2 * cin * s * c
             + s * r * c + 2 * s * c + 1 + s * v * v)
    flops = (2 * n * s * (v * v * r * c + t * v * v * c) + 4 * n * t * v * s * c * cin
             + n * t * v * s * c)
    return bound(elems, flops, f32_peak=TF32X3_FLOPS)


def unit_ctr_gc_bwd_conv3_bf16_sol(n: int, t: int, v: int, cin: int, c: int, r: int,
                                   s: int = 3):
    """K6's bf16 form: x1s, x2s, g, x, w3 in and dx, dw3, db3 out in bf16,
    w4s, b4s, alpha, As in f32. Stage 1 and the products with w3 and x at
    the bf16 peak; the aggregation (an f32 M times a bf16 g) as two TF32
    terms; db3's adds at the 3xTF32 rate. Returns bound()'s (ms, by)."""
    acts = 2 * n * s * v * r + n * t * v * c + 2 * n * t * v * cin + 2 * cin * s * c + s * c
    params = s * r * c + s * c + 1 + s * v * v
    bf16_flops = 2 * n * s * v * v * r * c + 4 * n * t * v * s * c * cin
    return bound(2 * acts + 4 * params, n * t * v * s * c, itemsize=1, bf16_flops=bf16_flops,
                 f32_peak=TF32X3_FLOPS, tf32x2_flops=2 * n * s * t * v * v * c)


def ctr_gc_fused_bf16_sol(n: int, t: int, v: int, c: int, r: int):
    """K4's bf16 form on one forward and its transposed call (the x3
    gradient), as a CTRGC forward and backward makes them: x1, x2 (bf16)
    and w4, b4, alpha, A (f32) read by each, x3 (bf16) in and out (f32) of
    the forward, g in and dx3 out (f32) of the transpose. M of each call (a
    bf16 D times an f32 w4) and the forward's aggregation (an f32 M times a
    bf16 x3) as two TF32 terms, the transpose's aggregation at the 3xTF32
    rate. Returns bound()'s (ms, by)."""
    params = r * c + c + 1 + v * v
    call = 2 * (2 * n * v * r) + 4 * params
    nbytes = 2 * call + 2 * n * t * v * c + 4 * n * t * v * c + 8 * n * t * v * c
    stage1, aggregation = 2 * n * v * v * r * c, 2 * n * t * v * v * c
    return bound(nbytes, aggregation, itemsize=1, f32_peak=TF32X3_FLOPS,
                 tf32x2_flops=2 * stage1 + aggregation)


def gcn_tcn_block_sol(n: int, t: int, v: int, cin: int, c: int, r: int, s: int = 3, *,
                      act_bytes: int = 4):
    """The whole eval-mode block (K5) with P = 3c/4 and BC = c/4 as in the
    model and a folded down conv where cin != c: x read, prefix and pw
    written once, every weight read once; the FMAs of M, of the aggregation
    and of the five 1x1-conv products as the JAX cost estimate counts them
    (tamgcn_tpu/ops/pallas/gcn_tcn_block.py:263-266), at the 3xTF32 rate.
    With act_bytes=2 (the bf16 form) x, prefix and pw take 2 bytes a value
    and the rest 4, stage 1 and the 1x1-conv products are held to the bf16
    peak and the aggregation to the 3xTF32 rate. Returns bound()'s (ms,
    by)."""
    p, bc = 3 * c // 4, c // 4
    down = cin != c
    acts = n * t * v * (cin + p + bc)
    params = (2 * n * s * v * r + cin * s * c + s * c + s * r * c + s * c + 1 + s * v * v
              + 2 * c + c * c + c + c * p + p + c * bc + bc + (cin * c + c if down else 0))
    stage1, aggregation = 2 * n * s * v * v * r * c, 2 * n * s * t * v * v * c
    products = 2 * n * t * v * (cin * s * c + c * c + c * p + c * bc + (cin * c if down else 0))
    if act_bytes == 2:
        return bound(2 * acts + 4 * params, aggregation, itemsize=1,
                     bf16_flops=stage1 + products, f32_peak=TF32X3_FLOPS)
    return bound(acts + params, stage1 + aggregation + products, f32_peak=TF32X3_FLOPS)
