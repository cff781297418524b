"""The arithmetic of K3's bf16 form on the tensor cores
(csrc/unit_ctr_gc_bwd_param_bf16.cu), emulated on the CPU and held to the
plain version (ops/aggregation.py:unit_ctr_gc_param_grads_plain) at the card
test's tolerances (tests/test_torch_cuda.py:test_bf16_kernels_match_plain:
dx1s and dx2s within 2^-7 of their max |plain| and equal in all but 1% of
their elements; dw4s, db4s, dAs within rtol 1e-4 and atol 1e-4 * max|plain|;
dalpha within rtol 1e-3):

- dm = sum_t g x3s: exact products of bf16 values (bf16 mma.sync m16n8k16
  with f32 accumulation), summed in f32 a chunk of 16 frames at a time;
- P = dm^T D and DD = dm w4^T (f32 operands, mma.sync m16n8k8 TF32): each
  operand split into its TF32 part (round to nearest, ties away, 10 mantissa
  bits) and the remainder, which the tensor cores read truncated to TF32;
  the kernel takes three terms (lo*hi + hi*lo + hi*hi, 3xTF32).

Fewer terms are held too: two (the A operand, dm, rounded to TF32) and one
(both rounded) miss the tolerances at the deep NW-UCLA block, which is why
the kernel takes three. Runs in seconds; no JAX, no card.
"""
import pytest
import torch

from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc_param_grads_plain

K3_OUTPUTS = ("dx1s", "dx2s", "dw4s", "db4s", "dalpha", "dAs")
# the NW-UCLA CTR-GCN's blocks at batch 2 (l1-l4, l5, l6-l7, l8, l9-l10),
# and the card test's BF16_SHAPES with V <= 37
NUCLA = [(2, 52, 20, 64, 8), (2, 52, 20, 128, 8), (2, 26, 20, 128, 16),
         (2, 26, 20, 256, 16), (2, 13, 20, 256, 32)]
CARD = [(4, 13, 20, 256, 32), (4, 52, 20, 64, 8), (3, 9, 25, 128, 16), (2, 7, 37, 80, 10),
        (2, 13, 37, 80, 10)]
FRAMES = 16  # frames per chunk of the dm product


def _inputs(n, t, v, c, r, s=3, seed=0):
    """As tests/test_torch_cuda.py makes them: x1s, x2s, x3s, g in bf16, w4s,
    b4s, alpha f32."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(n, s, v, r), (n, s, v, r), (n, t, v, s * c), (s, r, c), (s, c)]
    scales = [1.0, 1.0, 1.0, 0.1, 0.1]
    x1s, x2s, x3s, w4s, b4s = (torch.randn(sh, generator=gen) * k
                               for sh, k in zip(shapes, scales))
    alpha = torch.rand(1, generator=gen) + 0.5
    g = torch.randn((n, t, v, c), generator=torch.Generator().manual_seed(9))
    return x1s.bfloat16(), x2s.bfloat16(), g.bfloat16(), x3s.bfloat16(), w4s, b4s, alpha


def tf32_round(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x truncated to TF32, as the tensor cores read an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, terms):
    """a @ b (f32) as the kernel's TF32 MMAs take it: with 3 terms lo*hi +
    hi*lo + hi*hi, with 2 hi*lo + hi*hi (a rounded to TF32), with 1 hi*hi.
    Each TF32 product is exact in f32; the sums are f32."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    out = torch.matmul(a_hi, b_hi)
    if terms >= 2:
        out = out + torch.matmul(a_hi, b_lo)
    if terms >= 3:
        out = out + torch.matmul(a_lo, b_hi)
    return out


def emulated(x1s, x2s, g, x3s, w4s, b4s, alpha, terms=3):
    """K3's outputs as the bf16 design computes them, per subset s."""
    S = x1s.shape[1]
    C = x3s.shape[-1] // S
    T = g.shape[1]
    gd, xd = g.double(), x3s.double()
    dx1s, dx2s, dw4s, db4s, dAs = [], [], [], [], []
    dalpha = torch.zeros_like(alpha)
    for s in range(S):
        dm = 0
        for t0 in range(0, T, FRAMES):
            chunk = torch.einsum("ntuc,ntvc->nuvc", gd[:, t0:t0 + FRAMES],
                                 xd[:, t0:t0 + FRAMES, :, s * C:(s + 1) * C])
            dm = dm + chunk.float()  # exact products, the chunk's sum in f32
        N, V = dm.shape[:2]
        d = torch.tanh(x1s[:, s, :, None, :].float() - x2s[:, s, None, :, :].float())
        R = d.shape[-1]
        pairs_dm = dm.reshape(N, V * V, C)
        pairs_d = d.reshape(N, V * V, R)
        p = tf32_product(pairs_dm.transpose(1, 2), pairs_d, terms).sum(0)  # (C, R)
        sum_dm = dm.sum(dim=(0, 1, 2))
        dAs.append(dm.sum(dim=(0, 3)))
        db4s.append(alpha * sum_dm)
        dw4s.append(alpha * p.t())
        dalpha = dalpha + (w4s[s] * p.t()).sum() + (b4s[s] * sum_dm).sum()
        dd = tf32_product(pairs_dm, w4s[s].t(), terms).reshape(N, V, V, R)
        dpre = alpha * dd * (1 - d * d)
        dx1s.append(dpre.sum(dim=2))
        dx2s.append(-dpre.sum(dim=1))
    return (torch.stack(dx1s, dim=1).bfloat16(), torch.stack(dx2s, dim=1).bfloat16(),
            torch.stack(dw4s), torch.stack(db4s), dalpha, torch.stack(dAs))


def misses(got, want):
    """The outputs of K3 that miss the card test's tolerances."""
    out = []
    for name, a, w in zip(K3_OUTPUTS, got, want):
        if name in ("dx1s", "dx2s"):
            diff = a.float() - w.float()
            ok = (diff.abs().max() <= 2 ** -7 * w.float().abs().max()
                  and (diff != 0).float().mean() <= 0.01)
        elif name == "dalpha":
            ok = torch.allclose(a, w, rtol=1e-3, atol=0.0)
        else:
            ok = torch.allclose(a, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())
        if not ok:
            out.append(name)
    return out


@pytest.mark.parametrize("shape", NUCLA + CARD,
                         ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_three_tf32_terms_keep_the_card_tolerances(shape):
    args = _inputs(*shape)
    want = unit_ctr_gc_param_grads_plain(*args)
    assert misses(emulated(*args, terms=3), want) == []


@pytest.mark.parametrize("terms", [1, 2])
def test_fewer_tf32_terms_miss_them(terms):
    args = _inputs(*NUCLA[-1])
    want = unit_ctr_gc_param_grads_plain(*args)
    assert misses(emulated(*args, terms=terms), want)


def test_the_split_rounds_and_truncates_to_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12])
    # ties round away from zero; below the tie, down
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0]
    assert tf32_trunc(x).tolist() == [1.0, 1.0 + 2 ** -10, -1.0, 1.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    hi = tf32_round(y)
    assert ((y - hi).abs() <= hi.abs() * 2 ** -11).all()
