"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel against its plain PyTorch version on the same inputs, f32 with
TF32 off, within rtol 1e-5 and atol 1e-5 * max|plain| (the sum order
differs); the wrapper's checks and its launch count; and a small CTR-GCN on
the card against the same model on the CPU. This file imports no JAX, so it
runs where the port runs.
"""
import pytest
import torch

from tamgcn_tpu_torch.models import create_ctrgcn_nucla
from tamgcn_tpu_torch.ops.aggregation import unit_ctr_gc, unit_ctr_gc_plain
from tamgcn_tpu_torch.ops.cuda import ctr_gc

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n, t, v, c, r, device, s=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(n, s, v, r), (n, s, v, r), (n, t, v, s * c), (s, r, c), (s, c)]
    scales = [1.0, 1.0, 1.0, 0.1, 0.1]
    args = [torch.randn(sh, generator=g) * k for sh, k in zip(shapes, scales)]
    args += [torch.rand(1, generator=g) + 0.5, torch.rand((s, v, v), generator=g)]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("shape", [
    (2, 16, 20, 64, 8), (2, 13, 20, 256, 32), (3, 9, 25, 128, 16),
    (1, 7, 20, 80, 10), (2, 5, 20, 4, 3), (2, 6, 28, 64, 32),
], ids=lambda s: "N{}-T{}-V{}-C{}-R{}".format(*s))
def test_unit_kernel_matches_plain(device, shape):
    args = _inputs(*shape, device=device)
    before = ctr_gc.launches
    with torch.no_grad():
        got = unit_ctr_gc(*args)
        want = unit_ctr_gc_plain(*args)
    torch.cuda.synchronize()
    assert ctr_gc.launches == before + 1
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_unit_kernel_rejects_what_it_does_not_take(device):
    args = _inputs(1, 4, 20, 64, 8, device=device)
    with pytest.raises(TypeError, match="float32"):
        ctr_gc.unit_ctr_gc_fwd(*[a.double() for a in args])
    bad = list(args)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ctr_gc.unit_ctr_gc_fwd(*bad)
    with pytest.raises(ValueError, match="R <= 32"):
        ctr_gc.unit_ctr_gc_fwd(*_inputs(1, 4, 20, 64, 40, device=device))
    with pytest.raises(ValueError, match="shared memory"):
        ctr_gc.unit_ctr_gc_fwd(*_inputs(1, 2, 64, 64, 8, device=device))
    with pytest.raises(NotImplementedError, match="backward"):
        ctr_gc.unit_ctr_gc_fwd(*[a.requires_grad_() for a in args])


def test_model_on_card_matches_cpu(device):
    model = create_ctrgcn_nucla(base_channel=16,
                                generator=torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        for blk in model.blocks:  # what hides the kernel at init
            blk.gcn1.alpha.fill_(0.5)
            blk.gcn1.bn.weight.fill_(1.0)
    x = torch.randn((4, 3, 52, 20, 1), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        before = ctr_gc.launches
        got = model.to(device)(x.to(device)).cpu()
    assert ctr_gc.launches == before + 10
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
