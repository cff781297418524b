"""Rank functions of the port's CPU tests of the parallel layer, torch only
(it imports neither JAX nor tamgcn_tpu): each runs in one of the k gloo
processes that tamgcn_tpu_torch.parallel.launch.run_ranks starts, and
returns what the pytest process compares with the JAX package
(`debug_nans_cli` and the sequence-parallel faults of `sp_fault` also run
on the card, in phase 16 of chip_smoke.py, which imports this file by its
path).

    run_ranks("tests._torch_dist_worker:ring_ops", k, {"cases": [...]})
    run_ranks("tamgcn_tpu_torch.parallel.drive:train_on_grid", k, {...})
"""
import torch

from tamgcn_tpu_torch.parallel import graph_parallel
from tamgcn_tpu_torch.parallel.mesh import make_mesh

# ring op name -> the port function
RING_OPS = {
    "ring_unit_ctr_gc": graph_parallel.ring_unit_ctr_gc,
    "ring_aggregate": graph_parallel.ring_aggregate,
    "ring_aggregate_stgcn": graph_parallel.ring_aggregate_stgcn,
}


def _quiet():
    torch.set_num_threads(1)
    # the oneDNN kernels of this CPU torch abort on some train-mode backwards
    torch.backends.mkldnn.enabled = False


def ring_ops(mesh_rank=0, world=1, cases=()):
    """Each case (op name, inputs, cotangent), numpy f64, through the ring
    over every rank (a (1, world) grid): the output and the VJP of every
    input."""
    _quiet()
    mesh = make_mesh(1, world)
    out = []
    for name, inputs, cotangent in cases:
        args = [torch.from_numpy(a).requires_grad_() for a in inputs]
        y = RING_OPS[name](*args, mesh.model)
        y.backward(torch.from_numpy(cotangent))
        out.append((y.detach().numpy(), [a.grad.numpy() for a in args]))
    return out


def cli(mesh_rank=0, world=1, argv=()):
    """`python -m tamgcn_tpu_torch` with `argv` on a rank of a world its
    launcher started (so --distributed false: each rank loads every batch
    whole and takes its rows); returns main's exit code."""
    _quiet()
    from tamgcn_tpu_torch.__main__ import main

    return main(list(argv))


def gradient_sum(mesh_rank=0, world=1, sequence_parallel=False):
    """GradientSum on a small CTR-GCN over a (1, world) grid, each rank's
    flat gradients filled with rank + 1: ({parameter: its gradient after the
    reduction}, the split parameters' names)."""
    _quiet()
    from tamgcn_tpu_torch.models import create_ctrgcn_nucla
    from tamgcn_tpu_torch.parallel.sharded import GradientSum, parallelize, sharded_dims
    from tamgcn_tpu_torch.train.packing import PackedTrainState

    mesh = make_mesh(1, world)
    net = create_ctrgcn_nucla(base_channel=8)
    parallelize(net, mesh, "none", sequence_parallel)
    state = PackedTrainState(net, "SGD", nesterov=True, weight_decay=1e-4, mesh=mesh)
    for g in state.grads:
        g.fill_(mesh_rank + 1)
    GradientSum(state, mesh, sequence_parallel)(state.grads)
    grads = {name: state.grads[g][o:o + n].clone()
             for name, (g, o, n) in zip(state.param_names, state.params.slots)}
    return grads, sorted(sharded_dims(net))


def sp_features(mesh_rank=0, world=1, weights=None, x=None, cot=None):
    """extract_feature of a CTR-GCN (base_channel 8, f64, train mode) with
    its frames split over a (1, world) grid (dense for one rank): (the
    features, the gradient of sum(features * cot) for this rank's input
    frames, {parameter: this rank's share of its gradient})."""
    _quiet()
    from tamgcn_tpu_torch.models import create_ctrgcn_nucla
    from tamgcn_tpu_torch.parallel.sequence import shard_time
    from tamgcn_tpu_torch.parallel.sharded import parallelize

    mesh = make_mesh(1, world)
    net = create_ctrgcn_nucla(base_channel=8).double()
    net.load_state_dict(weights)
    parallelize(net, mesh, "none", world > 1)
    net.train()
    xs = torch.from_numpy(shard_time(x, mesh) if world > 1 else x).requires_grad_()
    feat, _ = net.extract_feature(xs)
    (feat * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
    return feat.detach(), xs.grad, grads


def debug_nans_cli(mesh_rank=0, world=1, argv=()):
    """`python -m tamgcn_tpu_torch` with `argv` (--debug_nans true) on a rank
    of a world its launcher started, a NaN planted in the last frame of every
    synthetic clip: the FloatingPointError's message, or None where main
    returned."""
    _quiet()
    from unittest import mock

    import numpy as np

    from tamgcn_tpu_torch.__main__ import main
    from tamgcn_tpu_torch.data.synthetic import SyntheticSkeletonFeeder

    clean = SyntheticSkeletonFeeder.__getitem__

    def planted(self, index):
        data, label, i = clean(self, index)
        data = data.copy()
        data[:, -1] = np.nan
        return data, label, i

    with mock.patch.object(SyntheticSkeletonFeeder, "__getitem__", planted):
        try:
            main(list(argv))
        except FloatingPointError as e:
            return str(e)
    return None


def sp_fault(name):
    """The patch that plants a fault of sequence parallelism in this process:
    "halo_zeroed", every frame a window op reads outside the rank's own
    frames comes back as zeros (SequenceContext.window); "shares_averaged",
    the time-sharded parameters' gradient shares averaged over the model
    group instead of summed, and "replicated_summed", the replicated
    parameters' gradients summed instead of averaged (GradientSum)."""
    from unittest import mock

    from tamgcn_tpu_torch.parallel import sequence, sharded

    if name == "halo_zeroed":
        window = sequence.SequenceContext.window

        def zeroed(self, x, stride, span, pad, fill):
            out = window(self, x, stride, span, pad, fill)
            a, b = self.own()
            first = stride * -(-a // stride) - pad  # the clip's frame of out[:, 0]
            frame = torch.arange(first, first + out.shape[1], device=out.device)
            own = ((frame >= a) & (frame < b)).view(1, -1, *[1] * (out.ndim - 2))
            return torch.where(own, out, torch.zeros((), dtype=out.dtype, device=out.device))

        return mock.patch.object(sequence.SequenceContext, "window", zeroed)
    reduce = sharded.GradientSum.__call__
    views = {"shares_averaged": "summed", "replicated_summed": "averaged"}[name]

    def faulted(self, grads):
        reduce(self, grads)
        k = self.mesh.model.size
        for view in getattr(self, views):
            view.mul_(1.0 / k if views == "summed" else k)

    return mock.patch.object(sharded.GradientSum, "__call__", faulted)


def faulted_step(mesh_rank=0, world=1, fault="", spec=None):
    """parallel/drive.py:train_on_grid(**spec) on this rank with the fault
    sp_fault(fault) planted (and nothing else changed: the CPU switches of
    _quiet left as train_on_grid finds them)."""
    from tamgcn_tpu_torch.parallel.drive import train_on_grid

    with sp_fault(fault):
        return train_on_grid(mesh_rank, world, **spec)
