"""The port's trainer on a grid of ranks, on the CPU.

  * `python -m torch.distributed.run --nproc_per_node 2 -m tamgcn_tpu_torch
    recognition --distributed true` on configs/nucla/smoke.yaml (base_channel
    8, one epoch): with the joint ring and the split head (--graph_partition
    ring --model_parallel 2) and with DP (each rank its shard of the
    dataset). Rank 0 writes the checkpoints (full tensors) and the scores; a
    single process's `--phase test` on the checkpoint gives the same scores;
    a resumed 2-rank run ends bit for bit where an unbroken one does;
  * a world its caller started (--distributed false: each rank loads every
    batch whole and takes its rows, the JAX trainer's one-process split)
    takes the single process's first step, and its scores (test batches
    padded to a multiple of the data size) are one process's on its
    checkpoint;
  * the loader's two sharding modes index for index against the JAX
    package's: the process shards of --distributed (tamgcn_tpu/data/loader.py
    process_index/process_count) and the split of each global batch over the
    data axis (tamgcn_tpu/parallel/mesh.py:shard_batch);
  * the flag values and combinations the JAX package rejects raise, naming
    the flag.
"""
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from tamgcn_tpu.data import Loader as JaxLoader
from tamgcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tamgcn_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tamgcn_tpu_torch.__main__ import main
from tamgcn_tpu_torch.data import Loader
from tamgcn_tpu_torch.parallel.launch import free_port, run_command, run_ranks
from tamgcn_tpu_torch.parallel.mesh import data_slice
from tamgcn_tpu_torch.parallel.sequence import shard_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "nucla", "smoke.yaml")
ENV = {"OMP_NUM_THREADS": "1"}


def _argv(work_dir, *extra):
    return ["recognition", "-c", SMOKE, "--use_gpu", "false", "--work_dir", str(work_dir),
            "--model_args", "base_channel=8", "--num_epoch", "1", "--num_worker", "1",
            "--print_log", "false", *extra]


def _torchrun(work_dir, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(free_port()), "-m", "tamgcn_tpu_torch",
           *_argv(work_dir, "--distributed", "true", *extra)]
    rc, err = run_command(cmd, timeout=240, env=dict(os.environ, **ENV))
    assert rc == 0, err[-4000:]


def _scores(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("extra", [("--graph_partition", "ring", "--model_parallel", "2"),
                                   ()], ids=["ring_tp_1x2", "dp_2x1"])
def test_two_rank_cli_checkpoint_loads_in_one_process(tmp_path, extra):
    _torchrun(tmp_path / "grid", *extra)
    grid = tmp_path / "grid"
    assert (grid / "checkpoints" / "best.pt").exists()
    ckpt = torch.load(grid / "checkpoints" / "epoch1.pt", weights_only=True)
    assert ckpt["model"]["fc.weight"].shape == (10, 32)  # the head's shards gathered
    assert ckpt["optimizer"]["state"][len(ckpt["optimizer"]["state"]) - 2][
        "momentum_buffer"].shape == (10, 32)
    with open(grid / "log.txt") as f:
        log = f.read()
    assert "backend gloo, rank devices ['cpu', 'cpu']" in log
    assert main(_argv(tmp_path / "one", "--phase", "test", "--weights",
                      str(grid / "checkpoints" / "best.pt"), "--save_result", "true")) == 0
    want = _scores(grid / "test_result_epoch1.pkl")
    got = _scores(tmp_path / "one" / "test_result.pkl")
    assert sorted(got) == sorted(want) and len(got) == 64
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * top)


def test_two_rank_resume_draws_the_unbroken_run(tmp_path):
    """--resume on the grid (the joint ring with the split head): each rank
    loads the full checkpoint and slices its shards, of the weights and of
    the momentum; one epoch, then a resumed second, ends bit for bit where
    two unbroken epochs do."""
    extra = ("--graph_partition", "ring", "--model_parallel", "2", "--save_interval", "1")
    _torchrun(tmp_path / "unbroken", *extra, "--num_epoch", "2")
    _torchrun(tmp_path / "resumed", *extra)
    _torchrun(tmp_path / "resumed", *extra, "--num_epoch", "2", "--resume", "true")
    want, got = (torch.load(tmp_path / d / "checkpoints" / "epoch2.pt", weights_only=True)
                 for d in ("unbroken", "resumed"))
    assert got["step"] == want["step"] == 16
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, entry in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][i]["momentum_buffer"],
                           entry["momentum_buffer"]), i


def _first_loss(log):
    return float(next(l for l in open(log) if "Iter 0/" in l).split("loss: ")[1].split()[0])


def test_a_world_started_by_its_caller_steps_and_scores_as_one_process(tmp_path):
    """Each rank loads every batch whole and takes its rows. The first
    step's loss is the single process's; later steps drift apart in f32 as
    two single-process f32 runs with another sum order do (the f64 step is
    held to JAX in tests/test_torch_parallel_train.py). The test batches
    (13, the tail 12) are padded by tiling to a multiple of 2 and the
    padded rows dropped: one process's test phase on the grid's checkpoint
    gives the grid's scores."""
    extra = ("--test_batch_size", "13", "--log_interval", "1", "--print_log", "false")
    assert run_ranks("tests._torch_dist_worker:cli", 2,
                     {"argv": _argv(tmp_path / "grid", *extra)},
                     timeout=240, env=ENV) == [0, 0]
    assert main(_argv(tmp_path / "one", *extra)) == 0
    assert _first_loss(tmp_path / "grid" / "log.txt") == pytest.approx(
        _first_loss(tmp_path / "one" / "log.txt"), rel=1e-5)
    assert main(_argv(tmp_path / "test", "--phase", "test", "--test_batch_size", "13",
                      "--weights", str(tmp_path / "grid" / "checkpoints" / "best.pt"),
                      "--save_result", "true")) == 0
    want = _scores(tmp_path / "grid" / "test_result_epoch1.pkl")
    got = _scores(tmp_path / "test" / "test_result.pkl")
    assert sorted(got) == sorted(want) and len(got) == 64
    top = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * top)


class _Indices:
    """A dataset whose samples are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i]), i % 10, i


@pytest.mark.parametrize("processes", [2, 4])
def test_loader_process_shards_match_jax(processes):
    for p in range(processes):
        kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=5, num_workers=1,
                  process_index=p, process_count=processes)
        ours, ref = Loader(_Indices(70), **kw), JaxLoader(_Indices(70), **kw)
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = [b[-1] for b in ours], [b[-1] for b in ref]
            assert len(got) == len(want) == len(ours) == 70 // processes // (8 // processes)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_batch_split_over_the_data_axis_matches_jax():
    import types

    x = np.arange(16 * 3).reshape(16, 3)
    for d in (2, 4, 8):
        mesh = jax_make_mesh(d, 1, devices=jax.devices()[:d])
        shards = sorted(jax_shard_batch(mesh, x).addressable_shards,
                        key=lambda s: s.index[0].start)
        for i, shard in enumerate(shards):
            grid = types.SimpleNamespace(shape={"data": d, "model": 1}, data_index=i)
            np.testing.assert_array_equal(x[data_slice(16, grid)], np.asarray(shard.data))


@pytest.mark.parametrize("extra,error,match", [
    (("--sequence_parallel", "true", "--graph_partition", "ring"), ValueError,
     "--sequence_parallel and --graph_partition are mutually exclusive"),
    (("--sequence_parallel", "true", "--fast_eval", "true"), ValueError,
     "--fast_eval and --sequence_parallel are mutually exclusive"),
    (("--model_parallel", "2"), ValueError, "model_parallel=2 must divide 1 ranks"),
    (("--model_parallel", "0"), ValueError, "model_parallel=0"),
    (("--data_parallel", "2"), ValueError, "data_parallel"),
    (("--distributed", "true"), RuntimeError, "--distributed true needs the launcher"),
    (("--use_pallas", "true"), NotImplementedError, "--use_pallas"),
], ids=["sp_and_ring", "sp_and_fast_eval", "model_parallel", "model_parallel_0",
        "data_parallel", "distributed", "use_pallas"])
def test_rejected_flags_name_themselves(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        main(_argv(tmp_path, *extra))


def test_sequence_parallel_needs_a_model_axis_that_divides_T():
    import types

    grid = types.SimpleNamespace(model=types.SimpleNamespace(size=3, rank=0))
    with pytest.raises(ValueError, match="T=52 is not divisible by the 'model' mesh axis"):
        shard_time(np.zeros((2, 3, 52, 20, 1)), grid)
    grid.model.size, grid.model.rank = 4, 1
    clips = np.arange(52)[None, None, :, None, None] + np.zeros((2, 3, 1, 20, 1))
    np.testing.assert_array_equal(shard_time(clips, grid)[0, 0, :, 0, 0], np.arange(13, 26))
    flat = np.arange(52)[None, :, None] + np.zeros((2, 1, 60))  # (N, T, V*C)
    np.testing.assert_array_equal(shard_time(flat, grid)[0, :, 0], np.arange(13, 26))
