"""Launch ranks on this host, each a process of its own, and collect what
each returns.

    results = run_ranks("package.module:function", n, kwargs, timeout=300)

starts n processes (`python -m tamgcn_tpu_torch.parallel.launch ...`), each
of which joins a process group over tcp://127.0.0.1:<free port> (the
backend `kwargs["backend"]`, gloo by default, with `timeout_s` for every
collective) and calls ``function(mesh_rank=r, world=n, **kwargs)``; what it
returns (anything torch.save takes) comes back in rank order. The parent
waits at most `timeout` seconds; then, or as soon as one rank fails, it
kills every rank and raises with the tail of each rank's output. The
dry run (serving.py:dryrun_multichip) and the CPU tests launch their ranks
through it; `python -m torch.distributed.run` launches the CLI's, and
`run_command` runs such a launcher with the same kill at its timeout.
"""
from __future__ import annotations

import datetime
import importlib
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_command(cmd, timeout: float, env: dict | None = None):
    """(exit code, stderr) of `cmd` run from the repo in a session of its
    own; at the timeout the whole session (a launcher and its ranks) is
    killed and the code is -9."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        return -9, f"timed out after {timeout} s\n{err}"
    return proc.returncode, err


def run_ranks(target: str, n: int, kwargs: dict | None = None, timeout: float = 300,
              env: dict | None = None) -> list:
    """Run ``target(mesh_rank=r, world=n, **kwargs)`` in n processes; their
    return values in rank order."""
    kwargs = dict(kwargs or {})
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="tamgcn_ranks_") as tmp:
        args = os.path.join(tmp, "kwargs.pt")
        torch.save(kwargs, args)
        child_env = dict(os.environ, **(env or {}))
        child_env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tamgcn_tpu_torch.parallel.launch", target, str(r),
             str(n), str(port), args, tmp],
            cwd=REPO, env=child_env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    failed = f"timed out after {timeout} s"
                    break
                if any(p.poll() not in (None, 0) for p in procs):
                    failed = "a rank failed"
                    break
                time.sleep(0.05)
            if failed is None and any(p.returncode for p in procs):
                failed = "a rank failed"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed:
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                             f"{log.read()[-4000:]}")
            raise RuntimeError(f"{target} on {n} ranks: {failed}\n" + "\n".join(tails))
        for log in logs:
            log.close()
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(n)]


def _main(target, rank, world, port, args, out_dir) -> None:
    import torch.distributed as dist

    kwargs = torch.load(args, weights_only=False)
    dist.init_process_group(
        kwargs.pop("backend", "gloo"), init_method=f"tcp://127.0.0.1:{port}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=kwargs.pop("timeout_s", 300)))
    module, name = target.split(":")
    try:
        result = getattr(importlib.import_module(module), name)(
            mesh_rank=rank, world=world, **kwargs)
        torch.save(result, os.path.join(out_dir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    target, rank, world, port, args, out_dir = sys.argv[1:7]
    _main(target, int(rank), int(world), int(port), args, out_dir)
