"""tamgcn_tpu_torch and chip_smoke.py stand alone: importing the package and
every submodule (the parallel layer's too) loads no JAX and nothing of
tamgcn_tpu, no source imports them (nor does tests/_torch_dist_worker.py,
whose rank functions run in processes of their own), and the CUDA sources
call no library kernel."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "tamgcn_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax", "tamgcn_tpu"}


def _forbidden(module: str) -> bool:
    # compare the root exactly: "tamgcn_tpu_torch".startswith("tamgcn_tpu")
    return module.split(".")[0] in FORBIDDEN_ROOTS


def test_forbidden_matches_module_roots_exactly():
    assert _forbidden("tamgcn_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("tamgcn_tpu_torch.ops") and not _forbidden("jaxtyping")


def test_import_loads_no_jax_and_no_tamgcn_tpu():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tamgcn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'modules': sorted(sys.modules)}))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tamgcn_tpu_torch.ops.cuda.ctr_gc" in out["imported"]
    assert "tamgcn_tpu_torch.__main__" in out["imported"]
    assert "tamgcn_tpu_torch.parallel.graph_parallel" in out["imported"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


# the port, chip_smoke.py and the rank functions of the parallel layer's CPU
# tests (they run in processes of their own, beside no JAX)
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "tests" / "_torch_dist_worker.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_tamgcn_tpu(path):
    assert [m for m in _imports(path) if _forbidden(m)] == []


def test_the_rank_worker_loads_no_jax():
    code = ("import json, sys\n"
            "import tests._torch_dist_worker\n"
            "import tamgcn_tpu_torch.parallel.drive, tamgcn_tpu_torch.serving\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [m for m in json.loads(proc.stdout.strip().splitlines()[-1]) if _forbidden(m)] == []


def test_cuda_sources_use_no_library_kernel():
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert sources
    for path in sources:
        text = path.read_text().lower()
        for lib in ("cublas", "cudnn"):
            assert lib not in text, f"{path.name} uses {lib}"
