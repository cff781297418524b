"""Build the port's CUDA sources into shared libraries and load them.

Each source under tamgcn_tpu_torch/csrc/ has a plain C interface and is
compiled by `nvcc` for sm_90a into tamgcn_tpu_torch/_build/, under a name
keyed by a hash of the source, the headers beside it and the flags, at first
use; it is then loaded with ctypes. Nothing is compiled when a module is
imported, and a missing `nvcc` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# every kernel source of the port; chip_smoke.py builds them all at once
SOURCES = (
    "unit_ctr_gc_fwd.cu", "unit_ctr_gc_bwd_dx3.cu", "unit_ctr_gc_bwd_param.cu",
    "gcn_tcn_block.cu", "unit_ctr_gc_bwd_conv3.cu", "ms_tcn.cu",
    "stage2_aggregate.cu",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda; raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from tamgcn_tpu_torch/csrc at first use"
    )


def library_path(source: str) -> str:
    """Where the library of `source` is built: keyed by the source, the
    headers of csrc/ (which the sources include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _nvcc_command(source: str, target: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", target, os.path.join(CSRC, source)]


def build(sources=SOURCES) -> list[str]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns the library paths. Raises on a failed build
    with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for source in sources:
        target = library_path(source)
        if os.path.exists(target):
            continue
        # build beside the target and rename: a concurrent loader never
        # sees a half-written library
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            _nvcc_command(source, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((source, target, tmp, proc))
    failed = []
    for source, target, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{output}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [library_path(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            (path,) = build((source,))
            lib = _loaded[source] = ctypes.CDLL(path)
        return lib


def entry(source: str, name: str, argtypes, restype):
    """The C entry point `name` of `source`'s library, loaded at first use,
    with its argument and return types declared."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[name] = fn
    return fn
