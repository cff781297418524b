"""Native (C++) runtime: batched skeleton augmentation via ctypes.

Counterpart of tamgcn_tpu/runtime: `src/augment.cc` is the host-side
augmentation pipeline of the NW-UCLA feeder (centring, view rotation and
scale, min-max normalisation, resampling, the bone and motion modalities)
in C++ with OpenMP, bit for bit the numpy path's (it draws numpy's Philox
streams draw for draw). It is compiled with `g++ -O3 -march=native
-fopenmp` at first use into tamgcn_tpu_torch/_build/, under a name keyed by
a hash of the source, the flags and the instruction set `-march=native`
resolves to where it is built (so a library built on another CPU is never
loaded), and loaded with ctypes. Nothing is compiled at import; a missing
`g++` makes `available()` false and `load()` raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "augment.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
MODALITY = {"joint": 0, "bone": 1, "motion": 2}

_lock = threading.Lock()
_lib = None


def _native_target() -> bytes:
    """The compiler's version and what -march=native resolves to here."""
    proc = subprocess.run(["g++", "-march=native", "-E", "-v", "-"], input=b"",
                          capture_output=True, check=True)
    return b"\n".join(line for line in proc.stderr.splitlines()
                      if b"cc1" in line or line.startswith(b"gcc version"))


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(_native_target())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libtamgcn_augment-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output on a failed build."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found: the native augmentation core is built "
                           "from tamgcn_tpu_torch/runtime/src at first use")
    target = library_path()
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build beside the target and rename: a concurrent loader never sees
        # a half-written library
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.tamgcn_augment_batch.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # skeletons
                ctypes.POINTER(ctypes.c_int64),   # offsets
                ctypes.POINTER(ctypes.c_int64),   # indices
                ctypes.c_int,                     # batch
                ctypes.c_int,                     # V
                ctypes.c_int,                     # t_out
                ctypes.c_int,                     # train
                ctypes.c_int,                     # modality
                ctypes.c_uint64,                  # seed
                ctypes.c_uint64,                  # epoch
                ctypes.POINTER(ctypes.c_float),   # out
            ]
            lib.tamgcn_augment_batch.restype = None
            lib.tamgcn_version.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return False


def augment_batch(
    skeletons: list[np.ndarray],
    indices: np.ndarray,
    *,
    time_steps: int = 52,
    train: bool = False,
    modality: str = "joint",
    seed: int = 0,
    epoch: int = 0,
) -> np.ndarray:
    """Batched native augmentation.

    skeletons: list of (T_i, V, 3) float64 arrays (raw clips);
    indices: per-sample RNG stream ids (dataset indices);
    returns (B, 3, time_steps, V, 1) float32.
    """
    lib = load()
    batch = len(skeletons)
    V = skeletons[0].shape[1]
    lengths = np.array([s.shape[0] for s in skeletons], np.int64)
    offsets = np.zeros(batch + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.ascontiguousarray(
        np.concatenate([s.reshape(-1, V, 3) for s in skeletons]), np.float64
    )
    idx = np.ascontiguousarray(indices, np.int64)
    out = np.empty((batch, 3, time_steps, V), np.float32)
    lib.tamgcn_augment_batch(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        batch, V, time_steps, int(train), MODALITY[modality],
        seed, epoch,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[..., None]
