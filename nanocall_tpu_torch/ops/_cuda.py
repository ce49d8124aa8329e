"""Build and bind the hand-written CUDA kernels of `nanocall_tpu_torch/csrc`.

The sources are compiled by nvcc at first use into one shared library with
a plain C interface under `build/nanocall_tpu_torch/` of the checkout, and
loaded with ctypes.  The library's name carries a hash of the sources and
flags, so a stale build is never loaded.  A failed build raises: there is no
fallback to the plain PyTorch versions for CUDA tensors.

Flags: sm_90a (Hopper), and -fmad=false so that every float operation of a
kernel rounds on its own, as each elementwise PyTorch op does; that keeps
the kernels bit-identical to their plain versions on the same card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
SOURCES = ("viterbi_forward.cu", "viterbi_traceback.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "nanocall_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: seconds the last build took in this process (0.0 when nothing was built)
build_seconds = 0.0
#: nvcc's output of the last build (ptxas registers / spills per kernel)
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of nanocall_tpu_torch are built "
            "from source at first use and need the CUDA toolkit")
    return path


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libnc_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0


def load():
    """The kernel library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nc_viterbi_forward.restype = ci
        lib.nc_viterbi_forward.argtypes = (
            [vp] * 4 + [ci, ci] + [vp] * 9 + [cf, cf] + [vp, vp] + [ci, vp])
        lib.nc_viterbi_traceback.restype = ci
        lib.nc_viterbi_traceback.argtypes = (
            [vp] * 3 + [ci, ci, ci] + [vp] * 3 + [ci, vp])
        lib.nc_error_string.restype = ctypes.c_char_p
        lib.nc_error_string.argtypes = [ci]
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = _lib.nc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
