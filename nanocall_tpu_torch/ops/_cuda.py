"""Build and bind the hand-written CUDA kernels of `nanocall_tpu_torch/csrc`.

The sources are compiled by nvcc at first use, one nvcc process per source
and all of them at once, then linked into one shared library with a plain C
interface under `build/nanocall_tpu_torch/` of the checkout, and loaded
with ctypes.  The library's name carries a hash of the sources, the shared
header and the flags, so a stale build is never loaded.  A failed build
raises: there is no fallback to the plain PyTorch versions for CUDA
tensors.

Flags: sm_90a (Hopper), and -fmad=false so that every float operation of a
kernel rounds on its own, as each elementwise PyTorch op does; that keeps
the kernels bit-identical to their plain versions on the same card.  K8
(fma_chain.cu) writes its FMAs as explicit __fmaf_rn, which the flag
leaves fused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
SOURCES = ("viterbi_forward.cu", "viterbi_traceback.cu", "fwbw_forward.cu",
           "em_backward.cu", "viterbi_generic.cu", "fwbw_generic.cu",
           "fwbw_generic_wave.cu", "fwbw_split.cu", "fwbw_backward.cu",
           "fwbw_backward_wave.cu", "fwbw_custom.cu", "fma_chain.cu",
           "reshape_copy.cu")
HEADERS = ("common.cuh", "beta_step.cuh", "resident_slots.cuh",
           "device_guard.cuh", "wave_exchange.cuh", "fwbw_wave_body.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "nanocall_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

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
    for name in (*SOURCES, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libnc_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> str:
    """Run the commands at once; their output, or raise if any failed."""
    cmds = list(cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return log


def _build(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    t0 = time.perf_counter()
    try:
        build_log = _run_all(
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs))
        build_log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    build_seconds = time.perf_counter() - t0


def load():
    """The kernel library, built on first call in this checkout.  Once it
    is loaded, a call returns it without taking the lock."""
    global _lib
    if _lib is not None:
        return _lib
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
        lib.nc_viterbi_forward_chunk.restype = ci
        lib.nc_viterbi_forward_chunk.argtypes = (
            [vp] * 4 + [ci] * 5 + [vp] * 10 + [cf, cf] + [vp, vp] + [ci, vp])
        lib.nc_viterbi_forward_wave.restype = ci
        lib.nc_viterbi_forward_wave.argtypes = (
            [vp] + [ci] * 8 + [cf, cf] + [ctypes.c_longlong, vp] + [ci, vp])
        lib.nc_viterbi_forward_wave_resident.restype = ci
        lib.nc_viterbi_forward_wave_resident.argtypes = [
            ci, ci, ci, ctypes.POINTER(ci)]
        lib.nc_viterbi_traceback_slices.restype = ci
        lib.nc_viterbi_traceback_slices.argtypes = (
            [vp] * 2 + [ci] * 6 + [vp] * 3 + [ci, vp])
        lib.nc_enable_peer_access.restype = ci
        lib.nc_enable_peer_access.argtypes = [ci, ci]
        lib.nc_viterbi_traceback_chunk.restype = ci
        lib.nc_viterbi_traceback_chunk.argtypes = (
            [vp] * 4 + [ci] * 4 + [vp] + [ci, vp])
        lib.nc_viterbi_traceback_chunk_states.restype = ci
        lib.nc_viterbi_traceback_chunk_states.argtypes = (
            [vp] * 4 + [ci] * 3 + [vp] + [ci, ci, vp])
        lib.nc_viterbi_traceback.restype = ci
        lib.nc_viterbi_traceback.argtypes = (
            [vp] * 3 + [ci, ci, ci] + [vp] * 3 + [ci, vp])
        lib.nc_fwbw_forward.restype = ci
        lib.nc_fwbw_forward.argtypes = (
            [vp] * 4 + [ci, ci] + [vp] * 10 + [cf, cf] + [vp, vp] + [ci, vp])
        lib.nc_fwbw_forward_wave.restype = ci
        lib.nc_fwbw_forward_wave.argtypes = (
            [vp] + [ci] * 9 + [cf, cf] + [ctypes.c_longlong, vp]
            + [ci, vp])
        lib.nc_fwbw_forward_wave_resident.restype = ci
        lib.nc_fwbw_forward_wave_resident.argtypes = [
            ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.nc_em_backward_wave.restype = ci
        lib.nc_em_backward_wave.argtypes = (
            [vp] + [ci] * 10 + [cf] + [ctypes.c_longlong, vp] + [ci, vp])
        lib.nc_em_backward_wave_resident.restype = ci
        lib.nc_em_backward_wave_resident.argtypes = [
            ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.nc_fwbw_backward_wave.restype = ci
        lib.nc_fwbw_backward_wave.argtypes = (
            [vp] + [ci] * 8 + [cf] + [ctypes.c_longlong, vp] + [ci, vp])
        lib.nc_fwbw_backward_wave_resident.restype = ci
        lib.nc_fwbw_backward_wave_resident.argtypes = [
            ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.nc_fwbw_generic_wave.restype = ci
        lib.nc_fwbw_generic_wave.argtypes = (
            [vp] + [ci] * 15 + [cf, cf] + [ctypes.c_longlong, vp]
            + [ci, vp])
        lib.nc_fwbw_generic_wave_resident.restype = ci
        lib.nc_fwbw_generic_wave_resident.argtypes = [
            ci] * 10 + [ctypes.POINTER(ci)]
        lib.nc_fwbw_split.restype = ci
        lib.nc_fwbw_split.argtypes = (
            [vp] + [ci] * 7 + [cf, cf] + [ci, vp])
        lib.nc_fwbw_split_clusters.restype = ci
        lib.nc_fwbw_split_clusters.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
        lib.nc_em_backward.restype = ci
        lib.nc_em_backward.argtypes = (
            [vp] * 4 + [ci, ci] + [vp] * 17 + [ci, ci, cf] + [vp] * 3
            + [ci, vp])
        lib.nc_viterbi_generic_forward.restype = ci
        lib.nc_viterbi_generic_forward.argtypes = (
            [vp] * 4 + [ci, ci, ci] + [vp] * 8 + [cf, cf] + [vp, vp]
            + [ci] + [ci, vp])
        lib.nc_viterbi_resident_forward.restype = ci
        lib.nc_viterbi_resident_forward.argtypes = (
            [vp] * 4 + [ci] * 4 + [vp] * 8 + [cf, cf] + [vp, vp]
            + [ci] + [ci, vp])
        lib.nc_viterbi_generic_wave.restype = ci
        lib.nc_viterbi_generic_wave.argtypes = (
            [vp] + [ci] * 13 + [cf, cf] + [ctypes.c_longlong, vp]
            + [ci, vp])
        lib.nc_viterbi_generic_wave_resident.restype = ci
        lib.nc_viterbi_generic_wave_resident.argtypes = [
            ci] * 8 + [ctypes.POINTER(ci)]
        lib.nc_viterbi_generic_traceback_slices.restype = ci
        lib.nc_viterbi_generic_traceback_slices.argtypes = (
            [vp] * 2 + [ci] * 6 + [vp, ci] + [vp] * 2 + [ci, vp])
        lib.nc_viterbi_generic_traceback.restype = ci
        lib.nc_viterbi_generic_traceback.argtypes = (
            [vp] * 3 + [ci, ci] + [vp] * 3 + [ci, vp])
        lib.nc_viterbi_generic_traceback_ring.restype = ci
        lib.nc_viterbi_generic_traceback_ring.argtypes = (
            [vp] * 3 + [ci, ci, ci] + [vp] * 3 + [ci, vp])
        lib.nc_fwbw_resident.restype = ci
        lib.nc_fwbw_resident.argtypes = (
            [vp] * 4 + [ci, ci, ci] + [vp] * 2 + [ci] + [vp] * 8 + [cf, cf]
            + [vp] * 4 + [ci] + [ci, vp])
        lib.nc_fwbw_custom_resident.restype = ci
        lib.nc_fwbw_custom_resident.argtypes = (
            [vp] * 4 + [ci, ci, ci] + [vp] * 2 + [ci] + [vp] * 8 + [cf, cf]
            + [vp] * 3 + [ci] + [ci, vp])
        lib.nc_fwbw_backward.restype = ci
        lib.nc_fwbw_backward.argtypes = (
            [vp] * 4 + [ci, ci] + [vp] * 9 + [cf] + [vp] + [ci, vp])
        lib.nc_fma_chain.restype = ci
        lib.nc_fma_chain.argtypes = [vp, ci, ci, ci, ci, cf, cf, vp, ci, vp]
        lib.nc_reshape_copy.restype = ci
        lib.nc_reshape_copy.argtypes = [vp, ci, vp, ci, vp]
        lib.nc_error_string.restype = ctypes.c_char_p
        lib.nc_error_string.argtypes = [ci]
        _lib = lib
        return _lib


def target(dev) -> tuple:
    """The last two arguments of every C entry for tensors on the CUDA
    device `dev`: its index and the raw handle of PyTorch's current stream
    there (torch.cuda.current_stream(dev).cuda_stream, without building a
    Stream object per launch)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


_count_lock = threading.Lock()


def count_launch(wrapper, route: str | None = None) -> None:
    """Add one to a kernel wrapper's `launches` (and, for a wrapper of two
    routes, to its `routes[route]`).  Under a lock: the EM sharder launches
    from one host thread per device, and `+=` on an attribute is not
    atomic."""
    with _count_lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


_peers: set = set()


def enable_peer_access(dev, peer) -> None:
    """Let kernels on the CUDA device `dev` read the memory of `peer`
    (K1m's column exchange and K2m's copies of the ranks' slices across
    cards); raises where the two cards cannot reach each other.  Nothing to
    do on one card."""
    a, b = torch.device(dev).index, torch.device(peer).index
    if a == b or (a, b) in _peers:
        return
    if not torch.cuda.can_device_access_peer(a, b):
        raise RuntimeError(f"cuda:{a} cannot access the memory of cuda:{b}: "
                           f"the state-parallel decode needs peer access")
    check(load().nc_enable_peer_access(a, b),
          f"peer access cuda:{a} -> cuda:{b}")
    _peers.add((a, b))


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = _lib.nc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
