"""ctypes bindings for the port's native host helpers (a copy of
nanocall_tpu/native, built from this package's own preprocess.cpp).

The library is compiled by g++ at first use into `build/nanocall_tpu_torch/`
of the checkout, under a name that carries a hash of the source and the
flags, so a stale build is never loaded.  Every entry point has a numpy
path, bit-identical to the C++ one, which runs when no compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "preprocess.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "nanocall_tpu_torch")
# -ffp-contract=off: nc_mean_stdv_f32's `s2/n - mean*mean` must round like
# the reference binary (no FMA); contraction shifts the f32 moments by 1 ulp,
# which feeds the initial scale/shift.  No -march=native: the build
# directory may travel with the checkout to another host.
CXXFLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-fPIC", "-Wall",
            "-shared")

_lock = threading.Lock()
_LIB = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libnc_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile to a unique temporary name and rename it into place, so
    concurrent processes never load a half-written library.  A failure
    leaves the numpy paths in charge."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError:
        return
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)


def _load():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _LIB = False
            return _LIB
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
        lib.nc_abasic_level.restype = f64
        lib.nc_abasic_level.argtypes = [c_dp, i64, f64, f64]
        lib.nc_find_islands_5.restype = i64
        lib.nc_find_islands_5.argtypes = [c_dp, i64, f64, c_i64p, i64]
        lib.nc_filter_events.restype = None
        lib.nc_filter_events.argtypes = [c_dp, c_dp, i64, f64, c_u8p]
        lib.nc_mean_stdv_f32.restype = None
        lib.nc_mean_stdv_f32.argtypes = [c_dp, i64, c_dp]
        lib.nc_moves.restype = None
        lib.nc_moves.argtypes = [c_i32p, i64, i32, c_i32p]
        lib.nc_base_seq.restype = i64
        lib.nc_base_seq.argtypes = [c_i32p, c_i32p, i64, i32, ctypes.c_char_p]
        lib.nc_path_from_codes.restype = None
        lib.nc_path_from_codes.argtypes = [i32, c_u8p, i64, i32, c_i32p]
        lib.nc_path_from_packed.restype = None
        lib.nc_path_from_packed.argtypes = [i32, c_u8p, i64, i32, c_i32p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return bool(_load())


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def abasic_level(means: np.ndarray, top_percent: float, top_offset: float) -> float:
    lib = _load()
    means = np.ascontiguousarray(means, dtype=np.float64)
    if lib:
        return lib.nc_abasic_level(_ptr(means, ctypes.c_double), len(means),
                                   top_percent, top_offset)
    from ..read_pipeline import detect_abasic_level

    return detect_abasic_level(means, top_percent, top_offset)


def find_islands_5(means: np.ndarray, level: float) -> list:
    lib = _load()
    means = np.ascontiguousarray(means, dtype=np.float64)
    if lib:
        out = np.zeros(2 * (len(means) // 5 + 1), dtype=np.int64)
        cnt = lib.nc_find_islands_5(
            _ptr(means, ctypes.c_double), len(means), level,
            _ptr(out, ctypes.c_int64), len(out) // 2,
        )
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(cnt)]
    from ..read_pipeline import find_islands_5_consec

    return find_islands_5_consec(means, level)


def mean_stdv_f32(vals: np.ndarray) -> tuple[float, float]:
    """(mean, population stdv) with the reference's exact float32 sequential
    accumulation (alg::mean_stdv_of<Float_Type>: s += v; s2 += v*v in order,
    mean = s/n, stdv = sqrtf(s2/n - mean^2)).  Initial scale/shift derive
    from these moments (Fast5_Summary.hpp:223-278, Pore_Model.hpp:307-313),
    and bit-equality here is what makes untrained FASTA byte-identical to
    the reference binary."""
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    lib = _load()
    if lib:
        out = np.zeros(2, np.float64)
        lib.nc_mean_stdv_f32(_ptr(vals, ctypes.c_double), len(vals),
                             _ptr(out, ctypes.c_double))
        return float(out[0]), float(out[1])
    return _mean_stdv_f32_numpy(vals)


def _mean_stdv_f32_numpy(vals: np.ndarray) -> tuple[float, float]:
    """Numpy path of mean_stdv_f32, bit-identical to the C++ loop."""
    n = len(vals)
    if n == 0:
        return 0.0, 0.0
    # np.cumsum is a strict sequential pass, so the f32 partial sums round
    # identically to the C++ loop (np.sum's pairwise reduction would not)
    v = vals.astype(np.float32)
    s = np.cumsum(v, dtype=np.float32)[-1]
    s2 = np.cumsum(v * v, dtype=np.float32)[-1]
    mean = np.float32(s / np.float32(n))
    var = np.float32(s2 / np.float32(n)) - mean * mean
    stdv = np.sqrt(var) if var > 0 else np.float32(0.0)
    return float(mean), float(np.float32(stdv))


def filter_events(mean: np.ndarray, stdv: np.ndarray, level: float) -> np.ndarray:
    lib = _load()
    mean = np.ascontiguousarray(mean, dtype=np.float64)
    stdv = np.ascontiguousarray(stdv, dtype=np.float64)
    if lib:
        keep = np.zeros(len(mean), dtype=np.uint8)
        lib.nc_filter_events(_ptr(mean, ctypes.c_double),
                             _ptr(stdv, ctypes.c_double), len(mean), level,
                             _ptr(keep, ctypes.c_uint8))
        return keep.astype(bool)
    return (mean < level) & (stdv <= 4.0)


def path_from_codes(s0: int, codes: np.ndarray, K: int) -> np.ndarray:
    """Reconstruct the full (n,) int32 state path from the compact
    traceback encoding: codes[t-1] = (move << 4) | (state_t & 15)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes) + 1
    path = np.empty(n, dtype=np.int32)
    lib = _load()
    if lib:
        lib.nc_path_from_codes(int(s0), _ptr(codes, ctypes.c_uint8), n, K,
                               _ptr(path, ctypes.c_int32))
        return path
    mask = (1 << (2 * K)) - 1
    s = int(s0)
    path[0] = s
    for t in range(1, n):
        c = int(codes[t - 1])
        move = c >> 4
        if move == 1:
            s = ((s << 2) | (c & 0x3)) & mask
        elif move == 2:
            s = ((s << 4) | (c & 0xF)) & mask
        path[t] = s
    return path


def path_from_packed_codes(s0: int, packed: np.ndarray, n: int,
                           K: int) -> np.ndarray:
    """Reconstruct the full (n,) int32 state path from the BIT-PACKED
    compact traceback encoding (ops/hmm.py pack_codes): four 6-bit codes
    per little-endian 24-bit group, each code = (move << 4) | (state_t &
    15).  `packed` must hold at least 3*ceil((n-1)/4) bytes."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    path = np.empty(n, dtype=np.int32)
    if n == 0:
        return path
    lib = _load()
    if lib:
        lib.nc_path_from_packed(int(s0), _ptr(packed, ctypes.c_uint8), n, K,
                                _ptr(path, ctypes.c_int32))
        return path
    # numpy path: unpack the 24-bit groups, then the scalar reconstruction
    G = -(-(n - 1) // 4)
    if G:
        w = (packed[0:3 * G:3].astype(np.uint32)
             | (packed[1:3 * G:3].astype(np.uint32) << 8)
             | (packed[2:3 * G:3].astype(np.uint32) << 16))
        codes = ((w[:, None] >> (6 * np.arange(4, dtype=np.uint32))) & 0x3F)
        codes = codes.reshape(-1).astype(np.uint8)[: n - 1]
    else:
        codes = np.zeros(0, np.uint8)
    return path_from_codes(s0, codes, K)


def moves_and_base_seq(path: np.ndarray, K: int):
    """(moves (n,), base_seq str) for a decoded state path."""
    lib = _load()
    path = np.ascontiguousarray(path, dtype=np.int32)
    n = len(path)
    if lib:
        moves = np.zeros(n, dtype=np.int32)
        lib.nc_moves(_ptr(path, ctypes.c_int32), n, K,
                     _ptr(moves, ctypes.c_int32))
        buf = ctypes.create_string_buffer(n * K + 1)
        ln = lib.nc_base_seq(_ptr(path, ctypes.c_int32),
                             _ptr(moves, ctypes.c_int32), n, K, buf)
        return moves, buf.raw[:ln].decode()
    from .. import kmer

    moves = np.zeros(n, np.int32)
    if n > 1:
        moves[1:] = kmer.min_skip(path[:-1], path[1:], K)
    return moves, kmer.moves_to_base_seq(path, moves, K)
