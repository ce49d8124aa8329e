"""K-mer algebra for the nanopore HMM state space.

The HMM states are all 4**K DNA k-mers, encoded as integers base-4 with
A=0, C=1, G=2, T=3, most-significant base first (reference semantics:
src/nanocall/Kmer.hpp:13-50).  A copy of nanocall_tpu/kmer.py.

Everything here is vectorized numpy over int arrays; tables are computed once
per K and cached.  This replaces the mutex-guarded lazy static tables of the
reference (Kmer.hpp:115-148) with plain precomputed arrays.
"""

from __future__ import annotations

import functools

import numpy as np

_BASES = "ACGT"
_BASE_TO_INT = {c: i for i, c in enumerate(_BASES)}


def n_states(K: int) -> int:
    """Number of HMM states for k-mer size K (Kmer.hpp:12)."""
    return 1 << (2 * K)


def kmer_to_int(s: str) -> int:
    """Encode a k-mer string as an integer (Kmer.hpp:13-36)."""
    res = 0
    for c in s:
        res = (res << 2) | _BASE_TO_INT[c]
    return res


def int_to_kmer(k: int, K: int) -> str:
    """Decode an integer state to its k-mer string (Kmer.hpp:41-50)."""
    return "".join(_BASES[(k >> (2 * (K - j - 1))) & 0x3] for j in range(K))


def int_to_kmer_array(K: int) -> np.ndarray:
    """(n_states, K) uint8 array of base codes for every state."""
    states = np.arange(n_states(K), dtype=np.uint32)
    shifts = 2 * (K - 1 - np.arange(K, dtype=np.uint32))
    return ((states[:, None] >> shifts[None, :]) & 0x3).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def all_kmer_strings(K: int) -> tuple[str, ...]:
    """All k-mer strings in state-index order.  Cached (and a tuple, so
    the shared result is immutable): --write-fast5 builds a per-result
    event/model table and would otherwise regenerate the 4^K strings for
    every read strand."""
    codes = int_to_kmer_array(K)
    lut = np.frombuffer(_BASES.encode(), dtype=np.uint8)
    return tuple(bytes(lut[row]).decode() for row in codes)


def prefix(i, k: int, K: int):
    """First k bases of state i, as an integer (Kmer.hpp:69-72)."""
    return i >> (2 * (K - k))


def suffix(i, k: int, K: int):
    """Last k bases of state i, as an integer (Kmer.hpp:73-76)."""
    return i & ((1 << (2 * k)) - 1)


def min_skip(k1, k2, K: int):
    """Minimum number of new bases needed to move from k-mer k1 to k2.

    0 if k1 == k2; else the smallest d >= 1 with suffix(k1, K-d) ==
    prefix(k2, K-d); K if no overlap (Kmer.hpp:51-68).  Vectorized over
    numpy int arrays.
    """
    k1 = np.asarray(k1, dtype=np.int64)
    k2 = np.asarray(k2, dtype=np.int64)
    res = np.full(np.broadcast_shapes(k1.shape, k2.shape), K, dtype=np.int32)
    # check overlaps from largest (k = K-1, i.e. skip 1) down; first (smallest
    # skip) match wins, so iterate downward in skip and overwrite.
    for k in range(1, K):  # overlap length k -> skip K - k
        match = suffix(k1, k, K) == prefix(k2, k, K)
        res = np.where(match, K - k, res)
    res = np.where(k1 == k2, 0, res)
    return res


@functools.lru_cache(maxsize=None)
def max_self_overlap(K: int) -> np.ndarray:
    """(n_states,) int32: max k in [1, K-1] with suffix(i,k) == prefix(i,k), else 0.

    Mirrors Kmer.hpp:81-110 (whose per-call local table is a reference bug we
    do not replicate; here it is a cached array).
    """
    states = np.arange(n_states(K), dtype=np.int64)
    res = np.zeros(n_states(K), dtype=np.int32)
    for k in range(K - 1, 0, -1):
        match = (suffix(states, k, K) == prefix(states, k, K)) & (res == 0)
        res = np.where(match, k, res)
    return res


@functools.lru_cache(maxsize=None)
def neighbour_list(K: int, d: int) -> np.ndarray:
    """(n_states, 4**d) int32: successor states at distance d (d in {1, 2}).

    neighbour_list(i, 1) = [(suffix(i, K-1) << 2) + b for b in 0..3]
    neighbour_list(i, 2) = the 16 two-step successors (Kmer.hpp:115-148),
    ordered as [b1*4 + b2] to match the reference's nested loops.
    """
    assert d in (1, 2)
    states = np.arange(n_states(K), dtype=np.int64)
    n1 = (suffix(states, K - 1, K)[:, None] << 2) + np.arange(4)[None, :]
    if d == 1:
        return n1.astype(np.int32)
    n2 = (suffix(n1, K - 1, K)[:, :, None] << 2) + np.arange(4)[None, None, :]
    return n2.reshape(n_states(K), 16).astype(np.int32)


def moves_to_base_seq(states: np.ndarray, moves: np.ndarray, K: int) -> str:
    """Assemble the base sequence from a decoded state path and move sequence.

    Mirrors Event_Sequence::get_base_seq (Event.hpp:85-99): start with the
    full k-mer of the first state, then for each subsequent event append the
    last `move` bases of its state.
    """
    states = np.asarray(states, dtype=np.int64)
    if len(states) == 0:  # eventless strand (all events filtered out)
        return ""
    moves = np.minimum(np.asarray(moves, dtype=np.int64), K)
    lut = np.frombuffer(_BASES.encode(), dtype=np.uint8)
    # Per-event appended characters: for event i>0, the last a=moves[i] bases
    # of states[i].  Build a flat output via cumulative offsets.
    a = moves.copy()
    a[0] = K  # first event contributes the whole k-mer
    total = int(a.sum())
    ends = np.cumsum(a)
    starts = ends - a
    # Vectorized: for each event, bases K-a .. K-1 of its state.
    # Expand to a (sum_a,) index: event id per output position.
    ev_id = np.repeat(np.arange(len(states)), a)
    # position within the appended chunk: 0..a-1
    pos_in_chunk = np.arange(total) - np.repeat(starts, a)
    # base index within the k-mer: (K - a[ev]) + pos
    base_idx = (K - a[ev_id]) + pos_in_chunk
    shifts = 2 * (K - 1 - base_idx)
    out = lut[((states[ev_id] >> shifts) & 0x3).astype(np.intp)]
    return bytes(out).decode()
