"""HMM state-transition tables (a copy of nanocall_tpu/transitions.py,
without the JAX table builder: the port builds its device tables in
ops/hmm.py).

The reference (src/nanocall/State_Transitions.hpp) stores a per-state
adjacency list (`to_v`/`from_v` vectors of (state, logp) pairs).  The
*fast* transition structure (stay + 4 step + 16 skip-1 successors,
State_Transitions.hpp:181-220) is fully regular:

  from-neighbours of state j (slot layout, S = 21 slots):
    slot 0        : j itself                      (stay)
    slots 1 + b   : (b << 2(K-1)) | (j >> 2)      (step predecessors, b in 0..3)
    slots 5 + c   : (c << 2(K-2)) | (j >> 4)      (skip-1 predecessors, c in 0..15)

  to-neighbours of state i:
    slot 0        : i itself
    slots 1 + b   : (suffix(i, K-1) << 2) | b
    slots 5 + c   : (suffix(i, K-2) << 4) | c

Transition probabilities follow the overlap model of
State_Transitions.hpp:125-144 exactly (get_trans_prob): every (i, j) pair
receives p_stay/p_step/geometric-skip terms for each overlap it realizes plus
a uniform background term; duplicate slots (a from-state reachable via
several slot roles, e.g. homopolymers) are masked to -inf in all but the
first slot, because get_trans_prob already sums every path type.

A general sparse representation holds transition tables loaded from TSV
files with arbitrary structure (State_Transitions.hpp:237-252).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import kmer

# The nanocall binary overrides the library defaults (.09/.28,
# State_Transitions.hpp:22-28) with its CLI defaults at startup
# (nanocall.cpp:84-85,923-924).  We use the binary's effective defaults.
DEFAULT_P_STAY = 0.1
DEFAULT_P_SKIP = 0.3

N_SLOTS = 21  # 1 stay + 4 step + 16 skip-1


@dataclasses.dataclass(frozen=True)
class TransitionParams:
    """p_stay / p_skip pair (State_Transitions.hpp:14-51)."""

    p_stay: float = DEFAULT_P_STAY
    p_skip: float = DEFAULT_P_SKIP

    def is_default(self, defaults: "TransitionParams | None" = None) -> bool:
        # compared at FLOAT32: the EM pipeline round-trips params through
        # the device's f32 (a frozen/untrained group scatters back
        # float(np.float32(0.1)) != 0.1), and the reference's Float_Type
        # IS float — its default-vs-trained test (nanocall.cpp:651-661)
        # compares f32 values.  An exact f64 == here silently re-routed
        # trained-but-default reads away from a --trans loaded table.
        d = defaults if defaults is not None else TransitionParams()
        return bool(
            np.float32(self.p_stay) == np.float32(d.p_stay)
            and np.float32(self.p_skip) == np.float32(d.p_skip)
        )

    def as_array(self) -> np.ndarray:
        return np.array([self.p_stay, self.p_skip], dtype=np.float32)


def trans_prob(i, j, p_stay: float, p_step: float, p_skip_1: float, K: int):
    """Vectorized get_trans_prob (State_Transitions.hpp:125-144).

    Probability mass of i -> j: stay + step + per-overlap geometric skip
    terms + uniform background.  float64 internally, like the reference's
    double-promoted pow() arithmetic.
    """
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    n = kmer.n_states(K)
    p = np.zeros(np.broadcast_shapes(i.shape, j.shape), dtype=np.float64)
    p += np.where(i == j, p_stay, 0.0)
    p += np.where(
        kmer.suffix(i, K - 1, K) == kmer.prefix(j, K - 1, K), p_step / 4.0, 0.0
    )
    for l in range(2, K):
        p += np.where(
            kmer.suffix(i, K - l, K) == kmer.prefix(j, K - l, K),
            p_skip_1 ** (l - 1) / (1 << (2 * l)),
            0.0,
        )
    p += (p_skip_1 ** (K - 1) / (1.0 - p_skip_1)) / n
    return p


def _skip_geometry(p_stay: float, p_skip: float):
    """p_step and the one-skip geometric parameter (State_Transitions.hpp:160-162)."""
    p_step = 1.0 - p_stay - p_skip
    p_skip_1 = p_skip / (p_skip + 1.0)
    return p_step, p_skip_1


@functools.lru_cache(maxsize=None)
def _slot_maps(K: int):
    """(from_idx, to_idx): (21, n) int32 slot->state maps, plus dup masks.

    from_idx[k, j] = from-state of slot k for destination j.
    to_idx[k, i]   = to-state of slot k for source i.
    *_dup[k, x]    = True where the same neighbour already appeared in an
                     earlier slot (must be masked to -inf).
    """
    n = kmer.n_states(K)
    states = np.arange(n, dtype=np.int64)
    b = np.arange(4, dtype=np.int64)
    c = np.arange(16, dtype=np.int64)

    from_idx = np.empty((N_SLOTS, n), dtype=np.int64)
    from_idx[0] = states
    from_idx[1:5] = (b[:, None] << (2 * (K - 1))) | (states >> 2)[None, :]
    from_idx[5:21] = (c[:, None] << (2 * (K - 2))) | (states >> 4)[None, :]

    to_idx = np.empty((N_SLOTS, n), dtype=np.int64)
    to_idx[0] = states
    to_idx[1:5] = (kmer.suffix(states, K - 1, K) << 2)[None, :] | b[:, None]
    to_idx[5:21] = (kmer.suffix(states, K - 2, K) << 4)[None, :] | c[:, None]

    def dup_mask(idx):
        dup = np.zeros(idx.shape, dtype=bool)
        for k in range(1, N_SLOTS):
            dup[k] = (idx[:k] == idx[k][None, :]).any(axis=0)
        return dup

    return (
        from_idx.astype(np.int32),
        to_idx.astype(np.int32),
        dup_mask(from_idx),
        dup_mask(to_idx),
    )


def slot_from_state(K: int):
    """Return the (21, n) from-state map (for traceback)."""
    return _slot_maps(K)[0]


@dataclasses.dataclass(frozen=True)
class StructuredTransitions:
    """The 21-slot structured transition table (fast path).

    Attributes:
      from_logp: (21, n) float32; from_logp[k, j] = log p(from_k(j) -> j),
                 -inf on duplicate slots.
      to_logp:   (21, n) float32; to_logp[k, i] = log p(i -> to_k(i)),
                 -inf on duplicate slots.
      params:    the TransitionParams used to build it.
      K:         k-mer size.
    """

    from_logp: np.ndarray
    to_logp: np.ndarray
    params: TransitionParams
    K: int

    @property
    def n_states(self) -> int:
        return kmer.n_states(self.K)


@functools.lru_cache(maxsize=None)
def _build_structured_cached(p_stay: float, p_skip: float, K: int):
    from_idx, to_idx, from_dup, to_dup = _slot_maps(K)
    n = kmer.n_states(K)
    states = np.arange(n, dtype=np.int64)
    p_step, p_skip_1 = _skip_geometry(p_stay, p_skip)

    p_from = trans_prob(from_idx, states[None, :], p_stay, p_step, p_skip_1, K)
    p_to = trans_prob(states[None, :], to_idx, p_stay, p_step, p_skip_1, K)
    # match the reference: probabilities stored as float32 before log
    # (State_Transitions.hpp stores Float_Type = float)
    from_logp = np.where(from_dup, -np.inf, np.log(p_from.astype(np.float32)))
    to_logp = np.where(to_dup, -np.inf, np.log(p_to.astype(np.float32)))
    return from_logp.astype(np.float32), to_logp.astype(np.float32)


def build_structured(
    params: TransitionParams = TransitionParams(), K: int = 6
) -> StructuredTransitions:
    """Build the structured table (compute_transitions_fast equivalent,
    State_Transitions.hpp:181-224)."""
    from_logp, to_logp = _build_structured_cached(
        float(params.p_stay), float(params.p_skip), K
    )
    return StructuredTransitions(from_logp=from_logp, to_logp=to_logp, params=params, K=K)


def build_structured_batch(params_batch: np.ndarray, K: int = 6):
    """Batched structured tables for per-read trained transition params
    (a copy of nanocall_tpu/transitions.py:202-237).

    params_batch: (B, 2) float array of (p_stay, p_skip) rows.
    Returns (from_logp, to_logp) of shape (B, 21, n) float32.

    Fully vectorized over the batch (used when each read in a bucket has its
    own trained p_stay/p_skip, mirroring the per-read custom transitions of
    nanocall.cpp:651-661).
    """
    params_batch = np.asarray(params_batch, dtype=np.float64)
    from_idx, to_idx, from_dup, to_dup = _slot_maps(K)
    n = kmer.n_states(K)
    states = np.arange(n, dtype=np.int64)
    p_stay = params_batch[:, 0][:, None, None]
    p_skip = params_batch[:, 1][:, None, None]
    p_step = 1.0 - p_stay - p_skip
    p_skip_1 = p_skip / (p_skip + 1.0)

    def batch_prob(i, j):
        # i, j: (21, n) int arrays; returns (B, 21, n) float64
        p = np.zeros_like(p_stay + np.zeros((1,) + i.shape))
        p = p + np.where(i == j, 1.0, 0.0) * p_stay
        p = p + np.where(
            kmer.suffix(i, K - 1, K) == kmer.prefix(j, K - 1, K), 1.0, 0.0
        ) * (p_step / 4.0)
        for l in range(2, K):
            p = p + np.where(
                kmer.suffix(i, K - l, K) == kmer.prefix(j, K - l, K), 1.0, 0.0
            ) * (p_skip_1 ** (l - 1) / (1 << (2 * l)))
        p = p + (p_skip_1 ** (K - 1) / (1.0 - p_skip_1)) / n
        return p

    p_from = batch_prob(from_idx,
                        np.broadcast_to(states[None, :], from_idx.shape))
    p_to = batch_prob(np.broadcast_to(states[None, :], to_idx.shape), to_idx)
    from_logp = np.where(from_dup[None], -np.inf,
                         np.log(p_from.astype(np.float32)))
    to_logp = np.where(to_dup[None], -np.inf,
                       np.log(p_to.astype(np.float32)))
    return from_logp.astype(np.float32), to_logp.astype(np.float32)


@functools.lru_cache(maxsize=None)
def grouped_condition_masks(K: int):
    """Static overlap-condition indicator vectors for the grouped (3-way)
    Viterbi decomposition.

    Exploits that for destination j, ALL step predecessors
    i = (b << 2(K-1)) | (j >> 2) share one transition probability (every
    overlap condition suffix(i, K-l) == prefix(j, K-l) involves only the
    low bits of i, which equal bits of j), and likewise all skip-1
    predecessors i = (c << 2(K-2)) | (j >> 4).  The only per-slot
    exceptions are duplicate from-states (i == j, or step/skip
    coincidences), whose true probability is strictly larger and carried
    exactly by their primary group — so a max over the three group
    candidates is EXACT for Viterbi (see ops/hmm.viterbi_forward_grouped).

    Returns dict with float32 (n,) indicator arrays:
      stay_l{1..K-1}: overlap conditions of j -> j
      step_l{2..K-1}: conditions for step predecessors
      skip_l{3..K-1}: conditions for skip predecessors
    """
    n = kmer.n_states(K)
    j = np.arange(n, dtype=np.int64)
    out = {}
    # stay (i == j): all overlap conditions evaluated at i = j
    for l in range(1, K):
        out[f"stay_l{l}"] = (
            kmer.suffix(j, K - l, K) == kmer.prefix(j, K - l, K)
        ).astype(np.float32)
    # step predecessors: suffix(i, K-l) = (j >> 2) & mask(2(K-l)); l >= 2
    for l in range(2, K):
        mask = (1 << (2 * (K - l))) - 1
        out[f"step_l{l}"] = (((j >> 2) & mask) == (j >> (2 * l))).astype(np.float32)
    # skip predecessors: suffix(i, K-l) = (j >> 4) & mask(2(K-l)); l >= 3
    for l in range(3, K):
        mask = (1 << (2 * (K - l))) - 1
        out[f"skip_l{l}"] = (((j >> 4) & mask) == (j >> (2 * l))).astype(np.float32)
    return out


def grouped_tables(p_stay, p_skip, K: int, xp=np):
    """Build the 3 per-destination log-prob tables of the grouped Viterbi
    decomposition: (stay_lp, step_lp, skip_lp), each (..., n).

    p_stay/p_skip may be scalars or arrays (batched per read); xp is the
    array module.  Probabilities follow get_trans_prob
    (State_Transitions.hpp:125-144) exactly:
      stay_lp[j] = log p(j -> j)                       (full sum)
      step_lp[j] = log p(i_step -> j) for any generic step predecessor
      skip_lp[j] = log p(i_skip -> j) for any generic skip-1 predecessor
    """
    m = grouped_condition_masks(K)
    n = kmer.n_states(K)
    # Two float pipelines, within 1 f32 ulp of each other:
    #  - numpy path: accumulate float64, cast to float32 before log — the
    #    21-slot host builders' pipeline (TSV conformance vs the reference's
    #    6-digit text output);
    #  - device path: float32 throughout (ops/hmm.grouped_tables), the
    #    EM/decode pipeline.  The reference itself mixes float32
    #    accumulation with double pow() terms (State_Transitions.hpp:128-143),
    #    so no order of operations is bitwise-canonical; the enforced
    #    standard is decoded output.
    acc_dtype = np.float64 if xp is np else xp.float32
    p_stay = xp.asarray(p_stay, dtype=acc_dtype)[..., None]
    p_skip = xp.asarray(p_skip, dtype=acc_dtype)[..., None]
    p_step = 1.0 - p_stay - p_skip
    p_skip_1 = p_skip / (p_skip + 1.0)
    bg = (p_skip_1 ** (K - 1) / (1.0 - p_skip_1)) / n

    def term(l):
        return p_skip_1 ** (l - 1) / (1 << (2 * l))

    stay = p_stay + m["stay_l1"] * (p_step / 4.0) + bg
    for l in range(2, K):
        stay = stay + m[f"stay_l{l}"] * term(l)
    step = p_step / 4.0 + bg
    for l in range(2, K):
        step = step + m[f"step_l{l}"] * term(l)
    skip = term(2) + bg
    for l in range(3, K):
        skip = skip + m[f"skip_l{l}"] * term(l)
    return (
        xp.log(stay.astype(xp.float32)).astype(xp.float32),
        xp.log((step + xp.zeros(n, acc_dtype)).astype(xp.float32)).astype(xp.float32),
        xp.log((skip + xp.zeros(n, acc_dtype)).astype(xp.float32)).astype(xp.float32),
    )


@functools.lru_cache(maxsize=None)
def grouped_condition_masks_to(K: int):
    """To-side overlap indicators: conditions on the SOURCE i for the
    generic probability of i -> (any step successor) / (any skip-1
    successor).  For step successors j = (suffix(i,K-1)<<2)|b, the overlap
    prefix(j, K-l) = suffix(i, K-1) >> 2(l-1) is b-independent; for skip
    successors the l=2 condition always holds and l>=3 conditions are
    c-independent."""
    n = kmer.n_states(K)
    i = np.arange(n, dtype=np.int64)
    out = {}
    for l in range(2, K):
        lhs = i & ((1 << (2 * (K - l))) - 1)
        rhs = (i & ((1 << (2 * (K - 1))) - 1)) >> (2 * (l - 1))
        out[f"step_l{l}"] = (lhs == rhs).astype(np.float32)
    for l in range(3, K):
        lhs = i & ((1 << (2 * (K - l))) - 1)
        rhs = (i & ((1 << (2 * (K - 2))) - 1)) >> (2 * (l - 2))
        out[f"skip_l{l}"] = (lhs == rhs).astype(np.float32)
    return out


def grouped_tables_to(p_stay, p_skip, K: int, xp=np):
    """To-side generic tables (step_to_lp, skip_to_lp), each (..., n):
    log p(i -> any generic step / skip-1 successor of i).  The stay table
    is shared with the from-side (p(j -> j))."""
    m = grouped_condition_masks_to(K)
    n = kmer.n_states(K)
    acc_dtype = np.float64 if xp is np else xp.float32
    p_stay = xp.asarray(p_stay, dtype=acc_dtype)[..., None]
    p_skip = xp.asarray(p_skip, dtype=acc_dtype)[..., None]
    p_step = 1.0 - p_stay - p_skip
    p_skip_1 = p_skip / (p_skip + 1.0)
    bg = (p_skip_1 ** (K - 1) / (1.0 - p_skip_1)) / n

    def term(l):
        return p_skip_1 ** (l - 1) / (1 << (2 * l))

    step = p_step / 4.0 + bg
    for l in range(2, K):
        step = step + m[f"step_l{l}"] * term(l)
    skip = term(2) + bg
    for l in range(3, K):
        skip = skip + m[f"skip_l{l}"] * term(l)
    return (
        xp.log((step + xp.zeros(n, acc_dtype)).astype(xp.float32)).astype(xp.float32),
        xp.log((skip + xp.zeros(n, acc_dtype)).astype(xp.float32)).astype(xp.float32),
    )


@functools.lru_cache(maxsize=None)
def grouped_correction_masks(K: int):
    """Static exceptional-state masks for the grouped log-sum-exp
    decomposition (docs/grouped_viterbi.md 'Why this does NOT extend...'
    — except it does, with these closed-form corrections):

      H:      homopolymers (all bases equal; 4 states) — the step group
              contains a duplicate of the stay entry.
      P2mH:   period-2 states minus H (skip group contains the stay dup).
      S5:     five equal LEADING bases (from-side: 4 skip-group entries are
              really step members; their sum equals the step group sum).
      S5T:    five equal TRAILING bases (to-side mirror of S5).

    Returns dict of (n,) float32 {H, P2mH, S5, S5T}.
    """
    n = kmer.n_states(K)
    j = np.arange(n, dtype=np.int64)
    period1 = kmer.suffix(j, K - 1, K) == kmer.prefix(j, K - 1, K)
    period2 = kmer.suffix(j, K - 2, K) == kmer.prefix(j, K - 2, K)
    s5 = ((j >> 2) & ((1 << (2 * (K - 2))) - 1)) == (j >> 4)
    s5t = (j & ((1 << (2 * (K - 2))) - 1)) == (
        (j & ((1 << (2 * (K - 1))) - 1)) >> 2
    )
    return {
        "H": period1.astype(np.float32),
        "P2mH": (period2 & ~period1).astype(np.float32),
        "S5": s5.astype(np.float32),
        "S5T": s5t.astype(np.float32),
    }


@dataclasses.dataclass(frozen=True)
class SparseTransitions:
    """General sparse table (gather path) for arbitrary loaded transitions.

    from_idx / from_logp: (max_deg_from, n); padded entries have logp=-inf
    and idx=0.  Same for to_idx / to_logp.
    """

    from_idx: np.ndarray
    from_logp: np.ndarray
    to_idx: np.ndarray
    to_logp: np.ndarray
    K: int

    @property
    def n_states(self) -> int:
        return kmer.n_states(self.K)


def sparse_from_pairs(pairs, K: int) -> SparseTransitions:
    """Build a SparseTransitions from an iterable of (i, j, logp) entries."""
    n = kmer.n_states(K)
    to_lists: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    from_lists: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for i, j, lp in pairs:
        to_lists[i].append((j, lp))
        from_lists[j].append((i, lp))

    def pack(lists):
        max_deg = max(1, max(len(l) for l in lists))
        idx = np.zeros((max_deg, n), dtype=np.int32)
        logp = np.full((max_deg, n), -np.inf, dtype=np.float32)
        for x, l in enumerate(lists):
            for k, (y, lp) in enumerate(l):
                idx[k, x] = y
                logp[k, x] = lp
        return idx, logp

    from_idx, from_logp = pack(from_lists)
    to_idx, to_logp = pack(to_lists)
    return SparseTransitions(
        from_idx=from_idx, from_logp=from_logp, to_idx=to_idx, to_logp=to_logp, K=K
    )


def compute_transitions_dense(
    p_skip: float, p_stay: float, p_cutoff: float, K: int = 6
) -> SparseTransitions:
    """Exact O(N^2) table with probability cutoff
    (State_Transitions.hpp:147-178), as a SparseTransitions."""
    n = kmer.n_states(K)
    p_step, p_skip_1 = _skip_geometry(p_stay, p_skip)
    states = np.arange(n, dtype=np.int64)
    pairs = []
    # row-block so peak memory is a (block, n) slab, not n x n plus its
    # broadcast temporaries (matters above K=6)
    blk = 256
    for r0 in range(0, n, blk):
        rows = states[r0 : r0 + blk]
        P = trans_prob(rows[:, None], states[None, :], p_stay, p_step,
                       p_skip_1, K)
        ii, jj = np.nonzero(P > p_cutoff)
        lp = np.log(P[ii, jj].astype(np.float32))
        for i, j, v in zip((ii + r0).tolist(), jj.tolist(), lp.tolist()):
            pairs.append((i, j, v))
    return sparse_from_pairs(pairs, K)


def structured_to_pairs(st: StructuredTransitions):
    """Yield (i, j, logp) entries of a structured table in the reference's
    output order (ascending i, then ascending j — std::set iteration,
    State_Transitions.hpp:208-217,226-235)."""
    _, to_idx, _, to_dup = _slot_maps(st.K)
    n = st.n_states
    for i in range(n):
        entries = []
        for k in range(N_SLOTS):
            if to_dup[k, i]:
                continue
            entries.append((int(to_idx[k, i]), float(st.to_logp[k, i])))
        for j, lp in sorted(entries):
            yield i, j, lp


def save_tsv(st, path) -> None:
    """Write a transition table as the reference TSV (kmer_i, kmer_j, logp)."""
    kmers = kmer.all_kmer_strings(st.K)
    with open(path, "w") as fh:
        if isinstance(st, StructuredTransitions):
            for i, j, lp in structured_to_pairs(st):
                fh.write(f"{kmers[i]}\t{kmers[j]}\t{lp:g}\n")
        else:
            n = st.n_states
            for i in range(n):
                entries = [
                    (int(st.to_idx[k, i]), float(st.to_logp[k, i]))
                    for k in range(st.to_logp.shape[0])
                    if np.isfinite(st.to_logp[k, i])
                ]
                for j, lp in sorted(entries):
                    fh.write(f"{kmers[i]}\t{kmers[j]}\t{lp:g}\n")


def load_tsv(path, K: int = 6) -> SparseTransitions:
    """Load a transition table from the reference TSV format
    (State_Transitions.hpp:237-252)."""
    pairs = []
    from .util import zopen

    with zopen(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            i = kmer.kmer_to_int(parts[0])
            j = kmer.kmer_to_int(parts[1])
            pairs.append((i, j, float(parts[2])))
    return sparse_from_pairs(pairs, K)
