"""The sizes of the chunks the drivers dispatch, and the memory budgets that
cut them.

Port of nanocall_tpu/shapes.py as the port's sizing enumeration: every
(T, B) a decode or EM chunk can have.  T is a length bucket
(batching.bucket_length; `length_rungs` lists them).  B is at most the
chunk cap of the bucket: basecall's drivers dispatch a chunk whenever a
bucket's queue reaches the cap, and the rest of a bucket at the end, in
chunks of the cap and one shorter chunk.  The port's chunks hold exactly
their tasks or groups (the EventPool uploads exact row counts too), so the
enumerations are the ranges 1..cap; under the data sharder (parallel/mesh.py)
every cap is floored to a multiple of `align`, the shard count, so that a
full chunk splits evenly over the devices.

On CUDA no shape compiles, so the list is a tripwire for changes to the
drivers' sizing (tests/test_torch_shapes.py drives the real drivers over
it), and the set of shapes a CUDA graph per shape would be captured for.
The JAX package's BP_MEM_BUDGET and path_bp_budget are not copied: they
size a 15.75 GB TPU and an XLA layout copy of the backpointers that the
port never makes (nanocall_tpu/shapes.py:32-38,74-86); nor its pool
arities and quantized batch rungs, which only bound compiled shapes.
"""

from __future__ import annotations

from . import batching, kmer
from .config import Config

#: backpointer bytes one path chunk may hold.  A chunk's bps are exactly
#: B * (T-1) * 4096 bytes, so the budget caps B only for long buckets
#: (batching.batch_size_for) and leaves the rest of an 80 GB card to the
#: event pool, the tables and the chunks in flight.  The chunked-time decode
#: of long buckets holds the same bytes (every chunk's bps live until its
#: traceback), so the cap is the same for both; the JAX package's larger
#: cap for that decode bounds an XLA layout copy that the port never makes.
BP_BUDGET = 32 << 30

#: alpha bytes one EM chunk may hold.  A round stores the alphas of its
#: G * 4 rows, (T, G*4, n) float32 = 16 bytes per (T x n) cell per group,
#: so the default chunk (128 groups at T = 128) takes 1.07 GB and a long
#: --scaling-num-events shrinks G instead of running out of memory.  A
#: round that trains nothing stores no alphas and is not bounded by it.
EM_BUDGET = 8 << 30

#: bytes per (T x n) cell per group of a default EM round that trains
EM_BYTES_PER_CELL = 16

#: bytes per (T x n) cell per group of a --trans run's legacy EM round:
#: alpha, beta and em of the group's 4 rows, twice (the E-step's output and
#: the assembled tensors), as nanocall_tpu/basecall.py:338-345 counts
LEGACY_BYTES_PER_CELL = 96

#: bytes per (row, event) of a score-only chunk under --score-max-batch:
#: its gathered events and the scan's workspace, no backpointers
SCORE_BYTES_PER_EVENT = 60


def floor_align(b: int, align: int) -> int:
    """b rounded down to a multiple of align, and at least align (rounding
    up would let a sharded chunk exceed its memory budget)."""
    return max(align, (b // align) * align) if align > 1 else b


def length_rungs(max_events: int, min_bucket: int = batching.MIN_BUCKET):
    """Every padded bucket length reachable for reads up to max_events
    (batching.bucket_length's ladder: pow2 to 2048, then 2048-multiples)."""
    out = []
    t = min_bucket
    while t <= 2048:
        out.append(t)
        t *= 2
    t = 4096
    top = batching.bucket_length(max(max_events, 1), min_bucket)
    while t <= top:
        out.append(t)
        t += 2048
    return out


def path_chunk_cap(cfg: Config, T: int, align: int = 1) -> int:
    """Tasks in a full path chunk of bucket T (basecall._DecodeDriver):
    --batch, capped by BP_BUDGET of backpointers."""
    return floor_align(batching.batch_size_for(
        T, cfg.bucket_max_batch, BP_BUDGET, kmer.n_states(cfg.kmer_size)),
        align)


def score_chunk_cap(cfg: Config, T: int, align: int = 1) -> int:
    """Tasks in a full score-only chunk of bucket T: the path chunks' cap,
    or with --score-max-batch that many, capped by the chunk's events and
    workspace (SCORE_BYTES_PER_EVENT)."""
    if not cfg.score_max_batch:
        return path_chunk_cap(cfg, T, align)
    return floor_align(batching.batch_size_for(
        T, cfg.score_max_batch, BP_BUDGET, 1,
        bytes_per_cell=SCORE_BYTES_PER_EVENT), align)


def train_chunk_cap(cfg: Config, T: int | None = None, align: int = 1,
                    with_trans_table: bool = False) -> int:
    """Groups in a full EM chunk of bucket T (basecall._EMDriver; T
    defaults to the bucket of the training subsequences,
    scaling_num_events / 2): --train-group-batch, capped by EM_BUDGET of
    stored alphas (a --trans run's legacy round: LEGACY_BYTES_PER_CELL); a
    round that trains nothing stores none."""
    if T is None:
        T = batching.bucket_length(max(1, cfg.scaling_num_events // 2))
    if with_trans_table:
        bpc = LEGACY_BYTES_PER_CELL
    elif cfg.train_scaling or cfg.train_transitions:
        bpc = EM_BYTES_PER_CELL
    else:
        return floor_align(cfg.train_group_batch, align)
    return floor_align(batching.batch_size_for(
        T, cfg.train_group_batch, EM_BUDGET, kmer.n_states(cfg.kmer_size),
        bytes_per_cell=bpc), align)


def path_chunk_batches(cfg: Config, T: int, align: int = 1) -> range:
    """Every number of tasks a path chunk of bucket T can hold."""
    return range(1, path_chunk_cap(cfg, T, align) + 1)


def score_chunk_batches(cfg: Config, T: int, align: int = 1) -> range:
    """Every number of tasks a score-only chunk of bucket T can hold."""
    return range(1, score_chunk_cap(cfg, T, align) + 1)


def train_chunk_batches(cfg: Config, T: int | None = None, align: int = 1,
                        with_trans_table: bool = False) -> range:
    """Every number of groups an EM chunk of bucket T can hold."""
    return range(1, train_chunk_cap(cfg, T, align, with_trans_table) + 1)


def shard_sizes(B: int, n: int) -> list:
    """The rows of each device's shard when the data sharder splits a chunk
    of B over n devices: contiguous, as equal as can be (the first B % n
    shards one row more), empty shards left out."""
    q, r = divmod(B, n)
    return [q + (i < r) for i in range(n) if q + (i < r)]
