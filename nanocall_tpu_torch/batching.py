"""Length buckets and batch caps of decode and training work (a copy of
the parts of nanocall_tpu/batching.py that the port calls).

Reads vary from tens to 100k events.  Tasks are grouped into length
buckets, and each bucket runs in chunks of at most a batch cap that keeps
the chunk's dominant tensor within a memory budget.
"""

from __future__ import annotations

import math


MIN_BUCKET = 128


def bucket_length(n_events: int, min_bucket: int = MIN_BUCKET) -> int:
    """Padded bucket length: power of two up to 2048, then multiples of
    2048."""
    n = max(n_events, 1)
    if n <= 2048:
        return max(min_bucket, 1 << math.ceil(math.log2(n)))
    return ((n + 2047) // 2048) * 2048


#: path chunks of buckets at least this long decode chunk by chunk in time
#: (ops.hmm.viterbi_decode_grouped_tchunk), as the JAX package selects it
TCHUNK_MIN_T = 32768

#: events per time chunk of that decode
TCHUNK_LEN = 8192


def tchunk_len(T: int) -> int:
    """Chunk length of the chunked-time decode at bucket T: TCHUNK_LEN (the
    last chunk is simply shorter), or T itself when the bucket is no
    longer than one chunk."""
    return T if T <= TCHUNK_LEN else TCHUNK_LEN


def batch_size_for(T: int, max_batch: int, mem_budget_bytes: int, n_states: int,
                   bytes_per_cell: int = 1) -> int:
    """Cap the bucket batch size so the dominant DP tensor stays within
    budget.  bytes_per_cell is the memory cost per (T x n_states) cell PER
    BATCH ROW: 1 for decode (uint8 backpointers)."""
    by_mem = max(1, mem_budget_bytes // (T * n_states * bytes_per_cell))
    return max(1, min(max_batch, by_mem))
