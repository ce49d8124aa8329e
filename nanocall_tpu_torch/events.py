"""Event sequences as struct-of-arrays (a copy of nanocall_tpu/events.py).

An event sequence is a set of parallel float32 arrays (mean, stdv, start,
length) plus derived logs (Event.hpp); drift correction is a functional
transform (Event.hpp:77-84).  Variable-length batches are padded into
numpy arrays with their lengths (pad_batch); the events' logs are taken on
the host with np.log, as in the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EventSequence:
    """One read strand's events.  All arrays are float32 (T,)."""

    mean: np.ndarray
    stdv: np.ndarray
    start: np.ndarray
    length: np.ndarray

    def __post_init__(self):
        self.mean = np.asarray(self.mean, dtype=np.float32)
        # update_logs clamps stdv == 0 to 0.01 (Event.hpp:39-42)
        stdv = np.asarray(self.stdv, dtype=np.float32).copy()
        stdv[stdv == 0.0] = 0.01
        self.stdv = stdv
        self.start = np.asarray(self.start, dtype=np.float32)
        self.length = np.asarray(self.length, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.mean)

    @property
    def log_stdv(self) -> np.ndarray:
        return np.log(self.stdv)

    def corrected_mean(self, drift: float) -> np.ndarray:
        """Drift-corrected means: mean - drift * start (Event.hpp:77-84)."""
        return self.mean - np.float32(drift) * self.start

    def time_length(self) -> float:
        """start + length of the last event (Fast5_Summary.hpp:218)."""
        if len(self) == 0:
            return 0.0
        return float(self.start[-1] + self.length[-1])

    def mean_stdv(self) -> tuple[float, float]:
        """(mean, population stdv) of event means, for initial scaling
        (Fast5_Summary.hpp:225-230).  Float32 sequential accumulation like
        the reference's alg::mean_stdv_of<Float_Type> — exact parity here
        keeps untrained initial scale/shift bit-identical."""
        from . import native

        return native.mean_stdv_f32(self.mean)


def empty_events() -> EventSequence:
    """A strand with no events."""
    z = np.zeros(0)
    return EventSequence(mean=z, stdv=z, start=z, length=z)


def load_tsv(path) -> EventSequence:
    """Load events from the dev-tool TSV (mean, stdv, start, length per line;
    run-viterbi.cpp:46-52 / Event.hpp:59-68)."""
    from .util import zopen

    with zopen(path) as fh:
        data = np.loadtxt(fh, dtype=np.float64, ndmin=2)
    if data.size == 0:  # empty/comment-only file -> empty sequence, like
        # the reference's operator>> loop reading nothing
        z = np.zeros(0, np.float64)
        return EventSequence(mean=z, stdv=z, start=z, length=z)
    return EventSequence(
        mean=data[:, 0], stdv=data[:, 1], start=data[:, 2], length=data[:, 3]
    )


def save_tsv(ev: EventSequence, path) -> None:
    with open(path, "w") as fh:
        for i in range(len(ev)):
            fh.write(f"{ev.mean[i]:g}\t{ev.stdv[i]:g}\t{ev.start[i]:g}\t{ev.length[i]:g}\n")


def pad_batch(seqs: list[EventSequence], pad_to: int | None = None, drifts=None):
    """Pad a list of event sequences into batched arrays.

    Returns dict of (B, T) float32 arrays {mean, stdv, log_stdv, start} plus
    int32 lengths (B,).  `drifts` (B,) optionally applies per-sequence drift
    correction to the means (the DP kernels consume corrected means).
    Padding events carry benign values (mean=1, stdv=1) and are masked out by
    length in every kernel.
    """
    B = len(seqs)
    T = pad_to if pad_to is not None else max((len(s) for s in seqs), default=0)
    mean = np.ones((B, T), dtype=np.float32)
    stdv = np.ones((B, T), dtype=np.float32)
    start = np.zeros((B, T), dtype=np.float32)
    lengths = np.zeros(B, dtype=np.int32)
    for b, s in enumerate(seqs):
        L = len(s)
        if L > T:
            raise ValueError(f"sequence {b} longer ({L}) than pad_to ({T})")
        m = s.corrected_mean(drifts[b]) if drifts is not None else s.mean
        mean[b, :L] = m
        stdv[b, :L] = s.stdv
        start[b, :L] = s.start
        lengths[b] = L
    return {
        "mean": mean,
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "start": start,
        "length": lengths,
    }
