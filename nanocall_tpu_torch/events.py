"""Event sequences as struct-of-arrays (a copy of EventSequence from
nanocall_tpu/events.py).

An event sequence is a set of parallel float32 arrays (mean, stdv, start,
length) plus derived logs (Event.hpp); drift correction is a functional
transform (Event.hpp:77-84).
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
