"""Ingest from event arrays in memory, without a fast5 file.

`summarize_ed` is nanocall_tpu.read_pipeline._summarize_impl from the point
where the fast5 has been read (read_pipeline.py:286-339): the same checks,
abasic level, strand detection, event filtering and initial scaling, on an
EdEventData the caller already holds.  It lets a machine without h5py feed
the decode pipeline the same (summary, per-strand events) stream that
nanocall_tpu.ingest.ingest_stream yields from fast5 files.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from nanocall_tpu import fast5_io, native, read_pipeline
from nanocall_tpu.config import Config
from nanocall_tpu.events import EventSequence

log = logging.getLogger("Fast5_Summary")

_NO_EVENTS = [EventSequence(np.zeros(0), np.zeros(0), np.zeros(0),
                            np.zeros(0))] * 2


def summarize_ed(file_name: str, ed: fast5_io.EdEventData, models: dict,
                 cfg: Config, analyses=("EventDetection_000",)):
    """(ReadSummary, per-strand events) of one read's event-detection data,
    as read_pipeline.summarize(..., return_events=True) gives for a fast5
    file holding `ed` and the analysis groups `analyses`."""
    s = read_pipeline.ReadSummary(file_name=file_name, valid=True)
    base = os.path.basename(file_name)
    if base.endswith(".fast5"):
        base = base[: -len(".fast5")]
    s.base_file_name = base
    s.read_id = ed.read_id or base
    s.sampling_rate = ed.sampling_rate
    if not (1000.0 <= s.sampling_rate <= 10000.0):
        log.warning("%s: unexpected sampling rate: %s", file_name,
                    s.sampling_rate)
        return s, _NO_EVENTS
    num = min(len(ed.mean), cfg.max_ed_events)
    trim = cfg.trim_margins
    if num < trim[0] + trim[1] + cfg.min_ed_events:
        log.info("%s: not enough eventdetection events: %d", file_name, num)
        return s, _NO_EVENTS
    s.num_ed_events = num
    means = ed.mean[:num]
    s.abasic_level = native.abasic_level(
        means, cfg.abasic_level_top_percent, cfg.abasic_level_top_offset)
    if s.abasic_level <= 1.0:
        log.info("%s: abasic level too low: %s", file_name, s.abasic_level)
        s.num_ed_events = 0
        return s, _NO_EVENTS
    bounds = (trim[0], num - trim[1], 0, 0)
    if not cfg.template_only:
        bounds = read_pipeline.detect_strands(num, means, s.abasic_level, trim)
    if bounds[1] <= bounds[0]:
        log.info("%s: no template strand detected", file_name)
        s.num_ed_events = 0
        return s, _NO_EVENTS
    s.strand_bounds = bounds
    s.scale_strands_together = (
        cfg.double_strand_scaling
        and bounds[1] - bounds[0] >= cfg.min_ed_events
        and bounds[3] - bounds[2] >= cfg.min_ed_events
    )
    evs = read_pipeline.filter_and_build_events(
        read_pipeline._truncate(ed, num), bounds, s.abasic_level,
        s.sampling_rate, s.scale_strands_together,
    )
    s.time_length = tuple(
        evs[st].time_length() if len(evs[st]) >= cfg.min_ed_events else 0.0
        for st in (0, 1)
    )
    read_pipeline.initial_scaling(s, evs, models, cfg)
    s.bc_grp = fast5_io.next_basecall_group(list(analyses))
    return s, evs


def ed_from_arrays(mean, stdv, start, length, sampling_rate: float,
                   read_id: str = "") -> fast5_io.EdEventData:
    """EdEventData as fast5_io.Fast5File reads back what
    fast5_io.write_fast5 wrote: float64 mean/stdv, and start/length stored
    as int64 sample counts."""
    return fast5_io.EdEventData(
        read_id=read_id, sampling_rate=float(sampling_rate),
        mean=np.asarray(mean, np.float64), stdv=np.asarray(stdv, np.float64),
        start=np.asarray(start).astype(np.int64).astype(np.float64),
        length=np.asarray(length).astype(np.int64).astype(np.float64),
    )
