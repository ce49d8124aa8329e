"""Per-read preprocessing: summary, strand/hairpin detection, event loading
(a copy of nanocall_tpu/read_pipeline.py).

Host-side numpy rebuild of the reference's Fast5_Summary.hpp.  A
ReadSummary carries per-read pipeline state (strand bounds, abasic level,
initial scaling params per candidate model, trained params) between the
summarize / train / basecall stages.  The hot scalar scans (abasic
quantile, island detection) run in the native helpers (native/) when they
are built; this module holds their numpy versions.

`summarize` reads a fast5 file's event-detection data and hands it to
`summarize_ed`, which a caller without h5py can also feed from arrays in
memory (ingest.ed_from_arrays).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from . import fast5_io
from .config import Config
from .events import EventSequence, empty_events
from .pore_model import PoreModel, PoreModelParams
from .transitions import TransitionParams

log = logging.getLogger("Fast5_Summary")


@dataclasses.dataclass
class ReadSummary:
    file_name: str
    base_file_name: str = ""
    read_id: str = ""
    bc_grp: str = ""
    valid: bool = False
    num_ed_events: int = 0
    sampling_rate: float = 0.0
    abasic_level: float = 0.0
    scale_strands_together: bool = False
    strand_bounds: tuple = (0, 0, 0, 0)
    time_length: tuple = (0.0, 0.0)
    # candidate-model state; keys are (name0, name1) with '' for unused strand
    pm_params: dict = dataclasses.field(default_factory=dict)
    st_params: dict = dataclasses.field(default_factory=dict)
    # preferred_model[st][st2] mirrors the reference's 3x2 array; we keep the
    # per-strand selected model name (index by strand; 2 = joint)
    preferred_model: dict = dataclasses.field(default_factory=dict)
    fits: dict = dataclasses.field(default_factory=dict)


def detect_abasic_level(means: np.ndarray, top_percent: float, top_offset: float) -> float:
    """99th-ish percentile + offset (Fast5_Summary.hpp:528-543): sort event
    means, take the value at index size*(1 - top_percent/100), add offset.

    Computed in float32 like the reference (vector<Float_Type>): with
    top_offset 0 (the r9 preset) the threshold lands exactly ON an event
    value, and the f32 rounding direction decides whether that event itself
    survives filter_ed_event's mean >= abasic_level drop."""
    s = np.sort(np.asarray(means, np.float32))
    idx = int(len(s) * (1.0 - top_percent / 100.0))
    # clamp both ends like the native nc_abasic_level: top_percent > 100
    # must floor at the minimum event, not wrap to the top of the array
    idx = min(max(idx, 0), len(s) - 1)
    return float(np.float32(s[idx] + np.float32(top_offset)))


def find_islands_5_consec(means: np.ndarray, abasic_level: float):
    """Runs of >= 5 consecutive events at/above the abasic level
    (Fast5_Summary.hpp:545-571).  Returns list of [start, end) pairs."""
    high = means >= abasic_level
    islands = []
    i, n = 0, len(means)
    while i < n:
        if high[i]:
            j = i + 1
            while j < n and high[j]:
                j += 1
            if j - i >= 5:
                islands.append((i, j))
            i = j + 1
        else:
            i += 1
    return islands


def merge_islands(islands, gap: int):
    """Merge islands within `gap` of each other (Fast5_Summary.hpp:665-676)."""
    islands = list(islands)
    merged = True
    while merged:
        merged = False
        for i in range(1, len(islands)):
            if islands[i - 1][1] + gap >= islands[i][0]:
                islands[i - 1] = (islands[i - 1][0], islands[i][1])
                del islands[i]
                merged = True
                break
    return islands


def detect_strands(num_events: int, means: np.ndarray, abasic_level: float,
                   trim: tuple) -> tuple:
    """Strand-boundary detection via the hairpin abasic island
    (Fast5_Summary.hpp:653-731).  Returns strand_bounds (t_start, t_end,
    c_start, c_end); (.., 0, 0) means template-only."""
    from . import native

    bounds = [trim[0], num_events - trim[1], 0, 0]
    islands = merge_islands(
        native.find_islands_5(means, abasic_level), max(trim[2], trim[3])
    )
    if not islands:
        return tuple(bounds)
    mid = num_events // 2

    def dist_to_middle(p):
        return min(abs(p[0] - mid), abs(p[1] - mid))

    best = min(islands, key=dist_to_middle)
    if dist_to_middle(best) > num_events // 6:
        # hairpin not in the middle third: treat as template-only
        return tuple(bounds)
    b0 = trim[0]
    if islands[0][0] < trim[0] + trim[2]:
        b0 = max(b0, islands[0][1])
    b1 = best[0] - trim[2]
    b2 = best[0] + trim[3]  # sic: island *start* + hp-end margin (hpp:724)
    b3 = num_events - trim[1]
    if islands[-1][1] > num_events - (trim[3] + trim[1]):
        b3 = min(b3, islands[-1][0])
    return (b0, b1, b2, b3)


def filter_and_build_events(
    ed: fast5_io.EdEventData,
    bounds: tuple,
    abasic_level: float,
    sampling_rate: float,
    scale_strands_together: bool,
) -> list:
    """Per-strand filtered event sequences (Fast5_Summary.hpp:348-365,
    734-745): drop events with mean >= abasic level or stdv > 4; convert
    start/length to seconds relative to the strand (or read) start."""
    out = []
    for st in (0, 1):
        lo, hi = bounds[2 * st], bounds[2 * st + 1]
        if hi <= lo:
            out.append(empty_events())
            continue
        from . import native

        ref_idx = bounds[0] if scale_strands_together else lo
        sel = slice(lo, hi)
        keep = native.filter_events(ed.mean[sel], ed.stdv[sel], abasic_level)
        t0 = ed.start[ref_idx]
        out.append(
            EventSequence(
                mean=ed.mean[sel][keep],
                stdv=ed.stdv[sel][keep],
                start=(ed.start[sel][keep] - t0) / sampling_rate,
                length=ed.length[sel][keep] / sampling_rate,
            )
        )
    return out


def initial_scaling(
    summary: ReadSummary, evs: list, models: dict, cfg: Config
) -> None:
    """Moment-matching initial scale/shift per candidate model
    (Fast5_Summary.hpp:223-278); fills summary.pm_params / st_params."""
    f32 = np.float32
    if summary.scale_strands_together:
        r = [evs[0].mean_stdv(), evs[1].mean_stdv()]
        for n0, m0 in models.items():
            if m0.strand not in (0, 2):
                continue
            for n1, m1 in models.items():
                if m1.strand not in (1, 2):
                    continue
                # f32 arithmetic in the reference's evaluation order
                # (Fast5_Summary.hpp:238-241: every operand is Float_Type)
                scale = (f32(r[0][1]) / f32(m0.stdv())
                         + f32(r[1][1]) / f32(m1.stdv())) / 2
                shift = (f32(r[0][0]) - scale * f32(m0.mean())
                         + f32(r[1][0]) - scale * f32(m1.mean())) / 2
                scale, shift = float(scale), float(shift)
                key = (n0, n1)
                summary.pm_params[key] = PoreModelParams(scale=scale, shift=shift)
                summary.st_params[key] = [
                    TransitionParams(cfg.pr_stay, cfg.pr_skip),
                    TransitionParams(cfg.pr_stay, cfg.pr_skip),
                ]
    else:
        for st in (0, 1):
            if len(evs[st]) < cfg.min_ed_events:
                continue
            r_mean, r_std = evs[st].mean_stdv()
            for name, m in models.items():
                if m.strand == st or m.strand == 2:
                    # f32 ops like the reference (Fast5_Summary.hpp:267-268)
                    scale = f32(r_std) / f32(m.stdv())
                    shift = f32(r_mean) - scale * f32(m.mean())
                    scale, shift = float(scale), float(shift)
                    key = (name, "") if st == 0 else ("", name)
                    summary.pm_params[key] = PoreModelParams(scale=scale, shift=shift)
                    # BOTH entries default-construct with the CLI-tracking
                    # values (the reference's State_Transition_Parameters
                    # statics, nanocall.cpp:923-924) — the unused strand's
                    # slot is printed by --stats and must match
                    summary.st_params[key] = [
                        TransitionParams(cfg.pr_stay, cfg.pr_skip),
                        TransitionParams(cfg.pr_stay, cfg.pr_skip),
                    ]


def summarize(path: str, models: dict, cfg: Config, return_events=False):
    """Open a fast5 file and build its ReadSummary
    (Fast5_Summary::summarize, hpp:138-319).  Any failure leaves
    num_ed_events == 0 and the read is skipped downstream.

    With return_events, returns (summary, per-strand events): the filtered
    event sequences summarize already builds for initial scaling, identical
    to a later load_events() but without re-opening the fast5."""
    s, evs = _summarize_file(path, models, cfg)
    return (s, evs) if return_events else s


def _summarize_file(path: str, models: dict, cfg: Config):
    s = _new_summary(path)
    try:
        with fast5_io.Fast5File(path) as f:
            if not f.have_sampling_rate():
                log.info("%s: missing sampling rate", path)
                return s, _no_events()
            s.sampling_rate = f.get_sampling_rate()
            if not (1000.0 <= s.sampling_rate <= 10000.0):
                log.warning("%s: unexpected sampling rate: %s", path, s.sampling_rate)
                return s, _no_events()
            if not f.have_eventdetection_events(cfg.ed_group):
                log.info("%s: missing eventdetection events", path)
                return s, _no_events()
            ed = f.get_eventdetection_events(cfg.ed_group)
            return s, _summarize_events(s, ed, models, cfg,
                                        f.get_basecall_group_list())
    except Exception as e:  # HDF5 errors -> skip read (hpp:311-315)
        log.warning("%s: fast5 error: %s", path, e)
        s.num_ed_events = 0
    return s, _no_events()


def _new_summary(file_name: str) -> ReadSummary:
    s = ReadSummary(file_name=file_name, valid=True)
    base = os.path.basename(file_name)
    if base.endswith(".fast5"):
        base = base[: -len(".fast5")]
    s.base_file_name = base
    s.read_id = base
    return s


def _no_events() -> list:
    return [empty_events(), empty_events()]


def summarize_ed(file_name: str, ed: fast5_io.EdEventData, models: dict,
                 cfg: Config, analyses=("EventDetection_000",)):
    """(ReadSummary, per-strand events) of one read's event-detection data
    `ed`, from a file whose analysis groups are `analyses`, as summarize
    gives them for such a file."""
    s = _new_summary(file_name)
    return s, _summarize_events(s, ed, models, cfg, analyses)


def _summarize_events(s: ReadSummary, ed: fast5_io.EdEventData,
                      models: dict, cfg: Config, analyses) -> list:
    """Fill s from the read's event-detection data (Fast5_Summary.hpp:
    174-319, from the point where the events are read); returns the
    per-strand events."""
    file_name = s.file_name
    s.read_id = ed.read_id or s.read_id
    s.sampling_rate = ed.sampling_rate
    if not (1000.0 <= s.sampling_rate <= 10000.0):
        log.warning("%s: unexpected sampling rate: %s", file_name,
                    s.sampling_rate)
        return _no_events()
    num = min(len(ed.mean), cfg.max_ed_events)
    trim = cfg.trim_margins
    if num < trim[0] + trim[1] + cfg.min_ed_events:
        log.info("%s: not enough eventdetection events: %d", file_name, num)
        return _no_events()
    s.num_ed_events = num
    means = ed.mean[:num]
    from . import native

    s.abasic_level = native.abasic_level(
        means, cfg.abasic_level_top_percent, cfg.abasic_level_top_offset
    )
    if s.abasic_level <= 1.0:
        log.info("%s: abasic level too low: %s", file_name, s.abasic_level)
        s.num_ed_events = 0
        return _no_events()
    bounds = (trim[0], num - trim[1], 0, 0)
    if not cfg.template_only:
        bounds = detect_strands(num, means, s.abasic_level, trim)
    if bounds[1] <= bounds[0]:
        log.info("%s: no template strand detected", file_name)
        s.num_ed_events = 0
        return _no_events()
    s.strand_bounds = bounds
    # gated only on the resolved flag + strand sizes
    # (Fast5_Summary.hpp:210-212); the reference does NOT re-gate on
    # train/train_scaling here — `--no-train --double-strand-scaling`
    # still scales strands jointly (nanocall.cpp:269 passes the raw
    # switch; :1025 only resolves defaults when training)
    s.scale_strands_together = (
        cfg.double_strand_scaling
        and bounds[1] - bounds[0] >= cfg.min_ed_events
        and bounds[3] - bounds[2] >= cfg.min_ed_events
    )
    evs = filter_and_build_events(
        _truncate(ed, num), bounds, s.abasic_level, s.sampling_rate,
        s.scale_strands_together,
    )
    s.time_length = tuple(
        evs[st].time_length() if len(evs[st]) >= cfg.min_ed_events else 0.0
        for st in (0, 1)
    )
    initial_scaling(s, evs, models, cfg)
    s.bc_grp = fast5_io.next_basecall_group(list(analyses))
    return evs


def _truncate(ed: fast5_io.EdEventData, num: int) -> fast5_io.EdEventData:
    return dataclasses.replace(
        ed, mean=ed.mean[:num], stdv=ed.stdv[:num], start=ed.start[:num],
        length=ed.length[:num],
    )


def load_events(summary: ReadSummary, cfg: Config) -> list:
    """(Re)load and filter this read's per-strand events
    (Fast5_Summary::load_events, hpp:321-370)."""
    if summary.num_ed_events == 0:
        return _no_events()
    with fast5_io.Fast5File(summary.file_name) as f:
        ed = f.get_eventdetection_events(cfg.ed_group)
    ed = _truncate(ed, summary.num_ed_events)
    return filter_and_build_events(
        ed, summary.strand_bounds, summary.abasic_level, summary.sampling_rate,
        summary.scale_strands_together,
    )


def init_files(inputs: list) -> list:
    """Resolve CLI inputs into a list of fast5 files (nanocall.cpp:198-261):
    directories are scanned one level, non-fast5 files are read as fofn,
    '-' reads a fofn from stdin."""
    import sys

    files = []
    for f in inputs:
        if os.path.isdir(f):
            for g in sorted(os.listdir(f)):
                f2 = os.path.join(f, g)
                if os.path.isdir(f2):
                    log.info("ignoring subdirectory [%s]", f2)
                elif fast5_io.is_valid_file(f2):
                    files.append(f2)
                else:
                    log.info("ignoring file [%s]", f2)
        elif f != "-" and fast5_io.is_valid_file(f):
            files.append(f)
        else:
            # errors="replace": a CORRUPT binary file passed directly (bad
            # HDF5 signature -> lands in this fofn branch) must not abort
            # the run with UnicodeDecodeError; its garbage "lines" simply
            # name no valid files, like the reference's getline loop over
            # the same bytes (nanocall.cpp:228-253)
            fh = sys.stdin if f == "-" else open(f, errors="replace")
            try:
                for line in fh:
                    g = line.strip()
                    if g and fast5_io.is_valid_file(g):
                        files.append(g)
            finally:
                if f != "-":
                    fh.close()
    return files
