"""Typed run configuration (a copy of nanocall_tpu/config.py, with the
fields the port reads).

One dataclass replaces the reference's TCLAP option namespace + mutable
static singletons (nanocall.cpp:50-95,923-991).  Defaults match the
reference CLI defaults; `apply_pore_preset` mirrors the r73/r9 preset logic
(nanocall.cpp:943-964).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # model selection
    pore: str = "r9"  # reference default (nanocall.cpp:91); both r73 and
    # r9 builtin model banks ship in models/builtin.npz.
    model_files: list = dataclasses.field(default_factory=list)  # "strand:file"
    model_fofn: str = ""
    trans_file: str = ""
    # transition priors (nanocall.cpp:84-85)
    pr_stay: float = 0.1
    pr_skip: float = 0.3
    # event-detection input (nanocall.cpp:56,61-66)
    ed_group: str = ""
    min_ed_events: int = 10
    max_ed_events: int = 100000
    trim_ed_sq_start: int = 50
    trim_ed_sq_end: int = 50
    trim_ed_hp_start: int = 50
    trim_ed_hp_end: int = 50
    # training (nanocall.cpp:69-80)
    train: bool = True
    train_scaling: bool = True
    train_transitions: bool = True
    train_drift: bool | None = None  # None -> pore preset decides
    double_strand_scaling: bool = True
    scaling_select_threshold: float = 20.0
    scaling_min_progress: float = 1.0
    scaling_max_rounds: int = 10
    scaling_num_events: int = 200
    # basecalling
    basecall: bool = True
    template_only: bool = False  # --1d
    # strand/hairpin detection presets (nanocall.cpp:943-964)
    abasic_level_top_percent: float = 1.0
    abasic_level_top_offset: float = 5.0
    hairpin_island_window_size: int = 5
    hairpin_island_window_load: int = 5
    # output
    output: str = ""
    write_fast5: bool = False
    fasta_line_width: int = 80
    stats_fn: str = ""
    # execution
    kmer_size: int = 6
    # most tasks in one decode chunk (path chunks are further capped by
    # shapes.BP_BUDGET)
    bucket_max_batch: int = 256
    # most tasks in one score-only chunk; 0 = the path chunks' cap
    score_max_batch: int = 0
    # training groups per EM chunk (4 rows each)
    train_group_batch: int = 128
    # two-phase EM: run every group this many rounds, then repack only the
    # still-unconverged groups and continue from their carries (a chunk
    # otherwise waits on its slowest group; the trajectory is the same).
    # 0 = single phase.
    em_phase1_rounds: int = 8
    # ingest worker processes (-1 = auto: cpu_count-1 capped at 6; 0/1 =
    # in-process); see ingest.py
    ingest_workers: int = -1
    # devices the data sharder splits chunks over (parallel/mesh.py):
    # 0 = every local device of the run's kind
    num_shards: int = 0

    def apply_pore_preset(self) -> "Config":
        """r73/r9 presets for abasic/hairpin/drift knobs (nanocall.cpp:943-964)."""
        if self.pore == "r9":
            self.abasic_level_top_percent = 1.0
            self.abasic_level_top_offset = 0.0
            self.hairpin_island_window_size = 10
            self.hairpin_island_window_load = 5
            if self.train_drift is None:
                self.train_drift = False
        elif self.pore == "r73":
            self.abasic_level_top_percent = 1.0
            self.abasic_level_top_offset = 5.0
            self.hairpin_island_window_size = 5
            self.hairpin_island_window_load = 5
            if self.train_drift is None:
                self.train_drift = True
        else:
            raise ValueError(f"unknown pore type: {self.pore}")
        return self

    @property
    def trim_margins(self) -> tuple[int, int, int, int]:
        return (
            self.trim_ed_sq_start,
            self.trim_ed_sq_end,
            self.trim_ed_hp_start,
            self.trim_ed_hp_end,
        )
