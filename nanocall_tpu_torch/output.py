"""Output writers: FASTA, stats TSV, fast5 write-back (a copy of
nanocall_tpu/output.py).

Mirrors write_fasta (nanocall.cpp:584-591), the --stats TSV
(Fast5_Summary.hpp:460-502), and the --write-fast5 path
(nanocall.cpp:770-776,843-849).
"""

from __future__ import annotations

from . import fast5_io
from .pore_model import PoreModelParams
from .transitions import TransitionParams


def write_fasta(fh, name: str, seq: str, line_width: int = 80) -> None:
    fh.write(f">{name}\n")
    for pos in range(0, len(seq), line_width):
        fh.write(seq[pos : pos + line_width] + "\n")


def write_results_fasta(fh, results, line_width: int = 80) -> None:
    for r in results:
        write_fasta(fh, r.seq_name, r.base_seq, line_width)


def write_results_fast5(results, summaries, models, cfg) -> None:
    """Persist basecalls into the source fast5 files under the reserved
    Nanocall_NNN group.

    Per-read graceful degradation like the reference's HDF5 write-back
    (Fast5_Summary.hpp:379-437 wraps each write; a locked/read-only/corrupt
    file must not abort the run and discard every other read's results)."""
    import logging

    log = logging.getLogger("nanocall")
    for r in results:
        s = summaries[r.read_idx]
        pm = models[r.model_name]
        params = s.pm_params[r.key]
        p_states = [0.0] * len(r.path)
        table = fast5_io.basecall_event_table(
            r.ev, r.path, r.moves, p_states, cfg.kmer_size
        )
        try:
            with fast5_io.Fast5File(s.file_name, rw=True) as f:
                f.add_basecall_seq(r.strand, s.bc_grp, r.seq_name, r.base_seq)
                f.add_basecall_events(r.strand, s.bc_grp, table)
                f.add_basecall_model(r.strand, s.bc_grp, fast5_io.model_table(pm))
                f.add_basecall_model_params(r.strand, s.bc_grp, params)
        except Exception as e:
            # broad on purpose: h5py surfaces corrupt/locked files as
            # KeyError/ValueError/RuntimeError as well as OSError, and ONE
            # bad file must not abort the run and discard every remaining
            # read's write-back (the reference wraps each write in a
            # catch-all the same way, Fast5_Summary.hpp:379-437)
            log.warning(
                "error writing basecalls for read [%s] to [%s]: %s",
                r.seq_name, s.file_name, e,
            )


STATS_COLUMNS = (
    "file_name\tread_name\tnum_ed_events\tabasic_level"
    "\ttemplate_start_idx\ttemplate_end_idx"
    "\tcomplement_start_idx\tcomplement_end_idx"
)


def write_stats_header(fh) -> None:
    fh.write(STATS_COLUMNS)
    for st in (0, 1):
        fh.write(
            f"\tn{st}_model_name\tn{st}_scale\tn{st}_shift\tn{st}_drift"
            f"\tn{st}_var\tn{st}_scale_sd\tn{st}_var_sd"
            f"\tn{st}_p_stay\tn{st}_p_skip"
        )
    fh.write("\n")


def write_stats_row(fh, s, defaults: TransitionParams | None = None) -> None:
    # Values print at the reference's %.5f precision (column-exact parity
    # with its --stats writer, Fast5_Summary.hpp:460-502) — so a
    # --resume-stats run decodes from 5-decimal-rounded params and can
    # flip a near-tie base vs the original full-precision decode
    # (documented in test_resume_from_stats); resume itself is
    # deterministic.
    # Absent strands print default-constructed params; the reference's
    # defaults TRACK the CLI --pr-stay/--pr-skip (nanocall.cpp:923-924 sets
    # the State_Transition_Parameters statics), so callers pass them in
    defaults = defaults or TransitionParams()
    fh.write(
        f"{s.base_file_name}\t{s.read_id}\t{s.num_ed_events}\t{s.abasic_level:g}"
        f"\t{s.strand_bounds[0]}\t{s.strand_bounds[1]}"
        f"\t{s.strand_bounds[2]}\t{s.strand_bounds[3]}"
    )
    for st in (0, 1):
        name = s.preferred_model.get(st, "")
        key = None
        if name:
            # find a candidate key for this strand's preferred model
            if s.preferred_model.get(2):
                key = s.preferred_model[2]
            else:
                key = (name, "") if st == 0 else ("", name)
            if key not in s.pm_params:
                key = None
        if name and key is not None:
            fh.write(f"\t{name}\t{s.pm_params[key].write_tsv()}\t")
            p = s.st_params[key][st]
            fh.write(f"{p.p_stay:.5f}\t{p.p_skip:.5f}")
        else:
            fh.write(f"\t.\t{PoreModelParams().write_tsv()}\t")
            fh.write(f"{defaults.p_stay:.5f}\t{defaults.p_skip:.5f}")
    fh.write("\n")


def write_stats(fh, summaries, defaults: TransitionParams | None = None) -> None:
    write_stats_header(fh)
    for s in summaries:
        write_stats_row(fh, s, defaults)


def load_stats(path) -> dict:
    """Parse a stats TSV back into per-read trained parameters — the
    checkpoint/resume path: a rerun with --resume-stats skips EM training
    and decodes with these parameters (the reference's closest analogue is
    its per-read stats dump + fast5 write-back, SURVEY.md section 5).

    Returns {(file_name, read_name): {strand: (model_name, PoreModelParams,
    TransitionParams)}}.  Keyed by BOTH columns: read names are not unique
    across files (fast5 read ids are producer-assigned), and keying by
    read_name alone crossed parameters between same-named reads.
    """
    out = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        idx = {c: i for i, c in enumerate(header)}
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < len(header):
                continue
            rec = {}
            for st in (0, 1):
                name = f[idx[f"n{st}_model_name"]]
                if name == ".":
                    continue
                pm = PoreModelParams(
                    scale=float(f[idx[f"n{st}_scale"]]),
                    shift=float(f[idx[f"n{st}_shift"]]),
                    drift=float(f[idx[f"n{st}_drift"]]),
                    var=float(f[idx[f"n{st}_var"]]),
                    scale_sd=float(f[idx[f"n{st}_scale_sd"]]),
                    var_sd=float(f[idx[f"n{st}_var_sd"]]),
                )
                sp = TransitionParams(
                    float(f[idx[f"n{st}_p_stay"]]), float(f[idx[f"n{st}_p_skip"]])
                )
                rec[st] = (name, pm, sp)
            out[(f[idx["file_name"]], f[idx["read_name"]])] = rec
    return out


def apply_resume(summaries, stats: dict,
                 defaults: TransitionParams | None = None) -> int:
    """Install resumed parameters into read summaries; returns the number of
    reads restored.  Restored reads get a preferred model per strand, so
    training is skipped and decoding uses the stored parameters.  `defaults`
    fills the unused strand's transition-param slot (CLI --pr-stay/--pr-skip)."""
    n = 0
    for s in summaries:
        rec = stats.get((s.base_file_name, s.read_id))
        if not rec or s.num_ed_events == 0:
            continue
        strands = sorted(rec)
        if s.scale_strands_together and len(strands) == 2:
            key = (rec[0][0], rec[1][0])
            # a joint key carries ONE pm-param set for both strands; stats
            # from a per-strand-scaling run may carry two different sets,
            # which cannot be represented jointly — resume per-strand then
            if rec[0][1].as_array().tolist() != rec[1][1].as_array().tolist():
                import logging

                logging.getLogger("nanocall").warning(
                    "resume: read [%s] stats carry per-strand pm_params; "
                    "resuming per-strand (ignoring --double-strand-scaling)",
                    s.read_id,
                )
                s.scale_strands_together = False
            else:
                s.pm_params[key] = rec[0][1]
                s.st_params[key] = [rec[0][2], rec[1][2]]
                s.preferred_model[2] = key
                for st in strands:
                    s.preferred_model[st] = rec[st][0]
        if not (s.scale_strands_together and len(strands) == 2):
            s.scale_strands_together = False
            for st in strands:
                name, pm, sp = rec[st]
                key = (name, "") if st == 0 else ("", name)
                s.pm_params[key] = pm
                filler = defaults or TransitionParams()
                sps = [filler, filler]
                sps[st] = sp
                s.st_params[key] = sps
                s.preferred_model[st] = name
        n += 1
    return n
