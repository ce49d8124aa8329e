"""Command-line interface: `python -m nanocall_tpu_torch ...`.

The flag surface of `python -m nanocall_tpu` (nanocall_tpu/cli.py, which
imports JAX and so cannot be imported here), plus `--device`.  The port runs
the default trained pipeline (EM training, then decode), the untrained
decode (`--no-train`) and the decode of a `--resume-stats` run, each also
under a loaded transition table (`-s/--trans`); flags whose paths are not
ported yet (`--dump-training-data`, `--trace-dir`, multi-host) raise
NotImplementedError instead of running something else.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from . import basecall, fast5_io, ingest, output, pore_model, \
    read_pipeline, transitions
from .config import Config
from .models import load_builtin_models
from .observe import StageTimer, set_levels_from_options
from .util import zopen
from .version import get_version

log = logging.getLogger("nanocall")

PROG = "nanocall-tpu-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Call bases in Oxford Nanopore reads (PyTorch / CUDA).",
    )
    p.add_argument("--version", action="version", version=get_version())
    p.add_argument("inputs", nargs="+", help="directories, fast5 files, or fofn files ('-' = stdin)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for training and decode (default: cuda; "
                   "a missing GPU is an error, never a silent CPU run)")
    p.add_argument("--ed-group", default="", help="EventDetection group to use")
    p.add_argument("--chunk-size", type=int, default=1,
                   help="(accepted for CLI parity; device bucketing replaces thread chunking)")
    p.add_argument("--log", action="append", default=[], help="log level")
    p.add_argument("--stats", dest="stats_fn", default="", help="stats TSV output")
    p.add_argument("--train-drift", default="", choices=["", "0", "1"])
    p.add_argument("--trim-ed-hp-end", type=int, default=50)
    p.add_argument("--trim-ed-hp-start", type=int, default=50)
    p.add_argument("--trim-ed-sq-end", type=int, default=50)
    p.add_argument("--trim-ed-sq-start", type=int, default=50)
    p.add_argument("--max-ed-events", type=int, default=100000)
    p.add_argument("--min-ed-events", type=int, default=10)
    p.add_argument("--fasta-line-width", type=int, default=80)
    p.add_argument("--scaling-select-threshold", type=float, default=20.0)
    p.add_argument("--scaling-min-progress", type=float, default=1.0)
    p.add_argument("--scaling-max-rounds", type=int, default=10)
    p.add_argument("--scaling-num-events", type=int, default=200)
    p.add_argument("--1d", dest="template_only", action="store_true",
                   help="interpret entire read as 1D template only")
    p.add_argument("--single-strand-scaling", action="store_true")
    p.add_argument("--double-strand-scaling", action="store_true")
    p.add_argument("--no-train-transitions", action="store_true")
    p.add_argument("--no-train-scaling", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--basecall", action="store_true")
    p.add_argument("--no-basecall", action="store_true")
    p.add_argument("--pr-skip", type=float, default=0.3)
    p.add_argument("--pr-stay", type=float, default=0.1)
    p.add_argument("-s", "--trans", dest="trans_fn", default="")
    p.add_argument("--model-fofn", default="")
    p.add_argument("-m", "--model", action="append", default=[],
                   help="custom pore model 'strand:file' (0=template, 1=complement, 2=both)")
    p.add_argument("--pore", default="r9", choices=["r73", "r9"])
    p.add_argument("--write-fast5", action="store_true")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-t", "--threads", type=int, default=-1,
                   help="host ingest worker processes (default: auto)")
    p.add_argument("--batch", type=int, default=256, help="decode bucket batch size")
    p.add_argument("--trace-dir", default="", help="(not ported yet)")
    p.add_argument("--resume-stats", default="",
                   help="resume from a --stats TSV of a previous run (skips training)")
    p.add_argument("--dump-training-data", default="", metavar="DIR",
                   help="(not ported yet)")
    p.add_argument("--coordinator", default="", help="(not ported yet)")
    p.add_argument("--num-hosts", type=int, default=1, help="(not ported yet)")
    p.add_argument("--host-id", type=int, default=0, help="(not ported yet)")
    return p


def config_from_args(args) -> Config:
    """Resolve flags into a Config exactly as nanocall_tpu.cli does
    (nanocall.cpp:995-1052)."""
    cfg = Config(
        pore=args.pore, model_files=args.model, model_fofn=args.model_fofn,
        trans_file=args.trans_fn, pr_stay=args.pr_stay, pr_skip=args.pr_skip,
        ed_group=args.ed_group, min_ed_events=args.min_ed_events,
        max_ed_events=args.max_ed_events,
        trim_ed_sq_start=args.trim_ed_sq_start,
        trim_ed_sq_end=args.trim_ed_sq_end,
        trim_ed_hp_start=args.trim_ed_hp_start,
        trim_ed_hp_end=args.trim_ed_hp_end,
        scaling_select_threshold=args.scaling_select_threshold,
        scaling_min_progress=args.scaling_min_progress,
        scaling_max_rounds=args.scaling_max_rounds,
        scaling_num_events=args.scaling_num_events,
        template_only=args.template_only, output=args.output,
        write_fast5=args.write_fast5, fasta_line_width=args.fasta_line_width,
        stats_fn=args.stats_fn, bucket_max_batch=args.batch,
        ingest_workers=args.threads,
    )
    if args.train and args.no_train:
        raise SystemExit("either --train or --no-train may be used, but not both")
    cfg.train = not args.no_train
    if args.basecall and args.no_basecall:
        raise SystemExit("either --basecall or --no-basecall may be used, but not both")
    cfg.basecall = not args.no_basecall
    cfg.train_scaling = not args.no_train_scaling
    cfg.train_transitions = not args.no_train_transitions
    if cfg.train and cfg.train_scaling:
        if args.single_strand_scaling and args.double_strand_scaling:
            raise SystemExit(
                "either --single-strand-scaling or --double-strand-scaling may be used, but not both"
            )
        cfg.double_strand_scaling = not args.single_strand_scaling
    else:
        cfg.double_strand_scaling = args.double_strand_scaling
    if args.scaling_select_threshold < 0.0:
        raise SystemExit(
            f"invalid scaling_select_threshold: {args.scaling_select_threshold}")
    if args.scaling_min_progress < 0.0:
        raise SystemExit(
            f"invalid scaling_min_progress: {args.scaling_min_progress}")
    if args.train_drift:
        cfg.train_drift = args.train_drift == "1"
    cfg.apply_pore_preset()
    if cfg.output and cfg.write_fast5:
        raise SystemExit(
            "output may be written to fast5 files or to a single output file, but not both"
        )
    return cfg


def _refuse_unported(args, cfg: Config) -> None:
    """Raise for every flag whose path the port does not run yet."""
    missing = []
    if args.dump_training_data:
        missing.append("--dump-training-data")
    if args.num_hosts > 1 or args.coordinator:
        missing.append("multi-host runs (--num-hosts, --coordinator)")
    if args.trace_dir:
        missing.append("--trace-dir")
    if missing:
        raise NotImplementedError(
            "not ported to nanocall_tpu_torch yet: " + "; ".join(missing))


def resolve_device(name: str) -> torch.device:
    """The decode device; `cuda` without a usable GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu "
            "to run the plain PyTorch versions of the kernels on the CPU)")
    return device


def init_models(cfg: Config) -> dict:
    """User or builtin pore models, in name order (nanocall_tpu/cli.py:149,
    nanocall.cpp:97-178)."""
    specs = list(cfg.model_files)
    if cfg.model_fofn:
        with zopen(cfg.model_fofn) as fh:
            specs += [line.strip() for line in fh if line.strip()]
    models = {}
    if specs:
        by_strand = {0: [], 1: [], 2: []}
        for s in specs:
            if len(s) < 3 or s[0] not in "012" or s[1] != ":":
                raise SystemExit(
                    f'could not parse model name: "{s}"; format should be "[0|1|2]:<file>"'
                )
            by_strand[int(s[0])].append(s[2:])
        if not by_strand[2] and (bool(by_strand[0]) != bool(by_strand[1])):
            raise SystemExit(
                "models were specified for only one strand; give models for both strands, or for neither"
            )
        for st in (0, 1, 2):
            for path in by_strand[st]:
                pm = pore_model.load_tsv(path, K=cfg.kmer_size, strand=st, name=path)
                models[path] = pm
                log.info("loaded model [%s] for strand [%d] statistics "
                         "[mean=%g, stdv=%g]", path, st, pm.mean(), pm.stdv())
    else:
        models = load_builtin_models(cfg.pore, cfg.kmer_size)
        if not models:
            raise SystemExit(f"no builtin models found for pore [{cfg.pore}]")
        for name, pm in models.items():
            log.info("loaded builtin model [%s] for strand [%d]", name, pm.strand)
    return dict(sorted(models.items()))


def init_transitions(cfg: Config):
    """The default transition table (nanocall_tpu/cli.py:195-205,
    nanocall.cpp:180-193): a `--trans` file's SparseTransitions, or the
    structured table of the priors."""
    if cfg.trans_file:
        st = transitions.load_tsv(cfg.trans_file, cfg.kmer_size)
        log.info("loaded state transitions from [%s]", cfg.trans_file)
        return st
    st = transitions.build_structured(
        transitions.TransitionParams(cfg.pr_stay, cfg.pr_skip), cfg.kmer_size)
    log.info("init_state_transitions pr_skip=[%g], pr_stay=[%g]",
             cfg.pr_skip, cfg.pr_stay)
    return st


def _echo_options(args, argv, cfg: Config) -> None:
    """Resolved-option echo lines (nanocall_tpu/cli.py:216-254)."""
    log.info("program: %s", PROG)
    log.info("version: %s", get_version())
    prog = sys.argv[0] if argv is None else PROG
    log.info("args: %s", " ".join([prog] + list(argv if argv is not None else sys.argv[1:])))
    log.info("num_threads=%d", ingest._resolve_workers(args.threads))
    log.info("device=%s", args.device)
    log.info("eventdetection_group=%s", cfg.ed_group or "smallest")
    log.info("ed_event_trimming:  sq_start=%d sq_end=%d hp_start=%d hp_end=%d",
             *cfg.trim_margins)
    if not cfg.template_only:
        log.info(
            "hairpin_detection: abasic_level_top_percent=%g "
            "abasic_level_top_offset=%g hairpin_island_window_size=%d "
            "hairpin_island_window_load=%d",
            cfg.abasic_level_top_percent, cfg.abasic_level_top_offset,
            cfg.hairpin_island_window_size, cfg.hairpin_island_window_load,
        )
    else:
        log.info("hairpin_detection: disabled")
    log.info("train=%d", cfg.train)
    log.info("basecall=%d", cfg.basecall)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = set_levels_from_options(args.log)
    logging.basicConfig(level=level, format="%(name)s: %(levelname)s: %(message)s")
    cfg = config_from_args(args)
    _refuse_unported(args, cfg)
    _echo_options(args, argv, cfg)
    if fast5_io.h5py is None:
        raise RuntimeError("reading fast5 files needs h5py, which is not installed")
    # fork the ingest workers while the process is still single-threaded,
    # before anything initialises CUDA
    ingest.ensure_pool(cfg.ingest_workers)
    device = resolve_device(args.device)

    models = init_models(cfg)
    default_transitions = init_transitions(cfg)
    files = read_pipeline.init_files(args.inputs)
    if not files:
        raise SystemExit("no fast5 files to process")
    for f in files:
        log.info("adding input file [%s]", f)

    timer = StageTimer()
    stream = ingest.ingest_stream(files, models, cfg)
    defaults = transitions.TransitionParams(cfg.pr_stay, cfg.pr_skip)
    results = []
    if not args.resume_stats:
        summaries, results = basecall.run_pipeline(
            stream, models, cfg, device, timer=timer,
            default_transitions=default_transitions)
    else:
        with timer.stage("init_reads"):
            summaries, pool = basecall.ingest_reads(stream, cfg, device)
        n = output.apply_resume(summaries, output.load_stats(args.resume_stats),
                                defaults)
        log.info("resumed trained parameters for %d reads from [%s]",
                 n, args.resume_stats)
        if cfg.basecall:
            with timer.stage("basecalling"):
                results = basecall.basecall_reads(summaries, models, cfg, pool,
                                                  default_transitions)

    write_outputs(summaries, results, models, cfg)
    return 0


def write_outputs(summaries, results, models, cfg: Config) -> None:
    """A run's basecalls (fast5 files, cfg.output or stdout) and its stats
    TSV (cfg.stats_fn), as nanocall_tpu/cli.py writes them."""
    if cfg.basecall:
        if cfg.write_fast5:
            output.write_results_fast5(results, summaries, models, cfg)
        elif cfg.output:
            # write-then-rename: the file exists only when complete
            tmp = cfg.output + ".tmp"
            with open(tmp, "w") as fh:
                output.write_results_fasta(fh, results, cfg.fasta_line_width)
            os.replace(tmp, cfg.output)
        else:
            output.write_results_fasta(sys.stdout, results, cfg.fasta_line_width)
    if cfg.stats_fn:
        with open(cfg.stats_fn, "w") as fh:
            output.write_stats(fh, summaries, transitions.TransitionParams(
                cfg.pr_stay, cfg.pr_skip))


if __name__ == "__main__":
    sys.exit(main())
