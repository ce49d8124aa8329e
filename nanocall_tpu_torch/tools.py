"""Developer tools mirroring the reference's Test-build CLIs (the port of
nanocall_tpu/tools.py):

  run-viterbi                 (run-viterbi.cpp)             -> `run-viterbi`
  run-fwbw                    (run-fwbw.cpp)                -> `run-fwbw`
  compute-state-transitions   (compute-state-transitions.cpp)
  compute-scaled-pore-model   (compute-scaled-pore-model.cpp)
  list-directory              (list-directory.cpp)

They read and write the same plain-text TSV formats (pore model,
transitions, events) as the JAX package's tools, with the same flags and
output, plus `--device {cuda,cpu}` on the two decoders (default cuda; a
missing GPU is an error, never a silent CPU run).  On the card run-viterbi
decodes by K6a + K6b, run-fwbw by K6c and `run-fwbw --custom-fwbw` by K6e;
those kernels take K = 6 only, so another `-K` on the card raises their
ValueError.  `--device cpu` runs the plain PyTorch versions at any K.
Invoke via `python -m nanocall_tpu_torch.tools <tool> ...`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import convert, events as events_mod, fast5_io, kmer, pore_model, \
    transitions
from .cli import resolve_device
from .ops import hmm


def _add_decode_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-p", "--pore-model", required=True)
    p.add_argument("-s", "--state-transitions", required=True)
    p.add_argument("-e", "--events", required=True)
    p.add_argument("-K", "--kmer-size", type=int, default=6)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for the decode (default: cuda)")


def _load_inputs(args):
    K = args.kmer_size
    pm = pore_model.load_tsv(args.pore_model, K=K)
    st = transitions.load_tsv(args.state_transitions, K=K)
    ev = events_mod.load_tsv(args.events)
    return pm, st, ev


def _decode_batch(args, pm, st, ev):
    """(TransOps, ModelArrays, events) of one read on the chosen device:
    the unscaled model, the loaded table, and the events padded by
    events.pad_batch (log_stdv taken on the host)."""
    device = resolve_device(args.device)
    return (convert.trans_ops(st, device),
            convert.model_arrays_from_pore_model(pm, device),
            convert.event_batch(events_mod.pad_batch([ev]), device))


def run_viterbi(argv) -> int:
    """Decode one TSV event sequence with a given (already scaled) model and
    transition table; print the base sequence (run-viterbi.cpp:38-57)."""
    p = argparse.ArgumentParser(prog="run-viterbi")
    _add_decode_args(p)
    args = p.parse_args(argv)
    pm, st, ev = _load_inputs(args)
    if len(ev) == 0:  # reference fill() loops are no-ops; empty base seq
        print("")
        return 0
    out = hmm.viterbi_decode(*_decode_batch(args, pm, st, ev))
    path = out["path"].cpu().numpy()[0, : len(ev)]
    moves = np.zeros(len(path), np.int32)
    if len(path) > 1:
        moves[1:] = kmer.min_skip(path[:-1], path[1:], args.kmer_size)
    print(kmer.moves_to_base_seq(path, moves, args.kmer_size))
    return 0


def run_fwbw(argv) -> int:
    """Posterior state distribution at the middle event, >= 0.1 printed in
    decreasing probability (run-fwbw.cpp:60-93); optional full matrix dump."""
    p = argparse.ArgumentParser(prog="run-fwbw")
    _add_decode_args(p)
    p.add_argument("-o", "--output", default="")
    p.add_argument("--custom-fwbw", action="store_true")
    args = p.parse_args(argv)
    pm, st, ev = _load_inputs(args)
    if len(ev) == 0:  # nothing to decode; no posterior lines
        return 0
    batch = _decode_batch(args, pm, st, ev)
    mid = len(ev) // 2
    # float32 numpy arrays, as the JAX tool formats them
    if args.custom_fwbw:
        out = {k: v.cpu().numpy()
               for k, v in hmm.fwbw_custom(*batch).items()}
        post = np.exp(out["gamma"][0, mid])
    else:
        out = {k: v.cpu().numpy() for k, v in hmm.fwbw(*batch).items()}
        post = np.exp(out["alpha"][0, mid] + out["beta"][0, mid]
                      - float(out["log_pr_data"][0]))
    # descending probability; ties in DESCENDING state order (the reference
    # pops a multiset<pair<v, j>> from the end, run-fwbw.cpp:83-88)
    n_post = len(post)
    order = np.lexsort((-np.arange(n_post), -post))
    for j in order:
        if post[j] < 0.1:
            break
        print(f"{kmer.int_to_kmer(int(j), args.kmer_size)}\t{post[j]:g}")
    if args.output:
        cols = [out[k][0, : len(ev)].tolist() for k in (
            ("alpha", "beta", "gamma") if args.custom_fwbw
            else ("alpha", "beta"))]
        with open(args.output, "w") as fh:
            for i in range(len(ev)):
                for j, vals in enumerate(zip(*(c[i] for c in cols))):
                    fh.write(f"{i}\t{j}\t" + "\t".join(f"{v:g}" for v in vals)
                             + "\n")
    return 0


def compute_state_transitions(argv) -> int:
    """Dump a transition table for given p_stay/p_skip
    (compute-state-transitions.cpp:30-49)."""
    p = argparse.ArgumentParser(prog="compute-state-transitions")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-p", "--pr-cutoff", type=float, default=0.001)
    p.add_argument("-k", "--pr-skip", type=float, default=0.28)
    p.add_argument("-t", "--pr-stay", type=float, default=0.09)
    p.add_argument("--fast", action="store_true")
    p.add_argument("-K", "--kmer-size", type=int, default=6)
    args = p.parse_args(argv)
    if args.fast:
        st = transitions.build_structured(
            transitions.TransitionParams(args.pr_stay, args.pr_skip), args.kmer_size
        )
    else:
        st = transitions.compute_transitions_dense(
            args.pr_skip, args.pr_stay, args.pr_cutoff, args.kmer_size
        )
    if args.output:
        transitions.save_tsv(st, args.output)
    else:
        kmers = kmer.all_kmer_strings(args.kmer_size)
        if isinstance(st, transitions.StructuredTransitions):
            it = transitions.structured_to_pairs(st)
        else:
            it = (
                (i, int(st.to_idx[k, i]), float(st.to_logp[k, i]))
                for i in range(st.n_states)
                for k in range(st.to_logp.shape[0])
                if np.isfinite(st.to_logp[k, i])
            )
        for i, j, lp in it:
            sys.stdout.write(f"{kmers[i]}\t{kmers[j]}\t{lp:g}\n")
    return 0


def compute_scaled_pore_model(argv) -> int:
    """Read model + trained params from a fast5 basecall group, apply
    scaling, dump the TSV (compute-scaled-pore-model.cpp:29-44).  Needs
    h5py."""
    p = argparse.ArgumentParser(prog="compute-scaled-pore-model")
    p.add_argument("-f", "--file-name", required=True)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-g", "--group", default="", help="basecall group (default: first Nanocall_*)")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-K", "--kmer-size", type=int, default=6)
    args = p.parse_args(argv)
    if fast5_io.h5py is None:
        raise RuntimeError("reading fast5 files needs h5py, which is not installed")

    with fast5_io.h5py.File(args.file_name, "r") as f:
        grp_name = args.group
        if not grp_name:
            cands = [g for g in f["/Analyses"] if g.startswith("Nanocall_")]
            if not cands:
                raise SystemExit("no Nanocall_* basecall group found")
            grp_name = sorted(cands)[0]
        sub = fast5_io.STRAND_GROUP[args.strand]
        g = f[f"/Analyses/{grp_name}/{sub}"]
        tbl = g["Model"][()]
        params = pore_model.PoreModelParams(
            **{k: float(g.attrs[k]) for k in
               ("scale", "shift", "drift", "var", "scale_sd", "var_sd")}
        )
    n = kmer.n_states(args.kmer_size)
    pm = pore_model.PoreModel(
        level_mean=np.asarray(tbl["level_mean"], np.float32),
        level_stdv=np.asarray(tbl["level_stdv"], np.float32),
        sd_mean=np.asarray(tbl["sd_mean"], np.float32),
        sd_stdv=np.asarray(tbl["sd_stdv"], np.float32),
        K=args.kmer_size,
    )
    assert pm.level_mean.shape[0] == n
    spm = pm.scaled(params)
    if args.output:
        pore_model.save_tsv(spm, args.output)
    else:
        kmers = kmer.all_kmer_strings(args.kmer_size)
        for i in range(n):
            sys.stdout.write(
                f"{kmers[i]}\t{spm.level_mean[i]:g}\t{spm.level_stdv[i]:g}"
                f"\t{spm.sd_mean[i]:g}\t{spm.sd_stdv[i]:g}\n"
            )
    return 0


def list_directory(argv) -> int:
    """Directory listing helper (list-directory.cpp / fs_support.hpp)."""
    p = argparse.ArgumentParser(prog="list-directory")
    p.add_argument("path")
    args = p.parse_args(argv)
    if not os.path.isdir(args.path):
        print(f"not a directory: {args.path}", file=sys.stderr)
        return 1
    for name in sorted(os.listdir(args.path)):
        print(name)
    return 0


TOOLS = {
    "run-viterbi": run_viterbi,
    "run-fwbw": run_fwbw,
    "compute-state-transitions": compute_state_transitions,
    "compute-scaled-pore-model": compute_scaled_pore_model,
    "list-directory": list_directory,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m nanocall_tpu_torch.tools {{{'|'.join(TOOLS)}}} ...")
        return 2
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
