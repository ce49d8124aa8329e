#!/usr/bin/env python3
"""Time the port's decode and pipeline on one NVIDIA GPU at main-path shapes.

    python3 tools/torch_decode_times.py [--B 128] [--T 8192] [--reads 256]
                                        [--train] [--trans FILE] [--profile]
                                        [--long 100000] [--em] [--census]
                                        [--k4-launches] [--walks]
                                        [--custom]
                                        [--tree DIR | --turns DIR]

1. K8, the measured float32 peak at the decode's shape
   (nanocall_tpu_torch.roofline.measure_fma_peak: B rows x n = 4096 lanes
   x T steps of k FMAs, k = roofline.FMA_K = matched_fma_k(4096) = 24, K1's
   step's work, as bench.py matches it); then K1 (path and score-only) and K2
   against their plain PyTorch versions at B reads x T events (n = 4096):
   bit-equality and milliseconds per call (CUDA events), built with
   chip_smoke.py's inputs; with --trans, also K6a's two kernels
   (streaming and resident, path and score-only: timed in turns, streaming,
   resident, resident, streaming, with the card's nvidia-smi line sampled
   beside each time) and K6b under that table, then K6b's two kernels
   (streaming and, in a tree that has it, the ring: streaming, ring, ring,
   streaming) on K6a's output as drawn and with every length T, bit-equal
   to each other, with the rows the ring streams and their time at 3.35
   TB/s.  For each kernel: its
   bound, its achieved
   float32 operations per second (roofline.kernel_shares: its count
   over its time) and that rate's share of the H100's 67 TFLOP/s and of
   the measured K8 peak; then roofline.mfu_report for the decode (K1 +
   K2) at B x T;
2. the untrained pipeline (nanocall_tpu_torch.basecall.run_pipeline,
   `--no-train --pore r73`) on `--reads` reads drawn by
   nanocall_tpu_torch.simulate (80% 1D reads of 2,000-8,000 events, 20%
   hairpin reads of 3,000 + 3,000): wall seconds
   per stage and events/s; with --train, the default trained pipeline
   instead (EM training by K4 + K5, then the decode); with --trans FILE, the
   same run under the transitions table FILE (`-s FILE`: legacy EM rounds
   by K6c, K4 and K6d, and the decode of the tasks at the priors by K6a and
   K6b); with --profile, device time by kernel from torch.profiler over a
   third run, each hand-written kernel's share of the device time, and the
   device's busy share of that run's wall time (the summed device time of
   the device-side events: kernels and copies);
3. with --long N, the long-read decode at the bucket of N events (N =
   100000 gives T = 100352) and the path batch cap there (83 reads under
   shapes.BP_BUDGET): the chunked-time decode
   (K3, chunks of batching.tchunk_len(T) events) against the full scan
   (K1 + K2) on chip_smoke.py's inputs, in the order full, chunked,
   chunked, full: bit-equality, wall milliseconds and peak device memory of
   each, and the kernels' bounds there; then one 1D read of N events
   through the pipeline (which takes K3 there): wall seconds and peak
   device memory.

With --em, also K4 and K5 at the EM chunk's shape (chip_smoke.py's 128
training groups x 4 = 512 rows of T = 128 events, packed from simulated
reads): bit-equality with the plain versions, milliseconds per call (K4
with and without its alpha store, and on the chunk with its second half
of length 0, as 1D reads leave a trained run's chunks), bounds and
kernel_shares against the K8 peak measured at 512 x 128; then K6c there
under the loaded tables of (0.14, 0.21) and of the CLI priors (0.1,
0.3): the streaming kernel (the
table's TransOps without a K6c layout) and, in a tree that has it, the
resident kernel, timed in turns (streaming, resident, resident, streaming)
and bit-equal to each other, and the resident kernel under the (0.14,
0.21) table cut to 19 slots a side and extended to 23 (slots 0 and 1
repeated), the slot counts on either side of the loaded tables' 21.
With --em, K6d (the grouped backward, betas stored) too, on the full chunk
and on the chunk with half its rows of length 0: bit-equal to its plain
version, timed in the same turns as K4 and K5.
With --walks, phase 1 is replaced by the traceback walks alone: K2 at
--B x --T on K1's output, K3's traceback chunk and K9's states chunk on
events [8192, 16384) of 4 reads, each bit-equal to its plain version and
timed (the mean of 2 x WALK_REPS calls, in the order K2, K3, K9, K9, K3,
K2), and K2 probed under a NaN stay entry (16 x 512): bit-equal to its
plain version or not (torch.argmax takes the first NaN).
With --custom, also K6e (the per-step-normalized forward-backward of
`run-fwbw --custom-fwbw`) under the loaded table of (0.14, 0.21) at 16
reads x 2048 events (chip_smoke.py's inputs) and at 1 read x 4000 events
(the smoke's run-fwbw read's length): the streaming kernel and, in a
tree that has it, the resident one, bit-equal to each other and timed in
turns (streaming, resident, resident, streaming).
With --train --k4-launches, also K4 on the inputs of each of its launches
in one more trained pipeline run: milliseconds per launch.  Phase 1 also
times K3's forward chunk (events [8192, 16384) of 4 reads, chunks of 8192)
and probes K1 under a NaN stay entry (16 x 512): bit-equal or not.

--tree DIR runs all of it on the checkout in DIR (its package and its
chip_smoke.py), e.g. the parent commit unpacked by `git archive`;
--turns DIR runs the tool with the other flags on DIR, on this checkout,
on this checkout again and on DIR (parent, change, change, parent), one
process each, so that two commits' kernels are timed on one card in one
call.

Phase 1 prints each kernel's bound (roofline.kernel_bound: the H100's
published memory and float32 rates) beside its time; every pipeline run
prints the launches of each hand-written kernel.

--B 0 or --reads 0 skips phase 1 or 2.  A table for --trans:
`python3 -c 'from nanocall_tpu_torch import convert;
convert.write_fast_transitions("trans.tsv", 0.14, 0.21)'` writes what
`compute-state-transitions --fast -t 0.14 -k 0.21` does.

Every line carries the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
chip_smoke = None  # the checkout's chip_smoke module, imported by main()

#: the hand-written kernels' function names in nanocall_tpu_torch/csrc
KERNEL_FUNCTIONS = ("viterbi_forward_kernel", "viterbi_traceback_kernel",
                    "viterbi_traceback_chunk_kernel",
                    "fwbw_forward_kernel", "em_backward_kernel",
                    "viterbi_generic_forward_kernel",
                    "viterbi_resident_forward_kernel",
                    "viterbi_generic_traceback_kernel",
                    "viterbi_generic_traceback_ring_kernel",
                    "fwbw_generic_kernel", "fwbw_resident_kernel",
                    "fwbw_backward_kernel", "fwbw_custom_kernel",
                    "fwbw_custom_resident_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--T", type=int, default=8192)
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--trans", default="", metavar="FILE",
                    help="run under this transitions table (-s FILE)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--long", type=int, default=0)
    ap.add_argument("--em", action="store_true")
    ap.add_argument("--census", action="store_true",
                    help="print the SASS census of the kernels' time loops")
    ap.add_argument("--k4-launches", action="store_true",
                    help="time K4 on each launch's inputs of a trained run")
    ap.add_argument("--walks", action="store_true",
                    help="time the traceback walks (K2, K3, K9) alone in "
                         "place of phase 1")
    ap.add_argument("--custom", action="store_true",
                    help="time K6e's kernels at 16 x 2048 and 1 x 4000")
    ap.add_argument("--tree", default="", metavar="DIR",
                    help="run on the checkout in DIR")
    ap.add_argument("--turns", default="", metavar="DIR",
                    help="run on DIR, here, here, DIR")
    args = ap.parse_args()
    if args.turns:
        return run_turns(args.turns)

    global chip_smoke
    root = os.path.abspath(args.tree) if args.tree else ROOT
    sys.path.insert(0, root)
    import chip_smoke

    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall, batching, cli, ingest, \
        read_pipeline, roofline, shapes, simulate
    from nanocall_tpu_torch.ops import _cuda, hmm, kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = chip_smoke.smi_line()
    device = torch.device("cuda", 0)
    _cuda.load()
    models = cli.init_models(chip_smoke.smoke_config())
    # the reads do not depend on --B: phase 1 draws from its own generator
    rng = np.random.default_rng(11)
    trans_flags = ["-s", args.trans] if args.trans else []
    table = (cli.init_transitions(chip_smoke.smoke_config(*trans_flags))
             if args.trans else None)

    if args.census:
        print_census()

    if args.walks:
        time_walks(models, device, card, args.B, args.T)
    elif args.B:
        k = roofline.FMA_K
        peak, seconds = roofline.measure_fma_peak(args.B, 4096, args.T, k=k)
        print(f"K8 peak (measure_fma_peak) B={args.B} n=4096 T={args.T} "
              f"k={k}: {peak / 1e12:.3f} TFLOP/s = "
              f"{100 * peak / roofline.H100_F32_OPS_PER_S:.2f}% of 67 "
              f"TFLOP/s, {seconds * 1e3:.3f} ms per call; bound "
              f"{roofline.kernel_bound('fma_chain', args.B, args.T)} "
              f"[{card}]", flush=True)
        gt, model, ev = chip_smoke.kernel_inputs(
            models, device, args.B, args.T, np.random.default_rng(11))
        recs = chip_smoke.check_kernels(gt, model, ev)
        if table is not None:
            from nanocall_tpu_torch import convert

            recs.update(chip_smoke.check_generic_kernels(
                convert.trans_ops(table, device), model, ev,
                sample=chip_smoke.smi_line))
            for name in chip_smoke.K6A:
                r = recs[name]
                turns = ", ".join(f"{ms:.3f} ms [{smi}]" for ms, smi in
                                  zip(r["ms_turns"], r["samples"]))
                print(f"K6a in turns, {name} B={args.B} T={args.T}: "
                      f"{turns}", flush=True)
            time_k6b(convert.trans_ops(table, device), model, ev, card)
        for name, r in recs.items():
            b = roofline.kernel_bound(name, args.B, args.T)
            sh = roofline.kernel_shares(name, args.B, args.T, r["ms"], peak)
            print(f"kernel {name} B={args.B} T={args.T}: {r['ms']:.3f} ms, "
                  f"plain {r['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} "
                  f"ms ({b['bound_by']}), bit-equal; "
                  f"{sh['f32_ops_per_s'] / 1e12:.3f} TFLOP/s = "
                  f"{100 * sh['share_of_f32_spec']:.2f}% of 67 TFLOP/s, "
                  f"{100 * sh['share_of_k8_peak']:.2f}% of the measured K8 "
                  f"peak {peak / 1e12:.3f} TFLOP/s [{card}]", flush=True)
        time_chunk_and_probe_nan(models, device, card)
        decode_s = (recs["viterbi_forward_path"]["ms"]
                    + recs["viterbi_traceback"]["ms"]) / 1e3
        rep = roofline.mfu_report(args.B, args.T, 4096, decode_s, peak)
        print(f"mfu_report decode (K1 + K2) B={args.B} T={args.T}: "
              f"{decode_s * 1e3:.3f} ms, "
              f"{rep['achieved_vpu_ops_per_s'] / 1e12:.3f} TFLOP/s, "
              f"{100 * rep['mfu_vs_h100_f32_spec']:.2f}% of 67 TFLOP/s, "
              f"{100 * rep['mfu_vs_measured_fma_peak']:.2f}% of the "
              f"measured K8 peak [{card}]", flush=True)
        del gt, model, ev
        torch.cuda.empty_cache()

    if args.em:
        time_em_kernels(models, device, card)

    if args.custom:
        time_custom(models, device, card)

    cfg = chip_smoke.smoke_config(*([] if args.train else ["--no-train"]),
                                  *trans_flags)

    def run(reads, timer=None):
        stream = (read_pipeline.summarize_ed(f"{name}.fast5", ed, models,
                                             cfg)
                  for name, ed, _ in reads)
        kernels.reset_launches()
        t = time.perf_counter()
        _, results = basecall.run_pipeline(stream, models, cfg, device,
                                           timer=timer,
                                           default_transitions=table)
        return results, time.perf_counter() - t

    def launched() -> dict:
        """The hand-written kernels' launches in the last run."""
        return {k.name: k.wrapper.launches for k in kernels.KERNELS
                if k.wrapper.launches}

    if args.reads:
        n_1d = args.reads * 4 // 5
        t0 = time.perf_counter()
        reads = chip_smoke.simulated_reads(models, rng, n_1d,
                                           args.reads - n_1d)
        print(f"simulated {len(reads)} reads in "
              f"{time.perf_counter() - t0:.1f} s")
        for rep in range(2):
            timer = chip_smoke.StageTimer()
            results, wall = run(reads, timer)
            events = sum(len(r.ev) for r in results)
            stages = {k: round(v, 3) for k, v in timer.stages.items()}
            print(f"pipeline run {rep}: {len(results)} strands, {events} "
                  f"events, {wall:.3f} s = {events / wall:.0f} events/s; "
                  f"stages {stages}; launches {launched()} [{card}]",
                  flush=True)
        if args.profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = run(reads)
            avgs = prof.key_averages()
            # only the device-side rows, as the table's "Self CUDA time
            # total": a CPU op's row repeats the device time of the kernels
            # it launched
            busy = sum(e.self_device_time_total for e in avgs
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation) / 1e6
            print(f"profiled run: {wall:.3f} s, device time {busy:.4f} s = "
                  f"{100 * busy / wall:.1f}% busy [{card}]")
            split = {}
            for e in avgs:
                if e.device_type != DeviceType.CUDA:
                    continue
                for fn in KERNEL_FUNCTIONS:
                    if fn in e.key:
                        ms, n = split.get(fn, (0.0, 0))
                        split[fn] = (ms + e.self_device_time_total / 1e3,
                                     n + e.count)
            for fn, (ms, n) in sorted(split.items(), key=lambda x: -x[1][0]):
                print(f"  {fn}: {ms:.3f} ms in {n} launches = "
                      f"{100 * ms / 1e3 / busy:.1f}% of device time")
            print(avgs.table(sort_by="self_device_time_total", row_limit=25))
        if args.k4_launches:
            time_k4_launches(run, reads, card)

    if args.long:
        T = batching.bucket_length(args.long)
        B = batching.batch_size_for(
            T, cfg.bucket_max_batch, shapes.BP_BUDGET, 4096)
        Tc = batching.tchunk_len(T)
        gt, model, ev = chip_smoke.kernel_inputs(
            models, device, B, T, np.random.default_rng(12))
        decodes = {
            "full scan (K1 + K2)": lambda: hmm.viterbi_decode_grouped(
                gt, model, ev),
            f"chunked (K3, Tc={Tc})": lambda: hmm.viterbi_decode_grouped_tchunk(
                gt, model, ev, Tc)}
        outs = {}
        for name in [*decodes, *reversed(decodes)]:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = {k: v.cpu() for k, v in decodes[name]().items()}
            ms = 1e3 * (time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated() - base
            print(f"long decode {name}: B={B} T={T} {ms:.3f} ms, peak device "
                  f"memory above the inputs {peak / 2**30:.3f} GiB "
                  f"[{card}]", flush=True)
            outs.setdefault(name, out)
        want, got = outs.values()
        for k in want:
            assert torch.equal(got[k], want[k]), f"{k} differs"
        print(f"long decode: chunked bit-equal to full scan (path0, codes, "
              f"logp) [{card}]")
        for name, t in (("viterbi_forward_chunk", Tc),
                        ("viterbi_traceback_chunk", Tc),
                        ("viterbi_forward_path", T), ("viterbi_traceback", T)):
            b = roofline.kernel_bound(name, B, t)
            print(f"bound of {name} at B={B} T={t}: {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})")
        del gt, model, ev, outs
        torch.cuda.empty_cache()

        mean, stdv, start, length, truth = simulate.simulate_read(
            models, "r73.t.006", None, args.long, rng,
            noise_scale=chip_smoke.NOISE)
        truths = truth.base_seqs
        reads = [("long", ingest.ed_from_arrays(mean, stdv, start, length,
                                                4000.0, "long"), truths)]
        for rep in range(2):
            torch.cuda.reset_peak_memory_stats()
            results, wall = run(reads)
            (r,) = results
            window = chip_smoke.IDENTITY_WINDOW
            ident = simulate.identity(
                r.base_seq[:window],
                truths[0][:round(window * len(truths[0]) / len(r.base_seq))])
            print(f"long read run {rep}: {len(r.ev)} events (bucket T="
                  f"{batching.bucket_length(len(r.ev))}), {wall:.3f} s = "
                  f"{len(r.ev) / wall:.0f} events/s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                  f"identity {ident:.3f}; launches {launched()} [{card}]",
                  flush=True)
    return 0


def run_turns(other: str) -> int:
    """This tool with the same flags (but --turns) on `other`, here, here
    and `other`, one process each; each process's output is printed as it
    ends, under a header naming its tree."""
    argv = sys.argv[1:]
    i = argv.index("--turns")
    rest = argv[:i] + argv[i + 2:]
    for n, tree in enumerate((other, ROOT, ROOT, other)):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               *rest, "--tree", tree], capture_output=True,
                              text=True)
        print(f"=== turn {n + 1} of 4: {tree} (exit {proc.returncode}, "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
        print(proc.stdout, flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], flush=True)
            return proc.returncode
    return 0


#: the time loops of K1 (path, score-only; one runtime-switched instance
#: before the redesign), K3's forward chunk, K4, K5, K6d and K6c's
#: streaming kernel, by kernel name marker, the first one the tree has
#: (since K1m, K1's kernel has a third template argument)
CENSUS_LOOPS = (("K1 path", ("viterbi_forward_kernelILb0ELb1ELb0E",
                             "viterbi_forward_kernelILb0ELb1E",
                             "viterbi_forward_kernelILb0E")),
                ("K1 score", ("viterbi_forward_kernelILb0ELb0ELb0E",
                              "viterbi_forward_kernelILb0ELb0E")),
                ("K3 forward chunk", ("viterbi_forward_kernelILb1ELb1ELb0E",
                                      "viterbi_forward_kernelILb1ELb1E",
                                      "viterbi_forward_kernelILb1E")),
                ("K4", ("fwbw_forward_kernel",)),
                ("K5", ("em_backward_kernel",)),
                ("K6d", ("fwbw_backward_kernel",)),
                ("K6c streaming", ("fwbw_generic_kernel",)))


#: the traceback walks' kernels, by name marker (the chunk kernel's two
#: template instances: K3's codes, K9's states)
WALK_MARKERS = (("K2", "24viterbi_traceback_kernel"),
                ("K3 traceback chunk", "viterbi_traceback_chunk_kernelILb0E"),
                ("K9 states chunk", "viterbi_traceback_chunk_kernelILb1E"),
                ("K6b ring", "viterbi_generic_traceback_ring_kernel"))


def print_census() -> None:
    """The static SASS census (this checkout's chip_smoke.step_loop_sass)
    of the time loops of the built kernels of the tree run on, of the
    resident K6c's and K6e's two time loops (barrier_loops_sass) where it
    has them, and of the traceback walks' loops (walk_loop_sass)."""
    import importlib.util

    from nanocall_tpu_torch.ops import _cuda

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_census", os.path.join(ROOT, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump"), "-sass",
         _cuda._lib_path()], capture_output=True, text=True,
        check=True).stdout
    for what, markers in CENSUS_LOOPS:
        marker = next((m for m in markers if m in sass), None)
        if marker is None:
            continue
        c = here.step_loop_sass(marker)
        print(f"census {what} ({marker}): {c}", flush=True)
    for kernel, what_k in (("fwbw_resident_kernel", "K6c resident"),
                           ("fwbw_custom_resident_kernel", "K6e resident")):
        for marker in sorted(set(re.findall(rf"{kernel}\w*", sass))):
            for what, lp in zip(("forward", "backward"),
                                here.barrier_loops_sass(marker)):
                print(f"census {what_k} ({marker}), {what} time loop: {lp}",
                      flush=True)
    for what, marker in WALK_MARKERS:
        if marker in sass:
            print(f"census {what} walk ({marker}): "
                  f"{here.walk_loop_sass(marker)}", flush=True)


def time_chunk_and_probe_nan(models, device, card: str) -> None:
    """K3's forward chunk at B = 4 over events [8192, 16384), timed; and
    K1 (path) against its plain version at 16 x 512 with one NaN stay
    entry: bit-equal or not (torch.maximum propagates the NaN)."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm

    B, Tc = chip_smoke.B_LONG, chip_smoke.TC_LONG
    gt, model, ev = chip_smoke.kernel_inputs(
        models, device, B, 2 * Tc, np.random.default_rng(13))
    carry, _ = hmm.forward_chunk_kernel(gt, model, ev, None, 0, Tc)
    ms = chip_smoke.cuda_ms(lambda: hmm.forward_chunk_kernel(
        gt, model, ev, carry, Tc, Tc), 5)
    print(f"kernel viterbi_forward_chunk B={B} events [{Tc}, {2 * Tc}): "
          f"{ms:.3f} ms [{card}]", flush=True)
    gt, model, ev = chip_smoke.kernel_inputs(
        models, device, 16, 512, np.random.default_rng(14))
    gt.stay_lp[0, 1234] = float("nan")
    fa_p, bps_p = hmm.viterbi_forward_grouped_plain(gt, model, ev, True)
    fa_k, bps_k = hmm.forward_path_kernel(gt, model, ev)
    same = (torch.equal(fa_k.view(torch.int32), fa_p.view(torch.int32))
            and torch.equal(bps_k, bps_p))
    print(f"K1 under a NaN stay entry (16 x 512): "
          f"{'bit-equal to' if same else 'DIFFERS from'} the plain version "
          f"[{card}]", flush=True)


#: calls per time of K4 and K5 in time_em_kernels
EM_REPS = 20


def time_em_kernels(models, device, card: str) -> None:
    """K4, K5 and K6d at the EM chunk's shape against their plain versions,
    with bounds and shares of the K8 peak measured there; each kernel's
    time the mean of 2 x EM_REPS calls, K4 with alphas, K4 without, K4 on
    the chunk with half its rows of length 0, K5, K6d on the full and the
    half-idle chunk, then the same in reverse (one card's clocks drift
    within a process)."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import roofline, train
    from nanocall_tpu_torch.ops import em, hmm

    rng = np.random.default_rng(15)
    reads = chip_smoke.simulated_reads(models, rng)
    inp = chip_smoke.em_kernel_inputs(models, reads, device, rng)
    B, T = inp["ev"]["mean"].shape
    peak, _ = roofline.measure_fma_peak(B, 4096, T, k=roofline.FMA_K)
    recs = chip_smoke.check_em_kernels(inp)
    gtf, model, ev = inp["gtf"], inp["model"], inp["ev"]
    recs["fwbw_forward, no alphas stored"] = {
        "plain_ms": chip_smoke.cuda_ms(lambda: hmm.fwbw_grouped_forward_plain(
            gtf, model, ev, with_alphas=False), 1)}
    # the chunk as a trained run's chunks have it when 1D reads fill them
    half = chip_smoke.half_idle(ev)
    recs["fwbw_forward, half the rows of length 0"] = {
        "plain_ms": chip_smoke.cuda_ms(lambda: hmm.fwbw_grouped_forward_plain(
            gtf, model, half), 1)}
    for got, want in zip(hmm.fwbw_forward_kernel(gtf, model, half),
                         hmm.fwbw_grouped_forward_plain(gtf, model, half)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for name, e in (("fwbw_grouped_backward", ev),
                    ("fwbw_grouped_backward, half the rows of length 0",
                     half)):
        ms, want = chip_smoke.cuda_ms_once(
            lambda: hmm.fwbw_grouped_backward_plain(gtf, model, e))
        got = hmm.fwbw_backward_kernel(gtf, model, e)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name
        recs[name] = {"plain_ms": ms}
        del got, want
    alphas, lpd = hmm.fwbw_forward_kernel(gtf, model, ev)
    args = train.em_backward_args(inp, lpd, alphas, True, True)
    calls = {"fwbw_forward": lambda: hmm.fwbw_forward_kernel(gtf, model, ev),
             "fwbw_forward, no alphas stored": lambda: hmm.fwbw_forward_kernel(
                 gtf, model, ev, with_alphas=False),
             "fwbw_forward, half the rows of length 0":
                 lambda: hmm.fwbw_forward_kernel(gtf, model, half),
             "em_backward": lambda: em.em_backward_kernel(*args),
             "fwbw_grouped_backward": lambda: hmm.fwbw_backward_kernel(
                 gtf, model, ev),
             "fwbw_grouped_backward, half the rows of length 0":
                 lambda: hmm.fwbw_backward_kernel(gtf, model, half)}
    turns = {name: [] for name in calls}
    for name in (*calls, *reversed(list(calls))):
        turns[name].append(chip_smoke.cuda_ms(calls[name], EM_REPS))
    for name, ms in turns.items():
        recs[name]["ms"] = sum(ms) / len(ms)
    for name, r in recs.items():
        b = roofline.kernel_bound(name.split(",")[0], B, T)
        sh = roofline.kernel_shares(name.split(",")[0], B, T, r["ms"], peak)
        print(f"kernel {name} B={B} T={T}: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), bit-equal; "
              f"{sh['f32_ops_per_s'] / 1e12:.3f} TFLOP/s = "
              f"{100 * sh['share_of_f32_spec']:.2f}% of 67 TFLOP/s, "
              f"{100 * sh['share_of_k8_peak']:.2f}% of the measured K8 peak "
              f"{peak / 1e12:.3f} TFLOP/s [{card}]", flush=True)
    probe_em_under_nan(inp, card)
    time_k6c(inp, device, card, peak)
    del inp
    torch.cuda.empty_cache()


def probe_em_under_nan(inp, card: str) -> None:
    """K4 (alphas stored) and K5 (all statistics) against their plain
    versions on copies of the EM chunk's inputs with NaN events in row 5
    from event T / 2 on, a NaN model entry in row 6 and a +inf event in
    row 7, those valid rows of full length (chip_smoke.py's
    check_em_under_nan, which asserts): bit-equal or not, as bits, for
    either tree (a NaN that fmaxf drops and torch.amax keeps)."""
    import torch

    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em, hmm

    model = hmm.ModelArrays(*(x.clone() for x in inp["model"]))
    ev = {k: v.clone() for k, v in inp["ev"].items()}
    valid = inp["valid"].clone()
    T = ev["mean"].shape[1]
    ev["length"][5:8] = T
    valid[5:8] = True
    ev["mean"][5, T // 2:] = float("nan")
    model.level_mean[6, 1234] = float("nan")
    ev["mean"][7, 40] = float("inf")
    case = {**inp, "model": model, "ev": ev, "valid": valid}
    a_p, lpd_p = hmm.fwbw_grouped_forward_plain(inp["gtf"], model, ev)
    a_k, lpd_k = hmm.fwbw_forward_kernel(inp["gtf"], model, ev)
    args = train.em_backward_args(case, lpd_p, a_p, True, True)
    want, got = em.fused_bwd_mstats_plain(*args), em.em_backward_kernel(*args)
    torch.cuda.synchronize()

    def same(x, y):
        return torch.equal(x.view(torch.int32), y.view(torch.int32))

    k4 = same(a_k, a_p) and same(lpd_k, lpd_p)
    k5 = all(same(g, w) for g, w in zip(got, want))
    for name, ok in (("K4", k4), ("K5", k5)):
        print(f"{name} under NaN events, a NaN model entry and a +inf event "
              f"({' x '.join(map(str, ev['mean'].shape))}): "
              f"{'bit-equal to' if ok else 'DIFFERS from'} the plain version "
              f"[{card}]", flush=True)


#: calls per time of the walks in time_walks
WALK_REPS = 10
#: K2's shape in time_walks as the CLI batches a short bucket
#: (bucket_max_batch reads)
WIDE = (256, 2048)


def time_walks(models, device, card: str, B: int, T: int) -> None:
    """K2 at B x T on K1's output (chip_smoke.kernel_inputs' lengths, and
    again with every length T: T - 1 rows a read) and at WIDE, K3's
    traceback chunk and K9's states chunk on events [8192, 16384) of 4
    reads (K1's rows of those events, from random carried states), each
    bit-equal to its plain version, then timed: the mean of 2 x WALK_REPS
    calls, K2, K3, K9 and back (a chunk's call includes the carry's clone,
    and K3's the zeroing of its 12 KB of codes); the rows each K2 walk at
    B x T reads and their time at 3.35 TB/s are printed.  Then K2 against
    its plain
    version on K1's output at 16 x 512 under a NaN stay entry (the final
    alpha NaN at some states): bit-equal or not."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import roofline
    from nanocall_tpu_torch.ops import hmm

    gt, model, ev = chip_smoke.kernel_inputs(models, device, B, T,
                                             np.random.default_rng(11))
    fa, bps = hmm.forward_path_kernel(gt, model, ev)
    del gt, model
    lengths = ev["length"]
    got = hmm.traceback_kernel(6, fa, bps, lengths)
    ms, want = chip_smoke.cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_plain(6, fa, bps, lengths))
    for g, w in zip(got, want):
        assert torch.equal(chip_smoke.bits(g), chip_smoke.bits(w))
    # the same rows walked at full length: every read streams T - 1 rows
    full = torch.full_like(lengths, T)
    ms_full, want = chip_smoke.cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_plain(6, fa, bps, full))
    for g, w in zip(hmm.traceback_kernel(6, fa, bps, full), want):
        assert torch.equal(chip_smoke.bits(g), chip_smoke.bits(w))
    del want
    # K2 as the CLI's short buckets batch it: more reads than SMs
    Bw, Tw = WIDE
    gtw, modelw, evw = chip_smoke.kernel_inputs(models, device, Bw, Tw,
                                                np.random.default_rng(16))
    faw, bpsw = hmm.forward_path_kernel(gtw, modelw, evw)
    lenw = evw["length"]
    del gtw, modelw
    ms_wide, want = chip_smoke.cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_plain(6, faw, bpsw, lenw))
    for g, w in zip(hmm.traceback_kernel(6, faw, bpsw, lenw), want):
        assert torch.equal(chip_smoke.bits(g), chip_smoke.bits(w))
    del want
    plain = {"viterbi_traceback": ms,
             "viterbi_traceback, full lengths": ms_full,
             f"viterbi_traceback, {Bw} reads": ms_wide}
    calls = {"viterbi_traceback": (
                 lambda: hmm.traceback_kernel(6, fa, bps, lengths), (B, T)),
             "viterbi_traceback, full lengths": (
                 lambda: hmm.traceback_kernel(6, fa, bps, full), (B, T)),
             f"viterbi_traceback, {Bw} reads": (
                 lambda: hmm.traceback_kernel(6, faw, bpsw, lenw), (Bw, Tw))}
    for what, ln in (("", lengths), (", full lengths", full)):
        rows_walked = int((ln.clamp(max=T) - 1).clamp(min=0).sum())
        gb = rows_walked * 4096 / 1e9
        print(f"kernel viterbi_traceback{what} B={B} T={T}: the walk reads "
              f"{rows_walked} rows = {gb:.3f} GB, {gb / 3.35:.3f} ms at "
              f"3.35 TB/s [{card}]", flush=True)

    Bc, Tc = chip_smoke.B_LONG, chip_smoke.TC_LONG
    gt4, model4, ev4 = chip_smoke.kernel_inputs(
        models, device, Bc, 2 * Tc, np.random.default_rng(13))
    fa4, bps4 = hmm.forward_path_kernel(gt4, model4, ev4)
    rows = bps4[Tc - 1:2 * Tc - 1].contiguous()
    del bps4
    len4 = ev4["length"]
    end = torch.argmax(fa4, dim=-1).to(torch.int32)
    carry = torch.randint(0, 4096, (Bc,), dtype=torch.int32, device=device)
    code_bytes = 3 * (-(-(2 * Tc - 1) // 4))
    codes = torch.zeros((Bc, code_bytes), dtype=torch.uint8, device=device)
    state = carry.clone()
    hmm.traceback_chunk_kernel(6, end, state, rows, Tc, len4, codes)
    ms, (s_p, codes_p) = chip_smoke.cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, carry, rows, Tc, len4))
    packed_p = torch.zeros_like(codes)
    hmm.or_packed_codes(packed_p, codes_p, Tc)
    assert torch.equal(state, s_p.to(torch.int32))
    assert torch.equal(codes, packed_p)
    plain["viterbi_traceback_chunk"] = ms
    states = torch.empty((Tc, Bc), dtype=torch.uint16, device=device)
    state = carry.clone()
    hmm.traceback_chunk_states_kernel(6, end, state, rows, Tc, len4, states)
    ms, (s_p, states_p) = chip_smoke.cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, carry, rows, Tc, len4, compact=False))
    assert torch.equal(state, s_p.to(torch.int32))
    assert torch.equal(states.int(), states_p.int())
    plain["viterbi_traceback_chunk_states"] = ms
    calls["viterbi_traceback_chunk"] = (
        lambda: hmm.traceback_chunk_kernel(6, end, carry.clone(), rows, Tc,
                                           len4, codes.zero_()), (Bc, Tc))
    calls["viterbi_traceback_chunk_states"] = (
        lambda: hmm.traceback_chunk_states_kernel(
            6, end, carry.clone(), rows, Tc, len4, states), (Bc, Tc))
    turns = {name: [] for name in calls}
    for name in (*calls, *reversed(list(calls))):
        turns[name].append(chip_smoke.cuda_ms(calls[name][0], WALK_REPS))
    for name, ms in turns.items():
        shape = calls[name][1]
        b = roofline.kernel_bound(name.split(",")[0], *shape)
        print(f"kernel {name} B={shape[0]} T={shape[1]}: "
              f"{sum(ms) / len(ms):.3f} ms (turns "
              f"{', '.join(f'{x:.3f}' for x in ms)}), plain "
              f"{plain[name]:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), bit-equal [{card}]", flush=True)
    del fa, bps, rows, faw, bpsw
    torch.cuda.empty_cache()

    gt, model, ev = chip_smoke.kernel_inputs(
        models, device, 16, 512, np.random.default_rng(14))
    gt.stay_lp[0, 1234] = float("nan")
    fa, bps = hmm.forward_path_kernel(gt, model, ev)
    got = hmm.traceback_kernel(6, fa, bps, ev["length"])
    want = hmm.viterbi_traceback_grouped_plain(6, fa, bps, ev["length"])
    same = all(torch.equal(chip_smoke.bits(g), chip_smoke.bits(w))
               for g, w in zip(got, want))
    print(f"K2 under a NaN stay entry (16 x 512; final alpha NaN at "
          f"{int(torch.isnan(fa[0]).sum())} of 4096 states of read 0): "
          f"{'bit-equal to' if same else 'DIFFERS from'} the plain version "
          f"[{card}]", flush=True)


def time_k4_launches(run, reads, card: str) -> None:
    """K4 on the inputs of each of its launches in one more pipeline run
    (cloned as the run makes them), in launch order: the milliseconds of
    each (chip_smoke.cuda_ms over EM_REPS calls), with its shape and how
    many of its rows are of length 0, and the sum over the launches, which
    the profile's K4 device time should approach."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    kernel = hmm.fwbw_forward_kernel
    calls = []

    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [clone(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x.clone() if torch.is_tensor(x) else x

    def capture(gtf, model, ev, with_alphas=True):
        calls.append((*clone((gtf, model, ev)), with_alphas))
        return kernel(gtf, model, ev, with_alphas)

    capture.launches = 0  # the kernel's own count_launch names this module
    hmm.fwbw_forward_kernel = capture
    try:
        run(reads)
    finally:
        hmm.fwbw_forward_kernel = kernel
    total = 0.0
    for i, args in enumerate(calls):
        ms = chip_smoke.cuda_ms(lambda: kernel(*args), EM_REPS)
        total += ms
        length = args[2]["length"]
        B, T = args[2]["mean"].shape
        print(f"K4 launch {i} of the run: B={B} T={T} alphas "
              f"{'stored' if args[3] else 'not stored'}, "
              f"{int((length == 0).sum())} rows of length 0, mean length "
              f"{float(length.float().mean()):.1f}: {ms:.3f} ms [{card}]",
              flush=True)
    print(f"K4 over the run's {len(calls)} launches: {total:.3f} ms "
          f"[{card}]", flush=True)


def time_k6c(inp, device, card: str, peak: float) -> None:
    """K6c at the EM chunk's shape under the loaded tables of (0.14, 0.21)
    and of the CLI priors (0.1, 0.3): the streaming kernel (on the table's
    TransOps without a K6c layout) and, where the tree has it and the table
    takes it, the resident kernel; the two bit-equal (alpha, beta, em,
    log_pr_data), then timed in turns (streaming, resident, resident,
    streaming; chip_smoke.cuda_ms over 3 calls each)."""
    import torch

    from nanocall_tpu_torch import cli, convert, roofline, transitions
    from nanocall_tpu_torch.ops import hmm

    model, ev = inp["model"], inp["ev"]
    B, T = ev["mean"].shape
    resident = getattr(hmm, "fwbw_resident_kernel", None)
    out_dir = os.path.join(ROOT, "build", "decode_times")
    os.makedirs(out_dir, exist_ok=True)
    for ps, pk in ((0.14, 0.21), (0.1, 0.3)):
        path = os.path.join(out_dir, f"trans_{ps}_{pk}.tsv")
        convert.write_fast_transitions(path, ps, pk)
        ops = convert.trans_ops(cli.init_transitions(
            chip_smoke.smoke_config("-s", path)), device)
        bare = (ops._replace(fwbw_packed=None) if "fwbw_packed" in
                ops._fields else ops)
        calls = {"fwbw_generic": lambda: hmm.fwbw_generic_kernel(
            bare, model, ev)}
        if resident is not None and hmm.fwbw_route(ops) == "resident":
            calls["fwbw_resident"] = lambda: resident(ops, model, ev)
            got, want = calls["fwbw_resident"](), calls["fwbw_generic"]()
            torch.cuda.synchronize()
            for k in ("alpha", "beta", "em", "log_pr_data"):
                assert torch.equal(got[k].view(torch.int32),
                                   want[k].view(torch.int32)), k
            del got, want
        turns = {name: [] for name in calls}
        for name in (*calls, *reversed(list(calls))):
            turns[name].append(chip_smoke.cuda_ms(calls[name], 3))
        for name, ms in turns.items():
            mean = sum(ms) / len(ms)
            b = roofline.kernel_bound(name, B, T)
            sh = roofline.kernel_shares(name, B, T, mean, peak)
            print(f"kernel {name} under the loaded table of ({ps}, {pk}) "
                  f"B={B} T={T}: {mean:.3f} ms (turns "
                  f"{', '.join(f'{x:.3f}' for x in ms)}), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  f"{100 * sh['share_of_f32_spec']:.2f}% of 67 TFLOP/s, "
                  f"{100 * sh['share_of_k8_peak']:.2f}% of the K8 peak"
                  f"{'; bit-equal to the streaming kernel' if len(calls) > 1 and name == 'fwbw_resident' else ''}"
                  f" [{card}]", flush=True)
    if resident is None:
        return
    path = os.path.join(out_dir, "trans_0.14_0.21.tsv")
    table = cli.init_transitions(chip_smoke.smoke_config("-s", path))
    for deg in (19, 23):
        pick = list(range(21))[:deg] + list(range(max(deg - 21, 0)))
        ops = convert.trans_ops(transitions.SparseTransitions(
            from_idx=table.from_idx[pick], from_logp=table.from_logp[pick],
            to_idx=table.to_idx[pick], to_logp=table.to_logp[pick], K=6),
            device)
        ms = chip_smoke.cuda_ms(lambda: resident(ops, model, ev), 6)
        print(f"kernel fwbw_resident under the loaded table of (0.14, 0.21) "
              f"at {deg} slots a side B={B} T={T}: {ms:.3f} ms = "
              f"{ms / deg:.4f} ms a slot [{card}]", flush=True)


def time_k6b(ops, model, ev, card: str) -> None:
    """K6b's streaming kernel and, in a tree that has it, its ring kernel
    on K6a's output under `ops`, with the drawn lengths and with every
    length T: bit-equal to each other (path, logp), then timed in turns
    (streaming, ring, ring, streaming; the mean of WALK_REPS calls each),
    with the rows the ring streams and their time at 3.35 TB/s."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    B, T = ev["mean"].shape
    ring = getattr(hmm, "generic_traceback_ring_kernel", None)
    fa, bps = hmm.viterbi_forward(ops, model, ev)
    full = torch.full_like(ev["length"], T)
    for what, ln in (("drawn lengths", ev["length"]), ("full lengths", full)):
        calls = {"viterbi_generic_traceback": lambda: (
            hmm.generic_traceback_kernel(ops, fa, bps, ln))}
        if ring is not None:
            calls["viterbi_generic_traceback_ring"] = lambda: ring(
                ops, fa, bps, ln)
            (path_s, logp_s), (path_r, logp_r) = (c() for c in
                                                  calls.values())
            torch.cuda.synchronize()
            assert torch.equal(path_r.int(), path_s.int()), what
            assert torch.equal(logp_r.view(torch.int32),
                               logp_s.view(torch.int32)), what
        turns = {name: [] for name in calls}
        for name in (*calls, *reversed(list(calls))):
            turns[name].append(chip_smoke.cuda_ms(calls[name], WALK_REPS))
        rows = int((ln.clamp(max=T) - 1).clamp(min=0).sum())
        for name, ms in turns.items():
            same = ("; bit-equal to the streaming kernel"
                    if name.endswith("ring") else "")
            print(f"kernel {name} B={B} T={T}, {what}: "
                  f"{sum(ms) / len(ms):.3f} ms (turns "
                  f"{', '.join(f'{x:.3f}' for x in ms)}){same}"
                  f"; the ring's rows {rows} = {rows * 4096 / 1e9:.3f} GB, "
                  f"{rows * 4096 / 3.35e9:.3f} ms at 3.35 TB/s [{card}]",
                  flush=True)


#: (B, T) of K6e's times in time_custom: chip_smoke.py's kernel shape, and
#: one read of the smoke's run-fwbw read's length
CUSTOM_SHAPES = ((16, 2048), (1, 4000))


def time_custom(models, device, card: str) -> None:
    """K6e under the loaded table of (0.14, 0.21) at CUSTOM_SHAPES
    (chip_smoke.kernel_inputs; the 1-read shape is read 0 of 4, of length
    T): the streaming kernel and, in a tree that has it, the resident one,
    bit-equal to each other (alpha, beta, gamma as bits), timed in turns
    (streaming, K6c's resident kernel on the same inputs, resident, then
    back; chip_smoke.cuda_ms over 2 calls each)."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import cli, convert, roofline
    from nanocall_tpu_torch.ops import hmm

    out_dir = os.path.join(ROOT, "build", "decode_times")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trans_0.14_0.21.tsv")
    convert.write_fast_transitions(path, 0.14, 0.21)
    ops = convert.trans_ops(cli.init_transitions(
        chip_smoke.smoke_config("-s", path)), device)
    resident = getattr(hmm, "fwbw_custom_resident_kernel", None)
    for B, T in CUSTOM_SHAPES:
        _, model, ev = chip_smoke.kernel_inputs(
            models, device, max(B, 4), T, np.random.default_rng(19))
        if B < 4:
            model = hmm.ModelArrays(*(x[:B].contiguous() for x in model))
            ev = {k: v[:B].contiguous() for k, v in ev.items()}
        calls = {"fwbw_custom": lambda: hmm.fwbw_custom_kernel(
            ops, model, ev)}
        # K6c's resident kernel on the same inputs: what a step of the
        # same slot work costs without norm
        calls["fwbw_resident"] = lambda: hmm.fwbw_resident_kernel(
            ops, model, ev)
        if resident is not None:
            calls["fwbw_custom_resident"] = lambda: resident(ops, model, ev)
            got, want = calls["fwbw_custom_resident"](), calls["fwbw_custom"]()
            torch.cuda.synchronize()
            for k in ("alpha", "beta", "gamma"):
                assert torch.equal(got[k].view(torch.int32),
                                   want[k].view(torch.int32)), k
            del got, want
        turns = {name: [] for name in calls}
        for name in (*calls, *reversed(list(calls))):
            turns[name].append(chip_smoke.cuda_ms(calls[name], 2))
        for name, ms in turns.items():
            b = roofline.kernel_bound(name, B, T)
            same = ("; bit-equal to the streaming kernel"
                    if name == "fwbw_custom_resident" else "")
            print(f"kernel {name}{' (K6c)' * (name == 'fwbw_resident')} "
                  f"under the loaded table of (0.14, 0.21) "
                  f"B={B} T={T} (longest read {int(ev['length'].max())}): "
                  f"{sum(ms) / len(ms):.3f} ms (turns "
                  f"{', '.join(f'{x:.3f}' for x in ms)}), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}){same} [{card}]",
                  flush=True)
        del model, ev
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
