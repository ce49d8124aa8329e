#!/usr/bin/env python3
"""Time the port's decode and pipeline on one NVIDIA GPU at main-path shapes.

    python3 tools/torch_decode_times.py [--B 128] [--T 8192] [--reads 256]
                                        [--train] [--trans FILE] [--profile]
                                        [--long 100000]

1. K8, the measured float32 peak at the decode's shape
   (nanocall_tpu_torch.roofline.measure_fma_peak: B rows x n = 4096 lanes
   x T steps of k FMAs, k = roofline.FMA_K = matched_fma_k(4096) = 24, K1's
   step's work, as bench.py matches it); then K1 (path and score-only) and K2
   against their plain PyTorch versions at B reads x T events (n = 4096):
   bit-equality and milliseconds per call (CUDA events), built with
   chip_smoke.py's inputs; with --trans, also K6a (path and score-only)
   and K6b under that table.  For each kernel: its bound, its achieved
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
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

#: the hand-written kernels' function names in nanocall_tpu_torch/csrc
KERNEL_FUNCTIONS = ("viterbi_forward_kernel", "viterbi_traceback_kernel",
                    "viterbi_traceback_chunk_kernel",
                    "fwbw_forward_kernel", "em_backward_kernel",
                    "viterbi_generic_forward_kernel",
                    "viterbi_generic_traceback_kernel",
                    "fwbw_generic_kernel", "fwbw_backward_kernel")


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
    args = ap.parse_args()

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

    if args.B:
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
                convert.trans_ops(table, device), model, ev))
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


if __name__ == "__main__":
    sys.exit(main())
