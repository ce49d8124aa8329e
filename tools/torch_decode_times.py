#!/usr/bin/env python3
"""Time the port's decode and pipeline on one NVIDIA GPU at main-path shapes.

    python3 tools/torch_decode_times.py [--B 128] [--T 8192] [--reads 256]
                                        [--train] [--trans FILE]
                                        [--trans-only] [--profile]
                                        [--long 100000] [--em] [--census]
                                        [--k4-launches] [--walks]
                                        [--custom] [--em-mesh]
                                        [--legacy-mesh]
                                        [--generic-mesh] [--slice-walks]
                                        [--stream] [--no-fwbw-layout]
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
   TB/s (a tree that gives the table no K6a layout, as before K6a took 4
   codebooks a slot under the CLI priors' table: its streaming kernels
   alone, time_k6a_streaming; --trans-only: K6a and K6b without K1, K2 and
   K3).  For each kernel: its
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
With --em-mesh, also the EM round on the mesh's state axis at the EM
chunk (512 rows x T = 128, the whole chunk one data row) over 2 and 4
ranks on one card: EM_MESH_REPS passes of statepar.em_round_statepar (both
train flags) at each rank count, K4m's and K5m's launches each timed alone
by CUDA events (the stream held first, as chip_smoke.launch_spans does:
torch.profiler drops cooperative launches), beside K4 + K5 (the same
round on one rank) in the same turns; each kernel's milliseconds a pass,
its waves and its µs a step; in a tree whose kernels have the cluster
path, K4m and K5m there against their cooperative path, in turns,
bit-equal.  It
runs in any tree that has the state axis's EM round (PR 17 on), so that
two designs are timed in turns (--turns).
With --legacy-mesh, also the legacy EM round's kernels on the mesh's
state axis at the EM chunk (512 rows x T = 128, the whole chunk one data
row) over 2 and 4 ranks on one card: K6cm (the generic forward-backward,
statepar._fwbw_generic_row) in its resident form under the loaded tables
of (0.14, 0.21) and of the CLI priors (0.1, 0.3) and in its streaming form
(the (0.14, 0.21) table without its packed layout), against K6c on the
whole rows, and K6dm (the grouped backward, after K4m) against K6d, each
on both exchange paths (a cluster a read, the cooperative grid), timed in
turns (K6c or K6d, then each rank count and path, then the same
reversed; LEGACY_MESH_REPS rounds), each call's launches timed alone by
CUDA events (chip_smoke.launch_spans: the stream held first); every
output bit-equal to K6c's or K6d's.  It runs in a tree that has the
legacy round on the state axis.  In a tree whose K6cm takes
several reads a block (hmm.fwbw_wave_reads), K6cm's resident and
streaming forms under (0.14, 0.21) on the cluster path over 2, 4 and 8
ranks and on the cooperative path over 2 and 4 at each other count of 1,
2, 4 and 8 reads a block that fits, in the same turns; in a tree whose kernels have the SPLIT instances (NC_SPLIT), then
the split of a cluster step (split_legacy_mesh): K6cm's and K6dm's
kernels built once more with NC_SPLIT (their clock64() stamps) into a
library of their own, one call of each form over 2 and 4 ranks, and the
cycles of thread 0 of every block in the wait, the slot loop (K6dm: the
beta step's own work) and the push, a step.
With --legacy-exchange, K6cm's resident and streaming forms and K6dm on
the cluster path over 2 and 4 ranks with each step's exchange on
mbarriers against the same kernels built with NC_BARRIER (the exchange a
plain store into the peers and a cluster barrier), in turns, bit-equal
(time_legacy_exchange).
With --generic-mesh, also the generic decode on the mesh's state axis
(statepar.viterbi_decode_placed on mesh.shard_decode_inputs: K6am and
K6bm) at the path chunk (chip_smoke.pooled_inputs, 128 reads x 8192
events) on (1, 2), (1, 4), (2, 2) and (1, 8) meshes of one card, and at
16 x 8192 on (1, 8), under the loaded tables of (0.14, 0.21) (K6am's
resident form) and of the CLI priors (0.1, 0.3) (its resident form at 4
codebooks a slot; before that layout, its streaming form):
K6am's device time a path decode (CUDA events around each launch, the
stream held first, as chip_smoke.launch_spans: torch.profiler drops
cooperative launches; GENERIC_MESH_REPS decodes), its launches and µs a
step, and K6bm's, on each exchange path the tree has (in a tree whose
K6am takes `cluster`: the cluster path where hmm.wave_cluster says and
the cooperative path forced), each decode's path and logp bit-equal to
K6a + K6b, whose kernels are timed in the same process.  It runs in any
tree that has the state axis's generic decode (PR 16 on).
With --slice-walks, also the state axis's walks alone at the path chunk
(chip_smoke.pooled_inputs, 128 reads x 8192 events, as drawn and at full
lengths) on one card: K6bm under the loaded table of (0.14, 0.21) on K6a's
output, and K2m on K1's, cut over the ranks of SLICE_WALK_CELLS' (data,
model) meshes as the tree's statepar lays the slices out (in a tree that
has statepar.backpointer_slices, one allocation of the card's rows, walked
in one launch on the tensor route; else a tensor a rank and a launch a
row), against K6b's and K2's rings on the same rows whole (one launch),
timed in turns (ring, walk, walk, ring; CUDA events around SLICE_WALK_REPS
calls), bit-equal; in a tree whose wrappers take a route, the copies route
forced too.  It runs in any tree that has the state axis's walks (PR 16
on), so that two designs are timed in turns (--turns).
With --stream, also the streaming K6c and K6e (time_stream): K6c at 512
x 128 and 1 x 4000, K6e at 16 x 2048 and 1 x 4000
(chip_smoke.kernel_inputs), under the loaded table of (0.14, 0.21)
without its packed layout, under a seeded random 21-slot table
(chip_smoke.random_table_ops), and under per-read tables
(chip_smoke.per_read_tables without their layout: the per-read
instances); the route's call and, in a tree that has the one-card split
(hmm.FWBW_SPLIT_STATES), each of its forms (S states a thread), each
call's outputs bit-equal to the route's; CUDA events around STREAM_REPS
calls, a digest of the route's outputs' bits (equal digests: equal
outputs, across trees too), ptxas' registers and spill of the four
streaming instances (from the build log of a fresh build, where the
tree's smoke reads it), and the table bytes a kernel of one block a read
reads from L2 (2 (T - 1) (deg_from + deg_to) slot rows of int32 states
and float32 log-probs, 32 KB each, a read).  With --stream-slots, the
same under seeded random tables of 1, 2, 4 and 8 slots at 48, 192 and
512 reads.
With --no-fwbw-layout, the pipeline run's TransOps lose K6c's packed layout
(convert.trans_ops wrapped): with --trans FILE --train, the legacy EM
round's rows at the priors take the streaming K6c.
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
import itertools
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
                    "fwbw_split_kernel",
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
    ap.add_argument("--trans-only", action="store_true",
                    help="with --trans, phase 1 times K6a and K6b alone "
                         "(no K1, K2, K3)")
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
    ap.add_argument("--em-mesh", action="store_true",
                    help="time K4m and K5m at 512 x 128 over 2 and 4 ranks")
    ap.add_argument("--legacy-mesh", action="store_true",
                    help="time K6cm and K6dm against K6c and K6d at 512 x "
                         "128 over 2 and 4 ranks")
    ap.add_argument("--legacy-exchange", action="store_true",
                    help="time K6cm's and K6dm's exchange on mbarriers "
                         "against a cluster barrier at 512 x 128 over 2 "
                         "and 4 ranks")
    ap.add_argument("--generic-mesh", action="store_true",
                    help="time K6am and K6bm at 128 x 8192 and 16 x 8192")
    ap.add_argument("--slice-walks", action="store_true",
                    help="time K6bm and K2m against K6b's and K2's rings "
                         "at 128 x 8192")
    ap.add_argument("--stream", action="store_true",
                    help="time the streaming K6c and K6e")
    ap.add_argument("--stream-slots", action="store_true",
                    help="time the streaming K6c and K6e under tables of "
                         "1 to 8 slots")
    ap.add_argument("--no-fwbw-layout", action="store_true",
                    help="the pipeline run's tables without K6c's packed "
                         "layout")
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
        only = args.trans_only and table is not None
        recs = {} if only else chip_smoke.check_kernels(gt, model, ev)
        if table is not None:
            from nanocall_tpu_torch import convert

            ops = convert.trans_ops(table, device)
            if hmm.generic_forward_route(ops) == "resident":
                recs.update(chip_smoke.check_generic_kernels(
                    ops, model, ev, sample=chip_smoke.smi_line))
                k6a = chip_smoke.K6A
            else:
                k6a = time_k6a_streaming(ops, model, ev, recs)
            print(f"K6a under {args.trans}: this tree's route "
                  f"{hmm.generic_forward_route(ops)} [{card}]", flush=True)
            for name in k6a:
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
        if not only:
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

    if args.em_mesh:
        time_em_mesh(models, device, card)

    if args.legacy_mesh:
        time_legacy_mesh(models, device, card)

    if args.legacy_exchange:
        time_legacy_exchange(models, device, card)

    if args.generic_mesh:
        time_generic_mesh(models, device, card)

    if args.slice_walks:
        time_slice_walks(models, device, card)

    if args.stream:
        time_stream(models, device, card)
    if args.stream_slots:
        time_stream(models, device, card, STREAM_SLOT_CASES)

    if args.no_fwbw_layout:
        from nanocall_tpu_torch import convert

        make = convert.trans_ops
        convert.trans_ops = lambda table, dev: make(table, dev)._replace(
            fwbw_packed=None)

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


def time_k6a_streaming(ops, model, ev, recs: dict) -> tuple:
    """K6a's streaming kernels (path and score-only) under a table to which
    the tree gives no K6a layout, bit-equal to the plain version and timed
    in turns (path, score, score, path) with the card's nvidia-smi line
    beside each time, into recs; returns their names."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    names = ("viterbi_generic_forward_path", "viterbi_generic_forward_score")
    plain = {n: chip_smoke.cuda_ms_once(lambda w=(n == names[0]):
                                        hmm.viterbi_forward_plain(
                                            ops, model, ev, w))
             for n in names}
    for n in names:
        got = chip_smoke.k6a_call(n, ops, model, ev)
        torch.cuda.synchronize()
        assert torch.equal(got[0], plain[n][1][0]), n
        if got[1] is not None:
            assert torch.equal(got[1], plain[n][1][1]), n
    timed = chip_smoke.time_in_turns(
        {n: (lambda n=n: chip_smoke.k6a_call(n, ops, model, ev))
         for n in names}, sample=chip_smoke.smi_line)
    for n in names:
        recs[n] = {**timed[n], "plain_ms": plain[n][0],
                   "max_abs_err": 0.0}
    return names


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
#: (K1's kernel took a third template argument while K1m's one-step
#: launch was an instance of it)
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


#: passes of the EM round a rank count in --em-mesh
EM_MESH_REPS = 5
#: cycles the stream is held before each timed launch (chip_smoke's
#: HOLD_CYCLES): the launch is enqueued before the hold ends
EM_MESH_HOLD = 2_000_000


def time_em_mesh(models, device, card: str) -> None:
    """K4m and K5m (and K4 + K5 on one rank) at the EM chunk over 2 and 4
    ranks on one card, a warm-up pass at each rank count, then
    EM_MESH_REPS passes of statepar.em_round_statepar a rank count in
    turns (1, 2, 4, 1, 2, 4, ...), each launch of the four wrappers timed
    alone by CUDA events; then, where the tree's kernels take `cluster`,
    both exchange paths in turns at 2 and 4 ranks, bit-equal."""
    import inspect

    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import em, hmm
    from nanocall_tpu_torch.parallel import statepar

    rng = np.random.default_rng(15)
    reads = chip_smoke.simulated_reads(models, rng)
    batch = chip_smoke.em_kernel_inputs(models, reads, device, rng)["batch"]
    B, T = batch[0]["mean"].shape[0] * batch[0]["mean"].shape[1], \
        batch[0]["mean"].shape[2]
    names = ((hmm, "fwbw_forward_kernel"), (em, "em_backward_kernel"),
             (hmm, "fwbw_forward_wave_kernel"),
             (em, "em_backward_wave_kernel"))
    spans = {name: [] for _, name in names}

    def timed(module, name):
        orig = getattr(module, name)

        def fn(*args, **kw):
            with torch.cuda.device(device):
                torch.cuda._sleep(EM_MESH_HOLD)
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = orig(*args, **kw)
            stop.record(stream)
            spans[name].append((start, stop))
            return out
        fn.launches = 0
        return orig, fn

    ranks = (1, 2, 4)
    rows = {M: [statepar.split_round_states(*batch, [device] * M)]
            for M in ranks}
    per = {M: {name: [] for _, name in names} for M in ranks}
    saved = {}
    for module, name in names:
        saved[name], fn = timed(module, name)
        setattr(module, name, fn)
    try:
        for M in ranks:  # warm-up
            statepar.em_round_statepar(rows[M])
        torch.cuda.synchronize()
        for v in spans.values():
            v.clear()
        for _ in range(EM_MESH_REPS):
            for M in ranks:
                for v in spans.values():
                    v.clear()
                statepar.em_round_statepar(rows[M])
                torch.cuda.synchronize()
                for name, v in spans.items():
                    if v:
                        per[M][name].append(
                            (sum(a.elapsed_time(b) for a, b in v), len(v)))
    finally:
        for module, name in names:
            setattr(module, name, saved[name])
    k4, k5 = (sum(ms for ms, _ in per[1][n]) / EM_MESH_REPS
              for n in ("fwbw_forward_kernel", "em_backward_kernel"))
    k4k5 = k4 + k5
    print(f"EM mesh B={B} T={T}: K4 + K5 on one rank {k4k5:.3f} ms a pass "
          f"(K4 {k4:.3f}, K5 {k5:.3f}), mean of {EM_MESH_REPS} [{card}]",
          flush=True)
    clusters = "cluster" in inspect.signature(
        hmm.fwbw_forward_wave_kernel).parameters
    for M in ranks[1:]:
        total = 0.0
        W = 4096 // M
        for name, steps, resident in (
                ("fwbw_forward_wave_kernel", T,
                 lambda: hmm.fwbw_forward_wave_resident(
                     device, False, W, cluster=True)),
                ("em_backward_wave_kernel", T - 1,
                 lambda: em.em_backward_wave_resident(
                     device, False, True, W, cluster=True))):
            ms = [x for x, _ in per[M][name]]
            waves = per[M][name][0][1]
            rounds = waves
            if clusters and waves == 1:
                # one launch of clusters: the rounds of the reads resident
                # at once
                rounds = -(-B // (resident() // M))
            mean = sum(ms) / len(ms)
            total += mean
            print(f"EM mesh {name} over {M} ranks: {mean:.3f} ms a pass "
                  f"(passes {', '.join(f'{x:.3f}' for x in ms)}), {waves} "
                  f"launches, {rounds} rounds of reads, "
                  f"{1e3 * mean / (rounds * steps):.2f} µs a step "
                  f"[{card}]", flush=True)
        print(f"EM mesh K4m + K5m over {M} ranks: {total:.3f} ms a pass = "
              f"{total / k4k5:.2f}x K4 + K5 [{card}]", flush=True)
    if "cluster" not in inspect.signature(
            hmm.fwbw_forward_wave_kernel).parameters:
        return
    # the exchange paths in turns: a cluster a read (the default on one
    # card) and the cooperative grid (a row across cards takes it); each
    # pass one call of _wave_kernels, the stream
    # held while the host enqueues it
    for M in ranks[1:]:
        W = 4096 // M
        fwd = {}
        k4m = {"cluster": None, "cooperative": False}
        k5m = ("cluster", "cooperative")
        ms = {name: [] for name in (*k4m, *(f"K5m {n}" for n in k5m))}
        for rep in range(2):
            for name in (*k4m, *reversed(list(k4m))):
                cluster = k4m[name]
                fk = [statepar._fwd_wave_rank(r, True) for r in rows[M][0]]
                ms[name].append(pass_ms(lambda: statepar._wave_kernels(
                    fk, lambda *a: hmm.fwbw_forward_wave_kernel(*a, cluster),
                    lambda d, sys: hmm.fwbw_forward_wave_resident(d, sys, W),
                    clusters=cluster is None)))
                fwd[name] = fk
            for name in (*k5m, *reversed(k5m)):
                bk = [statepar._em_wave_rank(r, f)
                      for r, f in zip(rows[M][0], fwd["cluster"])]
                cluster = None if name == "cluster" else False
                ms[f"K5m {name}"].append(pass_ms(
                    lambda: statepar._wave_kernels(
                        bk, lambda *a: em.em_backward_wave_kernel(
                            *a, True, True, cluster),
                        lambda d, sys: em.em_backward_wave_resident(
                            d, sys, True, W), clusters=cluster is None)))
        for name in k4m:
            got = torch.cat([r.alphas for r in fwd[name]], dim=2)
            want = torch.cat([r.alphas for r in fwd["cluster"]], dim=2)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (M, name)
        for name, v in ms.items():
            kernel = name if name.startswith("K5m") else f"K4m {name}"
            print(f"EM mesh {kernel} over {M} ranks: "
                  f"{sum(v) / len(v):.3f} ms a pass (turns "
                  f"{', '.join(f'{x:.3f}' for x in v)}); K4m's paths "
                  f"bit-equal [{card}]", flush=True)


#: rounds of turns in --legacy-mesh
LEGACY_MESH_REPS = 2


def legacy_mesh_inputs(models, device):
    """The EM chunk of --legacy-mesh (512 x 128, seed 15): the round's
    batch, its inputs, K6cm's three forms (resident under (0.14, 0.21) and
    the CLI priors' (0.1, 0.3), streaming under (0.14, 0.21)) and the
    ranks' rows over 2 and 4 ranks."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.parallel import statepar

    rng = np.random.default_rng(15)
    reads = chip_smoke.simulated_reads(models, rng)
    batch = chip_smoke.em_kernel_inputs(models, reads, device, rng)["batch"]
    inp = train.round_inputs(*batch, K=6)
    every = torch.arange(inp["x_unc"].shape[0], device=device)
    loaded = chip_smoke.load_trans_table(device)[2]
    priors = chip_smoke.load_trans_table(
        device, chip_smoke.PRIORS_P_STAY, chip_smoke.PRIORS_P_SKIP,
        "trans_priors.tsv")[2]
    forms = {"resident (0.14, 0.21)": loaded,
             "resident (0.1, 0.3)": priors,
             "streaming (0.14, 0.21)": loaded._replace(fwbw_packed=None)}
    subs = {M: [statepar._select_rank_rows(r, every)
                for r in statepar.split_round_states(*batch, [device] * M)]
            for M in (2, 4)}
    return batch, inp, forms, subs


def time_legacy_mesh(models, device, card: str) -> None:
    """K6cm (three forms) and K6dm at the EM chunk over 2 and 4 ranks on
    both exchange paths, against K6c and K6d on the whole rows, in turns
    (the module docstring's --legacy-mesh), bit-equal."""
    import torch

    from nanocall_tpu_torch import roofline
    from nanocall_tpu_torch.ops import em, hmm
    from nanocall_tpu_torch.parallel import statepar

    batch, inp, forms, subs = legacy_mesh_inputs(models, device)
    B, T = inp["x_unc"].shape
    every = torch.arange(B, device=device)
    paths = (("cluster", None), ("cooperative", False))

    def spans(fn, name, module=hmm) -> float:
        return 1e3 * chip_smoke.launch_spans(fn, name, device, 1,
                                             module)["device_s"]

    def bits(x):
        return x.view(torch.int32)

    calls = {}  # name: (fn, timed wrapper, module, steps, resident, M)
    blocks = hasattr(hmm, "fwbw_wave_reads")  # K6cm's reads a block

    def forced(fn, reads: int):
        """fn with K6cm at `reads` reads a block."""
        def run():
            keep = hmm.fwbw_wave_reads
            hmm.fwbw_wave_reads = lambda *a, **k: reads
            try:
                return fn()
            finally:
                hmm.fwbw_wave_reads = keep
        return run

    if blocks:
        subs[8] = [statepar._select_rank_rows(r, every) for r in
                   statepar.split_round_states(*batch, [device] * 8)]

    for form, ops in forms.items():
        resident = form.startswith("resident")
        wrapper = ("fwbw_wave_resident_kernel" if resident
                   else "fwbw_wave_streaming_kernel")
        calls[f"K6c {form}"] = (
            lambda ops=ops: hmm.fwbw(ops, inp["model"], inp["ev"]),
            "fwbw_resident_kernel" if resident else "fwbw_generic_kernel",
            hmm, 2 * (T - 1), resident, 1)
        for M, (path, cluster) in itertools.product((2, 4), paths):
            calls[f"K6cm {form} over {M} ranks, {path}"] = (
                lambda ops=ops, M=M, cluster=cluster:
                statepar._fwbw_generic_row(ops, subs[M], True, cluster),
                wrapper, hmm, 2 * (T - 1), resident, M)
        for M, (path, cluster) in itertools.product(
                (2, 4, 8) if blocks and form != "resident (0.1, 0.3)"
                else (), paths):
            W = 4096 // M
            on = cluster is None
            for reads in (1, 2, 4, 8):
                if ((reads == hmm.fwbw_wave_reads(W, 21, resident, on)
                     and M != 8) or 4096 // W < reads or hmm.fwbw_wave_smem(
                            reads, W, 21, resident, on)
                        > hmm.FWBW_WAVE_SMEM
                        or (M == 8 and not on)):
                    continue
                calls[f"K6cm {form} over {M} ranks, {path}, {reads} reads "
                      f"a block"] = (
                    forced(lambda ops=ops, M=M, cluster=cluster:
                           statepar._fwbw_generic_row(ops, subs[M], True,
                                                      cluster), reads),
                    wrapper, hmm, 2 * (T - 1), resident, M)
    calls["K6d"] = (lambda: hmm.fwbw_backward_kernel(
        inp["gtf"], inp["model"], inp["ev"]), "fwbw_backward_kernel", hmm,
        T - 1, False, 1)
    for M, (path, cluster) in itertools.product((2, 4), paths):
        calls[f"K6dm over {M} ranks, {path}"] = (
            lambda M=M, cluster=cluster: statepar._fwbw_grouped_row(
                subs[M], True, cluster),
            "fwbw_backward_wave_kernel", em, T - 1, False, M)
    # bit-equality once, and a warm-up
    want = {form: hmm.fwbw(ops, inp["model"], inp["ev"])
            for form, ops in forms.items()}
    k6d = hmm.fwbw_backward_kernel(inp["gtf"], inp["model"], inp["ev"])
    for name, (fn, *_) in calls.items():
        out = fn()
        torch.cuda.synchronize()
        if name.startswith("K6cm"):
            w = want[name[5:name.index(" over")]]
            for k in ("alpha", "beta", "em"):
                got = torch.cat([o[k] for o in out], dim=-1)
                assert torch.equal(bits(got), bits(w[k])), (name, k)
            for o in out:
                assert torch.equal(bits(o["log_pr_data"]),
                                   bits(w["log_pr_data"])), name
        elif name.startswith("K6dm"):
            got = torch.cat([o["beta"] for o in out], dim=-1)
            assert torch.equal(bits(got), bits(k6d)), name
        del out
    del want, k6d
    # a warm-up round: the timed calls' allocations come from the cache
    for fn, *_ in calls.values():
        fn()
    ms = {name: [] for name in calls}
    order = list(calls)
    for _ in range(LEGACY_MESH_REPS):
        for name in (*order, *reversed(order)):
            fn, wrapper, module, *_ = calls[name]
            ms[name].append(spans(fn, wrapper, module))
    base = {}
    for name, (_, wrapper, _, steps, resident, M) in calls.items():
        v = ms[name]
        mean = sum(v) / len(v)
        if M == 1:
            base[name.split(" ", 1)[1] if " " in name else ""] = mean
            bname = ("fwbw_resident" if resident else "fwbw_generic") \
                if name.startswith("K6c ") else "fwbw_grouped_backward"
            b = roofline.kernel_bound(bname, B, T)
            print(f"legacy mesh {name} B={B} T={T}: {mean:.3f} ms a call "
                  f"(turns {', '.join(f'{x:.3f}' for x in v)}); bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]",
                  flush=True)
            continue
        W = 4096 // M
        if name.startswith("K6cm"):
            form = name[5:name.index(" over")]
            ref = base[form]
            deg = 21
            if not blocks:
                reads = 1
            elif "reads a block" in name:
                reads = int(name.split(", ")[-1].split()[0])
            else:
                reads = hmm.fwbw_wave_reads(W, deg, resident, True)
            keep = getattr(hmm, "fwbw_wave_reads", None)
            if blocks:
                hmm.fwbw_wave_reads = lambda *a, **k: reads
            try:
                clusters = hmm.fwbw_wave_resident(
                    device, False, resident, deg, W, cluster=True) // M
            finally:
                if blocks:
                    hmm.fwbw_wave_reads = keep
            groups = (hmm.fwbw_wave_grid(B, M, reads, True)["grid"][1]
                      if blocks else B)
            rounds = -(-groups // clusters)
        else:
            ref = base[""]
            rounds = -(-B // (em.fwbw_backward_wave_resident(
                device, False, W, cluster=True) // M))
        step = (f", {1e3 * mean / (rounds * steps):.2f} µs a step over "
                f"{rounds} rounds of reads" if "cluster" in name else "")
        print(f"legacy mesh {name} B={B} T={T}: {mean:.3f} ms a call "
              f"(turns {', '.join(f'{x:.3f}' for x in v)}) = "
              f"{mean / ref:.2f}x the one-card kernel{step}; bit-equal to "
              f"it [{card}]", flush=True)
    for M in (2, 4):
        ex = roofline.statepar_exchange_bytes(B, T, M)
        print(f"legacy mesh over {M} ranks read from the peers: K6cm's "
              f"columns {ex['fwbw_columns'] / 1e9:.3f} GB, K6dm's block sums "
              f"{ex['beta_sums'] / 1e9:.3f} GB and maxima "
              f"{ex['beta_maxima']} B [{card}]", flush=True)
    with open(os.path.join(os.path.dirname(hmm.__file__), os.pardir, "csrc",
                           "fwbw_generic_wave.cu")) as fh:
        if "NC_SPLIT" in fh.read():
            split_legacy_mesh(forms, subs, ms, device, card)


#: the SPLIT build's C entries (csrc/fwbw_generic_wave.cu and
#: fwbw_backward_wave.cu with NC_SPLIT): K6cm's and K6dm's launches and
#: their cycle counters
SPLIT_ENTRIES = ("nc_fwbw_generic_wave", "nc_fwbw_generic_wave_resident",
                 "nc_fwbw_backward_wave", "nc_fwbw_backward_wave_resident")
SPLIT_COUNTERS = ("nc_fwbw_generic_wave_split", "nc_fwbw_backward_wave_split")


def variant_library(define: str = "NC_SPLIT"):
    """K6cm's and K6dm's sources built with `define` (NC_SPLIT: their
    cluster instances stamped; NC_BARRIER: their exchange a cluster
    barrier) into a library of their own under the checkout's build
    directory, with the main library's argument types."""
    import ctypes

    from nanocall_tpu_torch.ops import _cuda

    main = _cuda.load()
    out = os.path.join(_cuda.BUILD_DIR, define.lower())
    os.makedirs(out, exist_ok=True)
    srcs = ("fwbw_generic_wave.cu", "fwbw_backward_wave.cu")
    objs = [os.path.join(out, f"{s}.o") for s in srcs]
    lib = os.path.join(out, f"libnc_{define.lower()}_{os.getpid()}.so")
    nvcc = _cuda._nvcc()
    _cuda._run_all([nvcc, *_cuda.NVCC_FLAGS, f"-D{define}", "-c", "-o", o,
                    os.path.join(_cuda.CSRC, s)] for s, o in zip(srcs, objs))
    _cuda._run_all([[nvcc, *_cuda.ARCH, "-shared", "-o", lib, *objs]])
    split = ctypes.CDLL(lib)
    for name in SPLIT_ENTRIES:
        getattr(split, name).restype = getattr(main, name).restype
        getattr(split, name).argtypes = getattr(main, name).argtypes
    for name in SPLIT_COUNTERS if define == "NC_SPLIT" else ():
        getattr(split, name).restype = ctypes.c_int
        getattr(split, name).argtypes = [ctypes.c_int, ctypes.c_void_p]
    return main, split


class _SplitLibrary:
    """The main kernel library with K6cm's and K6dm's entries taken from
    a variant build (variant_library)."""

    def __init__(self, main, split):
        self.main, self.split = main, split

    def __getattr__(self, name):
        lib = self.split if name in SPLIT_ENTRIES else self.main
        return getattr(lib, name)


def split_legacy_mesh(forms, subs, ms, device, card: str) -> None:
    """The split of a cluster step of K6cm (the resident form under
    (0.14, 0.21), the streaming form) and of K6dm over 2 and 4 ranks: one
    warm call, then one stamped call each, its cycles in thread 0 of every
    block summed over the blocks and divided by their steps; the shares of
    a step beside the step's µs of the timed turns (`ms`)."""
    import ctypes

    import torch

    from nanocall_tpu_torch.ops import _cuda, hmm
    from nanocall_tpu_torch.parallel import statepar

    main, split = variant_library()
    counts = (ctypes.c_ulonglong * 4)()
    dev = torch.device(device).index or 0
    hmm._fwbw_wave_resident.clear()
    _cuda._lib = _SplitLibrary(main, split)
    try:
        cases = []
        for M in (2, 4):
            for form in ("resident (0.14, 0.21)", "streaming (0.14, 0.21)"):
                cases.append((f"K6cm {form} over {M} ranks, cluster",
                              SPLIT_COUNTERS[0], ("wait", "slot loop",
                                                  "push"),
                              lambda ops=forms[form], M=M:
                              statepar._fwbw_generic_row(ops, subs[M], True,
                                                         None)))
            cases.append((f"K6dm over {M} ranks, cluster", SPLIT_COUNTERS[1],
                          ("beta step", "push", "wait"),
                          lambda M=M: statepar._fwbw_grouped_row(
                              subs[M], True, None)))
        for name, counter, parts, fn in cases:
            fn()
            torch.cuda.synchronize()
            _cuda.check(getattr(split, counter)(dev, counts), counter)
            fn()
            torch.cuda.synchronize()
            _cuda.check(getattr(split, counter)(dev, counts), counter)
            steps = max(counts[3], 1)
            cyc = [counts[i] / steps for i in range(3)]
            total = sum(cyc)
            v = ms.get(name, [])
            mean = sum(v) / len(v) if v else float("nan")
            shares = ", ".join(f"{p} {c:.0f} cycles ({100 * c / total:.1f}%)"
                               for p, c in zip(parts, cyc))
            print(f"split {name}: a step of thread 0 of each block, {shares}"
                  f"; the unstamped call {mean:.3f} ms in the turns; "
                  f"{counts[3]} block steps [{card}]", flush=True)
    finally:
        _cuda._lib = main
        hmm._fwbw_wave_resident.clear()


def time_legacy_exchange(models, device, card: str) -> None:
    """K6cm (resident and streaming under (0.14, 0.21)) and K6dm on the
    cluster path over 2 and 4 ranks at the EM chunk, each step's exchange
    on mbarriers (the kernel library) against the same kernels built with
    NC_BARRIER (a push a plain store into the peers, the wait a cluster
    barrier), in turns (mbarrier, barrier, barrier, mbarrier;
    LEGACY_MESH_REPS rounds), each call's launches of the kernel timed
    alone by CUDA events (chip_smoke.launch_spans); the two builds'
    outputs bit-equal."""
    import torch

    from nanocall_tpu_torch.ops import _cuda, em, hmm
    from nanocall_tpu_torch.parallel import statepar

    _, inp, forms, subs = legacy_mesh_inputs(models, device)
    B, T = inp["x_unc"].shape
    main, variant = variant_library("NC_BARRIER")
    libs = {"mbarrier": main, "barrier": _SplitLibrary(main, variant)}
    calls = {}  # name: (fn, the kernel's wrapper, its module)
    for M in (2, 4):
        for form in ("resident (0.14, 0.21)", "streaming (0.14, 0.21)"):
            calls[f"K6cm {form} over {M} ranks"] = (
                lambda ops=forms[form], M=M:
                statepar._fwbw_generic_row(ops, subs[M], True, None),
                f"fwbw_wave_{form.split()[0]}_kernel", hmm)
        calls[f"K6dm over {M} ranks"] = (
            lambda M=M: statepar._fwbw_grouped_row(subs[M], True, None),
            "fwbw_backward_wave_kernel", em)

    def use(name):
        _cuda._lib = libs[name]
        hmm._fwbw_wave_resident.clear()
        em._beta_resident.clear()

    def bits(out):
        return [o[k].view(torch.int32) for o in out for k in sorted(o)
                if torch.is_tensor(o[k]) and o[k].dtype == torch.float32]

    ms = {name: {lib: [] for lib in libs} for name in calls}
    try:
        for name, (fn, *_) in calls.items():
            got = {}
            for lib in libs:
                use(lib)
                got[lib] = bits(fn())  # also the warm-up
            assert all(torch.equal(x, y) for x, y in
                       zip(got["mbarrier"], got["barrier"])), name
        del got
        for _ in range(LEGACY_MESH_REPS):
            for name, (fn, wrapper, module) in calls.items():
                for lib in ("mbarrier", "barrier", "barrier", "mbarrier"):
                    use(lib)
                    ms[name][lib].append(1e3 * chip_smoke.launch_spans(
                        fn, wrapper, device, 1, module)["device_s"])
    finally:
        use("mbarrier")
    for name, v in ms.items():
        mean = {lib: sum(x) / len(x) for lib, x in v.items()}
        turns = "; ".join(f"{lib} {mean[lib]:.3f} ms (turns "
                          f"{', '.join(f'{x:.3f}' for x in runs)})"
                          for lib, runs in v.items())
        print(f"legacy exchange {name}, cluster B={B} T={T}: {turns}; "
              f"barrier / mbarrier {mean['barrier'] / mean['mbarrier']:.3f}"
              f"; bit-equal [{card}]", flush=True)


#: path decodes timed a mesh and path in --generic-mesh
GENERIC_MESH_REPS = 3
#: --generic-mesh's cells: (reads, events, (data, model) mesh on one card)
GENERIC_MESH_CELLS = tuple((128, 8192, m) for m in ((1, 2), (1, 4), (2, 2),
                                                   (1, 8))) + \
    ((16, 8192, (1, 8)),)


def time_generic_mesh(models, device, card: str) -> None:
    """K6am and K6bm against K6a + K6b at GENERIC_MESH_CELLS under the two
    loaded tables (module docstring, --generic-mesh)."""
    import inspect

    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.ops import hmm
    from nanocall_tpu_torch.parallel import mesh, statepar

    paths = ((("cluster", None), ("cooperative", False))
             if "cluster" in inspect.signature(
                 statepar.viterbi_decode_placed).parameters
             else (("cooperative", None),))
    tables = {"loaded (0.14, 0.21)": chip_smoke.load_trans_table(device)[2],
              "priors' loaded (0.1, 0.3)": chip_smoke.load_trans_table(
                  device, chip_smoke.PRIORS_P_STAY, chip_smoke.PRIORS_P_SKIP,
                  "trans_priors.tsv")[2]}
    inputs = {}
    for B, T, _ in GENERIC_MESH_CELLS:
        if (B, T) not in inputs:
            args = chip_smoke.pooled_inputs(models, device, B, T,
                                            np.random.default_rng(19))
            inputs[(B, T)] = (
                hmm.make_scaled_model_arrays(args[5], args[6], args[7]),
                basecall.pooled_ev_batch(*args[:5], args[9]))
            del args
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def events_ms(fn, reps: int) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    for tname, ops in tables.items():
        form = hmm.generic_forward_route(ops)
        wrapper = f"generic_wave_{form}_kernel"
        deg = (ops.from_packed if form == "resident"
               else ops.from_idx).shape[-2]
        for (B, T), (model, ev) in inputs.items():
            ref = hmm.viterbi_decode(ops, model, ev)
            fa, bps = hmm.viterbi_forward(ops, model, ev)
            # warmed up: the decode and the forward above hold its memory
            k6a = events_ms(lambda: hmm.viterbi_forward(ops, model, ev), 3)
            k6b = events_ms(lambda: hmm.viterbi_traceback(
                ops, fa, bps, ev["length"]), 3)
            del fa, bps
            print(f"generic mesh B={B} T={T} under the {tname} table "
                  f"({form}): K6a {k6a:.3f} ms + K6b {k6b:.3f} ms = "
                  f"{k6a + k6b:.3f} ms a path decode on one card [{card}]",
                  flush=True)
            for B_, T_, (D, M) in GENERIC_MESH_CELLS:
                if (B_, T_) != (B, T):
                    continue
                grid = mesh.make_mesh(D * M, model_axis=M,
                                      devices=[device] * (D * M))
                placed = mesh.shard_decode_inputs(grid, ops, model, ev)
                W, b = 4096 // M, B // D
                for path, cluster in paths:
                    kw = {"cluster": cluster} if len(paths) > 1 else {}
                    got = mesh.join(statepar.viterbi_decode_placed(
                        *placed, **kw))
                    for k in ("path", "logp"):
                        assert torch.equal(chip_smoke.bits(got[k]),
                                           chip_smoke.bits(ref[k].cpu())), \
                            (tname, B, D, M, path, k)
                    del got
                    am = chip_smoke.launch_spans(
                        lambda: statepar.viterbi_decode_placed(*placed, **kw),
                        wrapper, device, GENERIC_MESH_REPS)
                    bm = chip_smoke.launch_spans(
                        lambda: statepar.viterbi_decode_placed(*placed, **kw),
                        "generic_traceback_slices_kernel", device, 1)
                    ms = 1e3 * am["device_s"] / GENERIC_MESH_REPS
                    launches = am["launches"] // GENERIC_MESH_REPS
                    rounds = launches
                    extra = ""
                    if path == "cluster" and hmm.wave_cluster(M, False):
                        # a tree whose K6a layout takes several codebooks a
                        # slot: the rank's cut holds those of its blocks
                        groups = ({"groups": max(1, W * hmm.resident_groups(
                            ops) // 4096)} if form == "resident" and hasattr(
                                hmm, "resident_groups") else {})
                        blocks = hmm.generic_wave_resident(
                            device, True, False, form == "resident", deg, W,
                            cluster=True, **groups)
                        rounds = D * -(-b // (blocks // M))
                        extra = (f", {blocks / sms:.2f} blocks an SM, "
                                 f"{blocks // M} reads at once")
                    print(f"generic mesh {(D, M)} B={B} T={T} under the "
                          f"{tname} table ({form} K6am, {path} path): K6am "
                          f"{ms:.3f} ms a path decode (decodes "
                          f"{GENERIC_MESH_REPS}), {launches} launches, "
                          f"{rounds} rounds of reads{extra}, "
                          f"{1e3 * ms / (rounds * (T - 1)):.2f} µs a step; "
                          f"K6bm {1e3 * bm['device_s']:.3f} ms; = "
                          f"{ms / k6a:.2f}x K6a; path and logp bit-equal to "
                          f"K6a + K6b [{card}]", flush=True)
                del placed
            del ref
            torch.cuda.empty_cache()


#: --slice-walks' (data, model) meshes on one card, and calls a turn
SLICE_WALK_CELLS = ((1, 2), (1, 4), (1, 8), (2, 2), (1, 16), (1, 32), (1, 64))
SLICE_WALK_REPS = 5


def _tree_slices(bps, D: int, M: int):
    """bps (T - 1, B, 4096) cut into D data rows over M ranks as this
    tree's statepar lays the slices out: [row][rank] (T - 1, B / D, W)."""
    import torch

    from nanocall_tpu_torch.parallel import statepar

    Tm, B, n = bps.shape
    b, W = B // D, n // M
    dev = bps.device
    if hasattr(statepar, "backpointer_slices"):
        rows, _ = statepar.backpointer_slices([[(dev, b, W)] * M] * D,
                                              Tm + 1)
    else:
        rows = [[torch.empty((Tm, b, W), dtype=torch.uint8, device=dev)
                 for _ in range(M)] for _ in range(D)]
    for r, row in enumerate(rows):
        for m, x in enumerate(row):
            x.copy_(bps[:, r * b:(r + 1) * b, m * W:(m + 1) * W])
    return rows


def time_slice_walks(models, device, card: str) -> None:
    """K6bm and K2m against K6b's and K2's rings at SLICE_WALK_CELLS (module
    docstring, --slice-walks)."""
    import inspect

    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.ops import hmm

    ops = chip_smoke.load_trans_table(device)[2]
    args = chip_smoke.pooled_inputs(models, device, 128, 8192,
                                    np.random.default_rng(19))
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    drawn = ev["length"]
    full = torch.full_like(drawn, 8192)
    B = drawn.shape[0]
    rows_api = "route" in inspect.signature(
        hmm.generic_traceback_slices_kernel).parameters
    walks = {
        "K6bm": (hmm.viterbi_forward(ops, model, ev),
                 lambda fa, bps, ln: hmm.generic_traceback_ring_kernel(
                     ops, fa, bps, ln),
                 lambda *a, **kw: hmm.generic_traceback_slices_kernel(
                     ops, *a, **kw)),
        "K2m": (hmm.viterbi_forward_grouped(gt, model, ev),
                lambda fa, bps, ln: hmm.traceback_kernel(6, fa, bps, ln),
                lambda *a, **kw: hmm.traceback_slices_kernel(6, *a, **kw))}
    del model, ev, gt
    for name, ((fa, bps), ring, walk) in walks.items():
        for D, M in SLICE_WALK_CELLS:
            b, W = B // D, 4096 // M
            slices = _tree_slices(bps, D, M)
            for what, lengths in (("as drawn", drawn), ("full", full)):
                cols = [[fa[r * b:(r + 1) * b, m * W:(m + 1) * W]
                         .contiguous() for m in range(M)] for r in range(D)]
                lns = [lengths[r * b:(r + 1) * b].contiguous()
                       for r in range(D)]
                calls = {"ring": lambda: ring(fa, bps, lengths)}
                if rows_api:
                    calls["walk"] = lambda: walk(cols, slices, lns)
                    calls["copies"] = lambda: walk(cols, slices, lns,
                                                   route="copies")
                else:
                    calls["walk"] = lambda: [walk(c, sl, ln) for c, sl, ln
                                             in zip(cols, slices, lns)]
                want = ring(fa, bps, lengths)
                for call in list(calls)[1:]:
                    got = calls[call]()
                    for r, row in enumerate(got):
                        for g, w in zip(row, want):
                            assert torch.equal(
                                chip_smoke.bits(g),
                                chip_smoke.bits(w[r * b:(r + 1) * b])), \
                                (name, D, M, what, call, r)
                order = list(calls) + list(calls)[::-1]
                turns = {k: [] for k in calls}
                for k in order:
                    turns[k].append(chip_smoke.cuda_ms(calls[k],
                                                       SLICE_WALK_REPS))
                launches = 1 if rows_api else D
                ratio = sum(turns["walk"]) / sum(turns["ring"])
                print(f"slice walk {name} {(D, M)} B={B} T=8192 {what}: "
                      + "; ".join(f"{k} {sum(v) / len(v):.3f} ms (turns "
                                  f"{', '.join(f'{x:.3f}' for x in v)})"
                                  for k, v in turns.items())
                      + f"; walk / ring {ratio:.3f}; {launches} walk "
                      f"launch(es); bit-equal to the ring [{card}]",
                      flush=True)
            del slices
            torch.cuda.empty_cache()
        del fa, bps


def pass_ms(fn) -> float:
    """The device milliseconds of the launches fn() enqueues on the current
    stream, timed by CUDA events around the call, the stream held first
    (10 EM_MESH_HOLD cycles) so that the host's enqueue falls inside the
    hold."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 * EM_MESH_HOLD)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


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


#: time_stream's cases: (function, B, T, tables), the tables among
#: "loaded" (the (0.14, 0.21) table without its packed layout), "random"
#: (a seeded random 21-slot table), "random 1" (a seeded random table of
#: one slot) and "per read" (per-read structured tables without their
#: layout); the reads between one and 512 and K6e at 512 x 128 bound the
#: route's choice (hmm.fwbw_stream_split)
STREAM_CASES = (("fwbw", 512, 128, ("loaded", "random", "per read",
                                    "random 1")),
                ("fwbw", 1, 4000, ("loaded", "random", "random 1")),
                ("fwbw", 24, 128, ("loaded",)),
                ("fwbw", 48, 128, ("loaded",)),
                ("fwbw", 96, 128, ("loaded", "per read")),
                ("fwbw", 192, 128, ("loaded",)),
                ("fwbw_custom", 16, 2048, ("loaded", "per read")),
                ("fwbw_custom", 1, 4000, ("loaded", "per read")),
                ("fwbw_custom", 64, 512, ("loaded",)),
                ("fwbw_custom", 512, 128, ("loaded", "per read")))
#: --stream-slots' cases: tables of few slots (seeded random tables of d
#: slots, "random d"), where the slot loop is short beside the split's
#: exchange
STREAM_SLOT_CASES = tuple(
    [(fn, B, 128, tuple(f"random {d}" for d in (1, 2, 4, 8)))
     for fn in ("fwbw", "fwbw_custom") for B in (48, 192, 512)]
    + [("fwbw", 512, 128, ("per read",))])
STREAM_REPS = 3


def time_stream(models, device, card: str, cases=STREAM_CASES) -> None:
    """The streaming K6c and K6e at STREAM_CASES (module docstring,
    --stream), or at `cases`."""
    import hashlib

    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm

    # ptxas' registers and spill, where the tree's smoke reads them
    for name, r in getattr(chip_smoke, "stream_ptxas", dict)().items():
        print(f"ptxas {name}: {r} [{card}]", flush=True)
    loaded = chip_smoke.load_trans_table(device)[2]._replace(
        fwbw_packed=None)
    random21 = chip_smoke.random_table_ops(device, 21, 21)
    for fn, B, T, names in cases:
        _, model, ev = chip_smoke.kernel_inputs(
            models, device, max(B, 4), T, np.random.default_rng(19))
        if B < 4:
            model = hmm.ModelArrays(*(x[:B].contiguous() for x in model))
            ev = {k: v[:B].contiguous() for k, v in ev.items()}
        tables = {"loaded": loaded, "random": random21,
                  **{f"random {d}": chip_smoke.random_table_ops(device, d, d)
                     for d in (1, 2, 4, 8)}}
        if "per read" in names:
            # under few slots, per-read log-probs of one random slot
            tables["per read"] = (
                chip_smoke.random_stream_ops(device, 1, 1, B)
                if cases is STREAM_SLOT_CASES
                else chip_smoke.per_read_tables(
                    device, B, np.random.default_rng(23))[0]._replace(
                        fwbw_packed=None))
        wrapper = (hmm.fwbw_generic_kernel if fn == "fwbw"
                   else hmm.fwbw_custom_kernel)
        for name in names:
            ops = tables[name]
            deg = ops.from_idx.shape[0] + ops.to_idx.shape[0]
            # the route's call, then (in a tree that has the one-card
            # split) each of its forms
            calls = {"route": lambda: wrapper(ops, model, ev)}
            if hasattr(hmm, "FWBW_SPLIT_STATES"):
                for S in hmm.FWBW_SPLIT_STATES:
                    calls[f"split S={S}"] = (
                        lambda S=S: wrapper(ops, model, ev, S))
                print(f"stream {fn} {name} B={B} T={T}: the route takes "
                      f"S={hmm.fwbw_stream_split(B)} [{card}]", flush=True)
            ref = calls["route"]()
            torch.cuda.synchronize()
            digest = hashlib.sha1(b"".join(
                ref[k].contiguous().view(torch.int32).cpu().numpy()
                .tobytes() for k in sorted(ref))).hexdigest()[:12]
            for what, call in calls.items():
                out = call()
                torch.cuda.synchronize()
                # every other call's outputs as bits against the route's
                assert all(torch.equal(out[k].view(torch.int32),
                                       ref[k].view(torch.int32))
                           for k in ref), (fn, name, what, "outputs differ")
                del out
                ms = chip_smoke.cuda_ms(call, STREAM_REPS)
                # one block a read reads each slot's two 16 KB rows twice a
                # step
                l2 = 2 * (T - 1) * deg * 32768 * B
                tag = "" if what == "route" else f" {what}"
                print(f"stream {fn} {name}{tag} B={B} T={T}: {ms:.3f} ms; "
                      f"outputs {digest}; table bytes read from L2 by one "
                      f"block a read {l2 / 1e9:.3f} GB [{card}]",
                      flush=True)
            del ref
        del model, ev, tables
        torch.cuda.empty_cache()

if __name__ == "__main__":
    sys.exit(main())
