#!/usr/bin/env python3
"""Smoke run of nanocall_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It

  1. prints the card (nvidia-smi name and power limit), and the CUDA and
     nvcc versions;
  2. builds the CUDA kernels from nanocall_tpu_torch/csrc and prints the
     build seconds, ptxas' register / spill report, the FFMA count of
     K8's SASS (cuobjdump -sass), and a static census of the time loops of
     K1 (path and score-only), K3's forward chunk, K1m's eight instances,
     K4, K5 and K6d: instructions per state and step, by class
     (step_loop_sass), of the traceback walks of K2, K2m, K3 and K9
     (walk_loop_sass), and of the resident K6c's and K6e's two time loops
     (barrier_loops_sass): K4's and K6d's loops must hold at most 2 block
     barriers, K1m's read the column by at least 4 strong loads and
     spill nothing,
     K2's, K2m's and K6b's ring walks no global load (their rows and K6b's
     from-state table come from shared memory; K6b stores its path), the
     resident K6c's loops no
     global load but the stored emissions' (no slot-table byte), the
     resident K6e's forward loop 3 block barriers and its backward loop 1,
     and no slot-table byte from global memory;
  3. writes the 21-neighbour transition tables of (p_stay 0.14, p_skip
     0.21) and of the CLI priors (0.1, 0.3) as transitions TSVs and loads
     them back through the port CLI's `-s/--trans` loader: loaded tables
     of the r73 width, in-degree 21 (K6a resident under the first,
     streaming under the priors'; K6c resident under both);
  4. runs each decode kernel on the card at the decode's full width
     (n = 4096 states, B = 16 reads of up to T = 2048 events, lengths from
     0 to T, per-read scaling and transitions): the grouped K1 (path and
     score-only) and K2, and under the loaded table the generic K6a's two
     kernels (streaming and resident, path and score-only, timed in turns:
     streaming, resident, resident, streaming), K6b's two kernels
     (streaming, and the ring the table takes; timed in turns) and K6e's
     two (the per-step-normalized forward-backward of `run-fwbw
     --custom-fwbw`: alpha, beta and gamma of 3 x 0.54 GB; the resident
     kernel the table takes and the streaming one, timed in turns; both
     also on inputs with NaN events, a +inf event and a NaN model entry,
     and the resident one's instance for any slot count under a random
     packed table of 12 / 23 slots); holds each to its plain
     PyTorch version on the same inputs: tolerance 0, every output
     bit-equal; prints both times; K1 (path and score-only), K3's forward
     chunk and K9 (2 ranks) again on the inputs with NaN events in one
     read, a NaN stay entry in another and a NaN model entry in a third,
     bit-equal to their plain versions, and on them K2 (path0, codes,
     logp; the NaN stay entry's read ends on a final alpha that is NaN at
     some states) bit-equal to its plain version and K3's decode bit-equal
     to K1 + K2; then K6a through viterbi_forward under
     a random table of 24 slots x 16 log-probs (the resident kernel's
     widest layout), under the in-memory 21-neighbour pairs, whose
     slots hold up to 17 log-probs (the streaming kernel), and under a
     random table of 25 slots (both streaming kernels), each bit-equal
     to the plain version, with K6b (the ring, but the streaming kernel
     under the 25 slots) on its output; then
     K3, the chunked-time decode's forward and traceback
     kernels, at the same shape in chunks of 600 events (a short last
     chunk): each chunk's outputs against the plain versions (tolerance 0)
     and the chunked decode against K1 + K2 (path0, codes, logp
     bit-equal);
     then the measurement path: K8, the FMA chain of
     roofline.measure_fma_peak, at B = 16 rows x n = 4096 lanes x T = 2048
     steps of k = 24 FMAs (K1's step's work) against its plain version
     (tolerance 0: both round once per FMA), both times, and a counting
     run (x = 0, c = 1, d = 2^-10, exact in float32) that must give
     T k d in every lane; measure_fma_peak itself at each shape the kernels are
     timed at (16 x 2048, K3's chunk 4 x 8192, the EM chunk 512 x 128),
     and K1's share of the measured peak and of the 67 TFLOP/s spec; then
     K10, the repro's (8, 128, 4) -> (8, 512)
     reshape copy, bit-equal to its plain version, timed in turns with the
     library call (x.reshape(8, 512).clone()), each split into host
     enqueue and device time (torch.profiler), and
     tools/torch_reshape_repro.py's main on the card (PASS);
  5. runs K3 at long-read widths, B = 4 reads x T = 40,960 events in chunks
     of 8,192: the chunked decode bit-equal to K1 + K2 (the plain versions
     would take minutes there; they are held to K1/K2's above), one
     chunk (events [8192, 16384)) against its plain versions on the same
     carry (tolerance 0) with both times, K9's traceback chunk (the states
     twin) on the same rows against its plain version, and both decodes'
     times; then K9, the sequence-parallel decode
     (parallel.seqpar.viterbi_decode_seqpar), with every rank on the one
     card on a stream of its own: at 16 x 2048 over 2 and 4 ranks with
     n_blocks 1 and D, path and logp bit-equal to its plain version
     (viterbi_decode_seqpar_plain; both times and K9's bound printed), logp
     bit-equal to K1's and each path,
     up to the read's length, equal to the states rebuilt from K2's codes
     and past it the end state; at 4 x 40,960 over 4 ranks, n_blocks 1 and
     4, the same against K3's decode, with K9's time beside K3's, its
     bound and its peak memory, and one more decode counted as K9's path
     (16 launches of each kernel); then the mesh's state axis
     (parallel.mesh.make_mesh, shard_pooled_decode_inputs and
     parallel.statepar: K1m and K2m, K1 and K2 with the 4096 states split
     over the ranks of a data row, every rank on the one card): at 16 x
     2048 over 2 and 4 ranks, path and score-only, on the clean and the
     NaN inputs above, bit-equal to K1 + K2 and (with backpointers, 2
     ranks) to the plain versions; on the NaN inputs at 2 ranks, one K1m
     launch (a wave of all 16 reads, both ranks) against its plain version
     (column buffers and backpointers as bits) with its time (CUDA events
     around each launch, and the host's enqueue; and how many of 5
     launches torch.profiler records), and K2m on its output against its
     plain version and K2's ring; then the path chunk, 128 reads x 8,192 events
     through basecall.decode_chunk_pooled placed on (data, model) meshes
     of (1, 2), (1, 4) and (2, 2): path0, codes and logp (and the
     score-only logp) bit-equal to the unplaced decode (K1 + K2), each
     mesh's decode counted as the mesh path (one K1m launch a wave and
     data row, statepar.plan_waves on the card's resident blocks, and one
     K2m a data row), its wall, host enqueue and device seconds and K1m's
     and K2m's device time beside K1 + K2's, its bound, its peak device
     memory, each rank's backpointer bytes and the bytes its ranks read
     from each other (roofline.statepar_exchange_bytes); and K2m against
     K2's ring at 128 x 8192 over 2, 4 and 64 ranks, in turns, as drawn
     and at full lengths; then the generic decode on the state axis
     (parallel.mesh.shard_decode_inputs and
     parallel.statepar.viterbi_decode_placed: K6am and K6bm, K6a and K6b
     with the 4096 states split over a data row's ranks): at 16 x 2048 on
     the NaN inputs, one K6am launch over 2 ranks in its resident form
     (under the loaded table) and in its streaming form (under the
     priors' table) against its plain version (column slices and
     backpointers as bits) and timed by CUDA events around each of 5
     launches, K6bm on its output with the from-state table and with
     from_idx against its plain version and K6b's ring, and K6a under
     per-read structured tables (build_structured_batch,
     convert.trans_ops_batch; both kernels, path and score-only) against
     its plain version; then the path chunk's events and models, 128 x
     8,192, decoded on (1, 2), (1, 4) and (2, 2) meshes of cuda:0 under
     the loaded table, the priors' table and per-read tables, path and
     score-only, each bit-equal to K6a + K6b, counted as the generic mesh
     path (one K6am launch a wave and data row, waves from K6am's own
     resident blocks, one K6bm a row), with K6am's and K6bm's device
     time;
  6. runs the EM kernels at the EM chunk's full width: n = 4096, 128
     training groups x 4 = 512 rows of T = 128 events, packed by
     nanocall_tpu_torch.basecall.pack_train_batch from the simulated reads
     below, with rows of length 0, 1, T-1 and T, invalid rows, both r73
     strands' models and varied scaling and transition parameters: K4
     forward, with and without the alpha store; K5 fused backward with all
     statistics, with train_transitions off and with train_scaling off;
     K4 and K5 again on inputs with NaN events in one row, a NaN model
     entry in another and a +inf event in a third (bits compared); K6d,
     the grouped backward with its betas stored, on the chunk, on NaN
     events, a +inf event and a NaN model entry, and on the chunk with half
     its rows of length 0 (bits compared; timed on the full and the
     half-idle chunk); and K6c, the generic
     forward-backward (alpha, beta and em of 3 x 1.07 GB) on events with a
     NaN and a +inf event, its resident kernel under both loaded tables and
     its streaming kernel under the first without its packed layout
     (bits compared), then its two kernels timed in turns (streaming,
     resident, resident, streaming); holds each to its plain version
     (tolerance 0) and prints both times, and roofline.em_mfu_report for
     K4 + K5 from their times (against the measured K8 peak at that shape
     and the spec); then the EM round on the mesh's state axis
     (parallel.statepar: K4m and K5m, K4 and K5 with the 4096 states split
     over the ranks of a data row, every rank on the one card): the whole
     chunk one data row over 2 and 4 ranks, K4m with the alphas stored and
     fit-only, K5m with both train flags and each alone, and both on the
     chunk with NaN events, a NaN model entry and a +inf event, each
     bit-equal (as bits) to its plain version over the same ranks and to
     K4 / K5, timed by CUDA events around each launch (a pass is one
     launch a wave: statepar.plan_waves on each kernel's own resident
     blocks) beside K4's and K5's times and the bounds, with the bytes the
     ranks read from each other (roofline.statepar_exchange_bytes); then
     the port's multi-device dry run (nanocall_tpu_torch.dryrun, JAX's
     __graft_entry__.py:68) on four ranks of the card, a 2 x 2 mesh,
     counted as its own path: the placed EM round (K4m, K5m) bit-equal to
     the unplaced one, the placed generic decode (K6am, K6bm), the placed
     production decode (K1m, K2m), K9's equality and the sharded
     pipeline's FASTA equality, with JAX's summary line;
  7. drives the pipeline end to end (nanocall_tpu_torch.basecall.
     run_pipeline, `--pore r73 -t 1`) on 24 simulated reads (1D reads of
     2,000-8,000 events and 2-strand hairpin reads of 3,000 + 3,000, drawn
     by nanocall_tpu_torch.simulate.simulate_read and fed as
     in-memory event arrays through nanocall_tpu_torch.ingest, since fast5
     reading needs h5py) and writes FASTA and stats with the port CLI's
     writer into build/chip_smoke/, five times: untrained (`--no-train`;
     K1 path and score-only, K2); the default trained run (EM training,
     then the decode; K4, K5, K1, K2); trained under the loaded table and
     under the priors' loaded table (`-s`: legacy EM rounds with K4, K6d
     and the resident K6c, never the streaming one, then the decode of the
     trained tasks by K1 and K2); and untrained under the first (`-s --no-train`:
     every task at the priors, so K6a's resident kernel path and
     score-only, and K6b's ring), then that run again with the table's
     packed layout and its from-state table taken away (K6a's and K6b's
     streaming kernels; FASTA byte-equal).  Each
     run checks one FASTA record per decoded strand, identity to the
     simulated truth above 0.6, and that each of its kernels launched; a
     trained run also checks that every trained 1D read's best candidate
     has 0.8 < scale < 1.2 and |shift| < 10 (the reads are simulated at
     identity scaling); each prints its stage times and peak device memory;
  8. a fifth run, "long": the default trained run on 4 long reads (1D
     reads of 33,000, 60,000 and 99,000 events, a hairpin read of 40,000 +
     40,000), whose path chunks all take the chunked decode: it must
     launch K4, K5 and both K3 kernels, and neither K1 with backpointers
     nor K2; then the untrained and the trained runs of the 24 reads again
     over the data sharder (parallel.mesh.DataSharder) of two shards on
     the one card: the untrained FASTA byte-equal, the trained stats within
     rtol 2e-3 of the unsharded runs', decode and EM chunks cut into
     shards; and two hosts emulated in process (parallel.multihost:
     partition_files, a run per host into its shard, merge_shards): the
     merged FASTA byte-equal to the untrained run's;
  9. the dev tools on the card (nanocall_tpu_torch.tools.main in
     process, stdout captured), on TSVs it writes into
     build/chip_smoke/tools/: the builtin r73 template model
     (pore_model.save_tsv), the loaded table above, and one 1D read of
     4,000 events simulated from that model: run-viterbi (K6a with
     backpointers and K6b's ring; identity to the truth above 0.6),
     run-fwbw (the resident K6c) and run-fwbw --custom-fwbw (the resident
     K6e), each printed posterior in [0.1, 1] and descending; both fwbw
     runs again with -o on a 200-event read, whose matrix dumps must give
     posteriors that sum to 1; both fwbw runs once more with the table's
     K6c layout taken away (the streaming K6c and K6e: the same output
     byte for byte); and -K 3 on the card,
     which must raise the kernels' ValueError and launch nothing;
 10. basecall.dump_training_data (`--dump-training-data`) on the in-memory
     summaries of two simulated reads: it must launch the resident K6c
     once per subsequence, and its TSVs
     meet the reference's invariants (fw[0] = em[0] - log n, posteriors
     summing to 1 within 1e-3, dense transition rows of mass in (0.9, 1]);
 11. one more untrained run of the 24 reads (right after the first)
     inside observe.device_trace (`--trace-dir`, torch.profiler): its
     FASTA must equal the untrained run's byte for byte, and the Chrome
     trace it writes must name the K1 and K2 kernels;
 12. prints a JSON line of the kernels (launch counts: the sum over the
     end-to-end runs, the tools, the dump, the measurement path, the
     repro tool, K9's counted decode, the mesh runs, the dry run, the
     sharded runs and the two hosts' runs, and each run's; 28 kernels;
     each kernel's time, its plain version's,
     its shape, its bound on the H100's published peaks
     (roofline.kernel_bound), its achieved float32 rate and that rate's
     share of 67 TFLOP/s and of the K8 peak at its shape, each also
     printed on a line of its own), the card line, and last
     {"ok": true, ...}.

The script imports nothing of JAX and nothing of the JAX package
nanocall_tpu: it reaches the system only through nanocall_tpu_torch, whose
simulator draws its reads.  Nothing is caught but the ValueError that the
-K 3 check expects: any failure exits non-zero before the last line.  With
no CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_KERNEL, T_KERNEL = 16, 2048
TC_KERNEL = 600  # K3's chunk at the kernel phase's shape: a short last chunk
# the traceback walks with more reads than the H100's 132 SMs, as the
# CLI's short buckets batch them (bucket_max_batch 256): chunks of 21
# events put a code group across each chunk border
B_WIDE, T_WIDE, TC_WIDE = 300, 64, 21
B_LONG, T_LONG, TC_LONG = 4, 40960, 8192  # K3 at long-read widths
#: K9's ranks (all on the one card) at the kernel phase's shape; at the
#: long-read width, D_LONG ranks; n_blocks 1 and D each time
D_KERNEL, D_LONG = (2, 4), 4
#: the long run's reads: (2-strand, events per strand)
LONG_READS = ((False, 33000), (False, 60000), (False, 99000), (True, 40000))
G_EM, T_EM = 128, 128  # the default EM chunk: 128 groups x 4 rows, T = 128
N_1D, N_2STRAND = 18, 6
NOISE = 0.5  # the simulated event means' noise, in model level stdvs
SIM_PAD = 70  # simulate_read's pad events at each end of a read
#: the (B, T) shapes at which the kernels are timed, where the measurement
#: path measures K8's peak: the decode kernels', K3's chunk, the EM chunk
PEAK_SHAPES = ((B_KERNEL, T_KERNEL), (B_LONG, TC_LONG), (4 * G_EM, T_EM))
IDENTITY_MIN = 0.6  # tests/test_pipeline.py's bar for untrained decodes
IDENTITY_WINDOW = 2000  # called bases compared per strand (difflib is quadratic)
#: kernels each end-to-end run must launch
UNTRAINED_KERNELS = ("viterbi_forward_path", "viterbi_forward_score",
                     "viterbi_traceback")
TRAINED_KERNELS = ("fwbw_forward", "em_backward", "viterbi_forward_path",
                   "viterbi_traceback")
TRANS_TRAINED_KERNELS = ("fwbw_forward", "fwbw_grouped_backward",
                         "fwbw_resident", "viterbi_forward_path",
                         "viterbi_traceback")
TRANS_UNTRAINED_KERNELS = ("viterbi_resident_forward_path",
                           "viterbi_resident_forward_score",
                           "viterbi_generic_traceback_ring")
#: kernels the same run must launch with the table's packed layout and its
#: from-state table taken away (K6a's and K6b's streaming kernels)
STREAMING_KERNELS = ("viterbi_generic_forward_path",
                     "viterbi_generic_forward_score",
                     "viterbi_generic_traceback")
#: K6a's resident kernel under a random table of its widest layout: slots,
#: distinct log-probs per slot
RANDOM_DEG, RANDOM_VALUES = 24, 16
LONG_KERNELS = ("fwbw_forward", "em_backward", "viterbi_forward_chunk",
                "viterbi_traceback_chunk")
#: kernels K9's decode must launch
SEQPAR_KERNELS = ("viterbi_forward_chunk", "viterbi_traceback_chunk_states")
#: the mesh phase: the (data, model) meshes on the one card, the path
#: chunk they decode, the state-parallel kernels it must launch and the
#: ranks K1m and K2m are held to their plain versions at
MESH_SHAPES = ((1, 2), (1, 4), (2, 2))
B_MESH, T_MESH = 128, 8192
MESH_KERNELS = ("viterbi_forward_slice", "viterbi_traceback_slices")
MESH_RANKS = (2, 4)
#: the ranks K2m is timed at against K2's ring at the path chunk (64: a
#: row of 64 copies of 64 bytes, the most ranks the kernels take)
K2M_RANKS = (2, 4, 64)
#: the generic mesh phase: the kernels the placed generic decode (K6am's
#: two forms, K6bm) must launch, and the kinetics of its per-read tables
GENERIC_MESH_KERNELS = ("viterbi_generic_wave_resident",
                        "viterbi_generic_wave_streaming",
                        "viterbi_generic_traceback_slices")
#: the ranks K4m and K5m run at the EM chunk (the first is the kernels
#: line's), and the kernels the dry run must launch
EM_RANKS = (2, 4)
DRYRUN_KERNELS = ("fwbw_forward_wave", "em_backward_wave",
                  "viterbi_generic_wave_resident",
                  "viterbi_generic_traceback_slices", "viterbi_forward_slice",
                  "viterbi_traceback_slices", "viterbi_forward_chunk",
                  "viterbi_traceback_chunk_states")
#: kernels each host's half of the multi-host emulation must launch (its
#: reads may hold no contest, so no score-only chunk)
HOST_KERNELS = ("viterbi_forward_path", "viterbi_traceback")
#: the loaded table's kinetics: not the CLI priors (0.1, 0.3), so a task
#: routed to the wrong kernel would decode under other transitions
TRANS_P_STAY, TRANS_P_SKIP = 0.14, 0.21
#: the CLI priors: their loaded table holds 17 log-probs in some slots, so
#: K6a takes its streaming kernel under it, and K6c its resident one
PRIORS_P_STAY, PRIORS_P_SKIP = 0.1, 0.3
#: the dev tools' read, and the shorter read of their -o matrix dumps
TOOLS_EVENTS, TOOLS_DUMP_EVENTS = 4000, 200
#: kernels each dev tool run must launch
TOOL_KERNELS = {
    "run_viterbi": ("viterbi_resident_forward_path",
                    "viterbi_generic_traceback_ring"),
    "run_fwbw": ("fwbw_resident",),
    "run_fwbw_custom": ("fwbw_custom_resident",),
    "run_fwbw_streaming": ("fwbw_generic",),
    "run_fwbw_custom_streaming": ("fwbw_custom",),
}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, timed with CUDA events
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms_once(fn):
    """(milliseconds, result) of one call, timed with CUDA events and no
    warm-up: for plain versions too slow to run twice."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def kernel_inputs(models, device, B: int, T: int, rng):
    """Grouped tables, scaled models and events for B reads on `device`,
    made by the port's own table and model functions."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import convert
    from nanocall_tpu_torch.ops import hmm

    names = ("r73.t.006", "r73.c.p1.006")
    bank = convert.model_bank(models, names, device)
    model_idx = np.arange(B, dtype=np.int32) % 2
    pm = np.zeros((B, 6), np.float32)
    pm[:, 0] = rng.uniform(0.9, 1.1, B)
    pm[:, 1] = rng.uniform(-3.0, 3.0, B)
    pm[:, 3] = rng.uniform(0.9, 1.2, B)
    pm[:, 4] = rng.uniform(0.9, 1.1, B)
    pm[:, 5] = rng.uniform(0.9, 1.1, B)
    stp = np.stack([rng.uniform(0.05, 0.2, B), rng.uniform(0.2, 0.4, B)], 1)
    lengths = rng.integers(1, T, B).astype(np.int32)
    lengths[:4] = [T, 0, 1, T - 1]
    states = rng.integers(0, 4096, (B, T))
    lm = np.stack([models[n].level_mean for n in names])
    lm = lm[model_idx][np.arange(B)[:, None], states] * pm[:, :1] + pm[:, 1:2]
    mean = (lm + rng.normal(0.0, 1.0, (B, T))).astype(np.float32)
    stdv = rng.uniform(0.5, 2.0, (B, T)).astype(np.float32)
    for b, L in enumerate(lengths):
        mean[b, L:] = 1.0
        stdv[b, L:] = 1.0
    stdv_t = convert.tensor(stdv, device)
    ev = {"mean": convert.tensor(mean, device), "stdv": stdv_t,
          "log_stdv": torch.log(stdv_t),
          "length": convert.tensor(lengths, device, torch.int32)}
    gt = hmm.make_grouped_trans_device(
        convert.tensor(stp[:, 0].astype(np.float32), device),
        convert.tensor(stp[:, 1].astype(np.float32), device), 6)
    model = hmm.make_scaled_model_arrays(
        bank, convert.tensor(model_idx, device, torch.int32),
        convert.tensor(pm, device))
    return gt, model, ev


def check_kernels(gt, model, ev) -> dict:
    """Each kernel against its plain version on the same card: bit-equal
    outputs (tolerance 0) and times.  Returns {kernel name: record}."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    lengths = ev["length"]
    fa_p, bps_p = hmm.viterbi_forward_grouped_plain(gt, model, ev, True)
    fa_k, bps_k = hmm.forward_path_kernel(gt, model, ev)
    torch.cuda.synchronize()
    assert torch.equal(fa_k, fa_p), "K1 final alpha differs from plain"
    assert torch.equal(bps_k, bps_p), "K1 backpointers differ from plain"
    fa_s = hmm.forward_score_kernel(gt, model, ev)
    torch.cuda.synchronize()
    assert torch.equal(fa_s, fa_p), "K1 score-only alpha differs from plain"
    logp_s, logp_p = torch.amax(fa_s, -1), torch.amax(fa_p, -1)
    assert torch.equal(logp_s, logp_p), "K1 score-only logp differs"
    tb_p = hmm.viterbi_traceback_grouped_plain(6, fa_p, bps_p, lengths)
    tb_k = hmm.traceback_kernel(6, fa_k, bps_k, lengths)
    torch.cuda.synchronize()
    for what, a, b in zip(("path0", "codes", "logp"), tb_k, tb_p):
        assert torch.equal(a, b), f"K2 {what} differs from plain"

    def err(a, b):
        return float((a - b).abs().max())

    rec = {
        "viterbi_forward_path": {
            "max_abs_err": err(fa_k, fa_p),
            "ms": cuda_ms(lambda: hmm.forward_path_kernel(gt, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_forward_grouped_plain(
                gt, model, ev, True), 1)},
        "viterbi_forward_score": {
            "max_abs_err": err(logp_s, logp_p),
            "ms": cuda_ms(lambda: hmm.forward_score_kernel(gt, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_forward_grouped_plain(
                gt, model, ev, False), 1)},
        "viterbi_traceback": {
            "max_abs_err": err(tb_k[2], tb_p[2]),
            "ms": cuda_ms(lambda: hmm.traceback_kernel(6, fa_k, bps_k,
                                                       lengths), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_traceback_grouped_plain(
                6, fa_p, bps_p, lengths), 1)},
    }
    return with_shape(rec, ev)


def nan_inputs(gt, model, ev):
    """Copies of the kernel phase's inputs with NaN events in read 4 from
    event 700 on, a NaN stay entry in read 5 and a NaN model entry in read
    6, those three of full length."""
    from nanocall_tpu_torch.ops import hmm

    gt = hmm.GroupedTrans(*(x.clone() for x in gt[:3]), K=gt.K)
    model = hmm.ModelArrays(*(x.clone() for x in model))
    ev = {k: v.clone() for k, v in ev.items()}
    ev["length"][4:7] = ev["mean"].shape[1]
    ev["mean"][4, 700:] = float("nan")
    gt.stay_lp[5, 1234] = float("nan")
    model.level_mean[6, 99] = float("nan")
    return gt, model, ev


def check_forward_under_nan(gt, model, ev) -> None:
    """K1 (path and score-only), K3's forward chunk (chunks of TC_KERNEL)
    and K9 (2 ranks on the card) on copies of the inputs with NaN events
    in read 4 from event 700 on, a NaN stay entry in read 5 (alpha NaN at
    some states only: the kernel's serial column order) and a NaN model
    entry in read 6, those three of full length: each bit-equal to its
    plain version (tolerance 0; NaN bits compared as bits).  Then K2 on
    K1's output (path0, codes, logp bit-equal to its plain version: read
    5's end state is its first NaN, as torch.argmax takes it) and K3's
    decode in chunks of TC_KERNEL bit-equal to K1 + K2."""
    import torch

    from nanocall_tpu_torch.ops import hmm
    from nanocall_tpu_torch.parallel import seqpar

    gt, model, ev = nan_inputs(gt, model, ev)
    fa_p, bps_p = hmm.viterbi_forward_grouped_plain(gt, model, ev, True)
    assert torch.isnan(fa_p[5]).any() and not torch.isnan(fa_p[5]).all()
    fa_k, bps_k = hmm.forward_path_kernel(gt, model, ev)
    fa_s = hmm.forward_score_kernel(gt, model, ev)
    alpha, rows = None, []
    for t0 in range(0, ev["mean"].shape[1], TC_KERNEL):
        alpha, bps = hmm.forward_chunk_kernel(gt, model, ev, alpha, t0,
                                              TC_KERNEL)
        rows.append(bps)
    torch.cuda.synchronize()
    for what, (fa, bps) in (("K1", (fa_k, bps_k)), ("K1 score", (fa_s, None)),
                            ("K3 forward", (alpha, torch.cat(rows)[1:]))):
        assert torch.equal(bits(fa), bits(fa_p)), f"{what} alpha under NaN"
        if bps is not None:
            assert torch.equal(bps, bps_p), f"{what} bps under NaN"
    devices = [ev["mean"].device] * 2
    got = seqpar.viterbi_decode_seqpar(gt, model, ev, devices, 1)
    want = seqpar.viterbi_decode_seqpar_plain(gt, model, ev, devices, 1)
    torch.cuda.synchronize()
    assert torch.equal(got["path"].int(), want["path"].int()), \
        "K9 path under NaN"
    assert torch.equal(bits(got["logp"]), bits(want["logp"])), \
        "K9 logp under NaN"
    tb_p = hmm.viterbi_traceback_grouped_plain(6, fa_p, bps_p, ev["length"])
    tb_k = hmm.traceback_kernel(6, fa_k, bps_k, ev["length"])
    full = hmm.viterbi_decode_grouped(gt, model, ev)
    chunked = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, TC_KERNEL)
    torch.cuda.synchronize()
    assert torch.isnan(tb_p[2][5]), "read 5's logp is not NaN"
    for what, a, b in zip(("path0", "codes", "logp"), tb_k, tb_p):
        assert torch.equal(bits(a), bits(b)), f"K2 {what} under NaN"
        assert torch.equal(bits(chunked[what]), bits(full[what])), \
            f"K3 decode {what} under NaN differs from K1 + K2"


def with_shape(recs: dict, ev) -> dict:
    """The records, each with the [B, T] of the events it was timed on."""
    return {k: {**r, "shape": list(ev["mean"].shape)} for k, r in recs.items()}


def chunk_events(ev: dict, t0: int, Tc: int) -> dict:
    """Events [t0, t0+Tc) of ev, with the global lengths: what K3's plain
    forward takes."""
    out = {k: ev[k][:, t0:t0 + Tc] for k in ("mean", "stdv", "log_stdv")}
    out["length"] = ev["length"]
    return out


def check_tchunk_kernels(gt, model, ev, Tc: int) -> None:
    """K3's two kernels against their plain versions on the same card, chunk
    by chunk as viterbi_decode_grouped_tchunk links them (tolerance 0: the
    carried alpha, every chunk's backpointers, the carried state and the
    packed codes bit-equal), then the chunked decode against the full
    scan."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    lengths = ev["length"]
    B, T = ev["mean"].shape
    alpha_k = alpha_p = torch.zeros((B, 4096), device=lengths.device)
    chunks = []
    for t0 in range(0, T, Tc):
        alpha_k, bps_k = hmm.forward_chunk_kernel(gt, model, ev, alpha_k, t0,
                                                  Tc)
        alpha_p, bps_p = hmm.viterbi_forward_grouped_chunk_plain(
            gt, model, chunk_events(ev, t0, Tc), alpha_p, t0)
        torch.cuda.synchronize()
        assert torch.equal(alpha_k, alpha_p), f"K3 alpha differs at {t0}"
        assert torch.equal(bps_k, bps_p), f"K3 backpointers differ at {t0}"
        chunks.append((t0, bps_k))
    end = torch.argmax(alpha_k, dim=-1).to(torch.int32)
    codes_k, codes_p = (torch.zeros((B, 3 * (-(-(T - 1) // 4))),
                                    dtype=torch.uint8, device=end.device)
                        for _ in range(2))
    s_k, s_p = end.clone(), end.clone()
    for t0, bps in reversed(chunks):
        s_k = hmm.traceback_chunk_kernel(6, end, s_k, bps, t0, lengths,
                                         codes_k)
        s_p, c = hmm.viterbi_traceback_grouped_chunk_plain(6, end, s_p, bps,
                                                           t0, lengths)
        hmm.or_packed_codes(codes_p, c, t0)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p), f"K3 traceback state differs at {t0}"
        assert torch.equal(codes_k, codes_p), f"K3 codes differ at {t0}"
    check_tchunk_vs_full_scan(gt, model, ev, Tc)


def check_ring_wide(models, device, rng) -> None:
    """The traceback walks with more reads than SMs (B_WIDE reads of
    T_WIDE events, lengths 0 to T_WIDE): K2 against its plain version
    (path0, codes, logp as bits); K3's chunks of TC_WIDE events linked as
    in its decode (check_tchunk_kernels) and K9's states chunk from random
    carried states, each against its plain version."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm

    gt, model, ev = kernel_inputs(models, device, B_WIDE, T_WIDE, rng)
    ev["length"] = torch.arange(B_WIDE, dtype=torch.int32,
                                device=device) % (T_WIDE + 1)
    lengths = ev["length"]
    fa, bps = hmm.forward_path_kernel(gt, model, ev)
    got = hmm.traceback_kernel(6, fa, bps, lengths)
    want = hmm.viterbi_traceback_grouped_plain(6, fa, bps, lengths)
    torch.cuda.synchronize()
    for what, g, w in zip(("path0", "codes", "logp"), got, want):
        assert torch.equal(bits(g), bits(w)), f"K2 {what} at B={B_WIDE}"
    check_tchunk_kernels(gt, model, ev, TC_WIDE)
    end = torch.argmax(fa, dim=-1).to(torch.int32)
    filler = torch.zeros((1, B_WIDE, 4096), dtype=torch.uint8, device=device)
    for t0 in range(0, T_WIDE, TC_WIDE):
        t1 = min(t0 + TC_WIDE, T_WIDE)
        rows = (torch.cat([filler, bps[:t1 - 1]]) if t0 == 0
                else bps[t0 - 1:t1 - 1])
        carry = torch.from_numpy(rng.integers(0, 4096, B_WIDE).astype(
            np.int32)).to(device)
        s_p, states_p = hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, carry, rows, t0, lengths, compact=False)
        s_k = carry.clone()
        states_k = torch.empty((t1 - t0, B_WIDE), dtype=torch.uint16,
                               device=device)
        hmm.traceback_chunk_states_kernel(6, end, s_k, rows, t0, lengths,
                                          states_k)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p.to(torch.int32)), f"K9 state at {t0}"
        assert torch.equal(states_k.int(), states_p.int()), \
            f"K9 states at {t0}"


def check_tchunk_vs_full_scan(gt, model, ev, Tc: int) -> None:
    """The chunked decode through K3's kernels against the full scan
    through K1 + K2 on the card: path0, codes and logp bit-equal."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    chunked = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, Tc)
    full = hmm.viterbi_decode_grouped(gt, model, ev)
    torch.cuda.synchronize()
    for what in ("path0", "codes", "logp"):
        assert torch.equal(chunked[what], full[what]), \
            f"K3 {what} differs from K1 + K2 at Tc={Tc}"


def time_tchunk_kernels(gt, model, ev, Tc: int) -> dict:
    """K3's kernels on one chunk (the second, events [Tc, 2 Tc)) against
    their plain versions on the same carry (tolerance 0: alpha, backpointers,
    the carried state and the ORed codes bit-equal), with both times, and
    the times of the whole chunked decode and of the full scan (K1 + K2):
    ({kernel name: record}, {"full_scan_ms", "chunked_ms"})."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    lengths = ev["length"]
    B = lengths.shape[0]
    zeros = torch.zeros((B, 4096), device=lengths.device)
    carry, _ = hmm.forward_chunk_kernel(gt, model, ev, zeros, 0, Tc)
    alpha, bps = hmm.forward_chunk_kernel(gt, model, ev, carry, Tc, Tc)
    fwd_plain_ms, (alpha_p, bps_p) = cuda_ms_once(
        lambda: hmm.viterbi_forward_grouped_chunk_plain(
            gt, model, chunk_events(ev, Tc, Tc), carry, Tc))
    assert torch.equal(alpha, alpha_p), "K3 alpha differs from plain"
    assert torch.equal(bps, bps_p), "K3 backpointers differ from plain"
    del bps_p
    end = torch.argmax(alpha, dim=-1).to(torch.int32)
    codes, codes_p = (torch.zeros((B, 3 * Tc), dtype=torch.uint8,
                                  device=end.device) for _ in range(2))
    s = hmm.traceback_chunk_kernel(6, end, end.clone(), bps, Tc, lengths,
                                   codes)
    tb_plain_ms, (s_p, c) = cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, end.clone(), bps, Tc, lengths))
    hmm.or_packed_codes(codes_p, c, Tc)
    assert torch.equal(s, s_p), "K3 traceback state differs from plain"
    assert torch.equal(codes, codes_p), "K3 codes differ from plain"
    # K9's traceback chunk on the same rows: states bit-equal to its plain
    # version's and the carried state to K3's
    states = torch.empty((Tc, B), dtype=torch.uint16, device=end.device)
    s9 = hmm.traceback_chunk_states_kernel(6, end, end.clone(), bps, Tc,
                                           lengths, states)
    tb9_plain_ms, (s9_p, states_p) = cuda_ms_once(
        lambda: hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, end.clone(), bps, Tc, lengths, compact=False))
    assert torch.equal(s9, s9_p) and torch.equal(s9, s), \
        "K9 traceback state differs"
    assert torch.equal(states.int(), states_p.int()), \
        "K9 traceback states differ from plain"
    recs = {
        "viterbi_forward_chunk": {
            "max_abs_err": max_err(alpha, alpha_p),
            "ms": cuda_ms(lambda: hmm.forward_chunk_kernel(
                gt, model, ev, carry, Tc, Tc), 3),
            "plain_ms": fwd_plain_ms},
        "viterbi_traceback_chunk": {
            "max_abs_err": max(max_err(s, s_p),
                                max_err(codes.int(), codes_p.int())),
            "ms": cuda_ms(lambda: hmm.traceback_chunk_kernel(
                6, end, end.clone(), bps, Tc, lengths, codes), 3),
            "plain_ms": tb_plain_ms},
        "viterbi_traceback_chunk_states": {
            "max_abs_err": max(max_err(s9, s9_p),
                                max_err(states.int(), states_p.int())),
            "ms": cuda_ms(lambda: hmm.traceback_chunk_states_kernel(
                6, end, end.clone(), bps, Tc, lengths, states), 3),
            "plain_ms": tb9_plain_ms},
    }
    for r in recs.values():
        r["shape"] = [B, Tc]
    del bps
    decode = {
        "full_scan_ms": cuda_ms(lambda: hmm.viterbi_decode_grouped(
            gt, model, ev), 1),
        "chunked_ms": cuda_ms(lambda: hmm.viterbi_decode_grouped_tchunk(
            gt, model, ev, Tc), 1)}
    return recs, decode


def check_seqpar(gt, model, ev, D: int, n_blocks: int, ref: dict,
                 plain: bool, devices=None) -> dict:
    """K9 over D ranks (`devices`; default every rank on the events' card,
    a stream each): with `plain`, path and logp bit-equal to its plain
    version (seqpar.viterbi_decode_seqpar_plain, the same schedule over the
    plain chunk functions; tolerance 0); logp bit-equal to ref's, the decode of
    K1 + K2 or K3 ({"path0", "codes", "logp"}); each read's path up to its
    length equal to the states rebuilt from ref's packed codes
    (native.path_from_packed_codes), and past it the end state.  Returns
    {"ms", "plain_ms"}: K9's time (after a warm-up) and, with `plain`, its
    plain version's on the same inputs (CUDA events)."""
    import torch

    from nanocall_tpu_torch import native
    from nanocall_tpu_torch.parallel import seqpar

    devices = devices or [ev["mean"].device] * D
    out = seqpar.viterbi_decode_seqpar(gt, model, ev, devices, n_blocks)
    torch.cuda.synchronize()
    what = f"K9 (D={D}, n_blocks={n_blocks})"
    times = {"ms": None, "plain_ms": None}
    if plain:
        times["plain_ms"], want = cuda_ms_once(
            lambda: seqpar.viterbi_decode_seqpar_plain(gt, model, ev,
                                                       devices, n_blocks))
        times["ms"] = cuda_ms(lambda: seqpar.viterbi_decode_seqpar(
            gt, model, ev, devices, n_blocks), 3)
        assert torch.equal(out["path"].int(), want["path"].int()), \
            f"{what} path differs from plain"
        assert torch.equal(out["logp"], want["logp"]), \
            f"{what} logp differs from plain"
    assert torch.equal(out["logp"], ref["logp"]), f"{what} logp differs"
    path = out["path"].cpu().numpy().astype("int32")
    path0, codes = ref["path0"].cpu().numpy(), ref["codes"].cpu().numpy()
    for b, L in enumerate(ev["length"].tolist()):
        if L:
            want_b = native.path_from_packed_codes(int(path0[b]), codes[b],
                                                   L, 6)
            assert (path[b, :L] == want_b).all(), f"{what} path of read {b}"
        end = path[b, L - 1] if L else path[b, -1]
        assert (path[b, max(L, 1) - 1:] == end).all(), \
            f"{what} path past the length of read {b}"
    return times


def run_seqpar(gt, model, ev, card: str) -> dict:
    """K9 at long-read width, B_LONG x T_LONG over D_LONG ranks, n_blocks 1
    and D_LONG, against K3's chunked decode (check_seqpar), with its time
    beside K3's and its peak memory; then one decode (n_blocks D_LONG)
    counted as the K9 path: {"launches", "ms", "k3_ms", "peak_gib"}."""
    import torch

    from nanocall_tpu_torch import roofline
    from nanocall_tpu_torch.ops import hmm, kernels
    from nanocall_tpu_torch.parallel import seqpar

    k3 = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, TC_LONG)
    for M in (1, D_LONG):
        check_seqpar(gt, model, ev, D_LONG, M, k3, plain=False)
    del k3
    devices = [ev["mean"].device] * D_LONG
    k3_ms = cuda_ms(lambda: hmm.viterbi_decode_grouped_tchunk(
        gt, model, ev, TC_LONG), 1)
    times = {M: cuda_ms(lambda M=M: seqpar.viterbi_decode_seqpar(
        gt, model, ev, devices, M), 1) for M in (1, D_LONG)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    seqpar.viterbi_decode_seqpar(gt, model, ev, devices, D_LONG)
    torch.cuda.synchronize()
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in SEQPAR_KERNELS:
        assert launches[k] == D_LONG * D_LONG, (k, launches[k])
    bound = roofline.seqpar_bound(B_LONG, T_LONG)
    print(f"K9 (viterbi_decode_seqpar): B={B_LONG} T={T_LONG} over "
          f"{D_LONG} ranks on one card: logp bit-equal to K3's, paths to "
          f"K3's codes, for n_blocks 1 and {D_LONG}; "
          f"{times[1]:.3f} ms (n_blocks 1), {times[D_LONG]:.3f} ms "
          f"(n_blocks {D_LONG}) vs K3's chunked decode {k3_ms:.3f} ms; "
          f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}); peak "
          f"device memory {peak:.3f} GiB; launches "
          f"{ {k: launches[k] for k in SEQPAR_KERNELS} } [{card}]")
    return {"launches": launches, "ms": times[D_LONG], "k3_ms": k3_ms,
            "peak_gib": peak, "bound": bound}


def check_statepar(gt, model, ev) -> dict:
    """K1m and K2m at the kernel phase's shape: the state-parallel decode
    over MESH_RANKS ranks on the events' card, path and score-only, on the
    clean inputs and on nan_inputs', bit-equal (as bits) to K1 + K2 and,
    with backpointers at 2 ranks, to its plain version
    (statepar.viterbi_decode_statepar_plain, the same schedule over the
    plain K1m and K2m); then, at 2 ranks on nan_inputs', one K1m launch
    (the wave of all B reads, both ranks) against its plain version on the
    same ranks (every rank's column buffer, both parities, and its
    backpointers as bits), and K2m on that wave's final slices and
    backpointer slices against its plain version and against K2's ring on
    the same rows whole (tolerance 0).  Returns the two kernels' records:
    K1m's "ms" is a launch's device time (launch_spans: CUDA events around
    each of 5 launches, its counters zeroed before each), with the host's
    enqueue a launch beside it; K2m's "k2_ms" is K2's time on the same
    rows.  Prints how many of 5 K1m launches torch.profiler records, and
    their device time (profiled_launches)."""
    import torch

    from nanocall_tpu_torch.ops import hmm
    from nanocall_tpu_torch.parallel import statepar

    dev = ev["mean"].device
    for what, (g, m, e) in (("clean", (gt, model, ev)),
                            ("NaN", nan_inputs(gt, model, ev))):
        for with_path in (True, False):
            ref = hmm.viterbi_decode_grouped(g, m, e, with_path=with_path)
            for M in MESH_RANKS:
                rows = [statepar.split_states(g, m, e, [dev] * M)]
                [got] = statepar.viterbi_decode_statepar(rows, with_path)
                # the plain schedule (slow: ~10 s at 2 ranks) with
                # backpointers at 2 ranks; score-only it is the same
                # forward without them
                [want] = (statepar.viterbi_decode_statepar_plain(rows)
                          if with_path and M == 2 else [ref])
                torch.cuda.synchronize()
                for k in ref:
                    tag = f"K1m + K2m {what} M={M} {k}"
                    assert torch.equal(bits(got[k]), bits(want[k])), \
                        f"{tag} differs from plain"
                    assert torch.equal(bits(got[k]), bits(ref[k])), \
                        f"{tag} differs from K1 + K2"

    # the single kernels at 2 ranks on the NaN inputs
    g, m, e = nan_inputs(gt, model, ev)
    B, T = e["mean"].shape
    ranks = [statepar._wave_rank(p, True)
             for p in statepar.split_states(g, m, e, [dev] * 2)]
    plain = [r._replace(col=r.col.clone(), bps=r.bps.clone()) for r in ranks]

    def k1m():
        for r in ranks:
            r.flags.zero_()
        hmm.forward_wave_kernel(ranks, [0, 1], 0, B)

    k1m()
    plain_ms, _ = cuda_ms_once(
        lambda: hmm.viterbi_forward_wave_plain(plain, 0, B))
    torch.cuda.synchronize()
    for rk, rp in zip(ranks, plain):
        assert torch.equal(bits(rk.col), bits(rp.col)), \
            "K1m column slices differ from plain"
        assert torch.equal(rk.bps, rp.bps), "K1m bps differ from plain"
    k1m_spans = launch_spans(k1m, "forward_wave_kernel", dev, 5)
    print(f"torch.profiler over 5 K1m launches: "
          f"{profiled_launches(k1m, 'viterbi_forward_wave_kernel', 5)} "
          f"(events, device ms) recorded [{smi_line()}]")
    final = [r.col[(T - 1) % 2] for r in ranks]
    slices = [r.bps for r in ranks]
    lengths = e["length"]
    tb_k = hmm.traceback_slices_kernel(6, final, slices, lengths)
    tb_plain_ms, tb_p = cuda_ms_once(
        lambda: hmm.viterbi_traceback_slices_plain(6, final, slices, lengths))
    fa, bps = hmm.gather_column(final), torch.cat(slices, dim=2)
    tb_2 = hmm.traceback_kernel(6, fa, bps, lengths)
    torch.cuda.synchronize()
    for what, a, b, c in zip(("path0", "codes", "logp"), tb_k, tb_p, tb_2):
        assert torch.equal(bits(a), bits(b)), f"K2m {what} differs from plain"
        assert torch.equal(bits(a), bits(c)), f"K2m {what} differs from K2"
    return {
        "viterbi_forward_slice": {
            "max_abs_err": max(max_err(rk.col, rp.col)
                               for rk, rp in zip(ranks, plain)),
            "ms": 1e3 * k1m_spans["device_s"] / 5,
            "host_us": 1e6 * k1m_spans["host_s"] / 5, "plain_ms": plain_ms,
            "shape": [B, T], "ranks": 2},
        "viterbi_traceback_slices": {
            "max_abs_err": max_err(tb_k[2], tb_p[2]),
            "ms": cuda_ms(lambda: hmm.traceback_slices_kernel(
                6, final, slices, lengths), 3),
            "k2_ms": cuda_ms(lambda: hmm.traceback_kernel(
                6, fa, bps, lengths), 3),
            "plain_ms": tb_plain_ms, "shape": [B, T], "ranks": 2}}


#: cycles torch.cuda._sleep holds a stream before a timed launch (about
#: 1 ms at the H100's 1.98 GHz): the launch is enqueued before it ends, so
#: the host's enqueue does not fall between the launch's events
HOLD_CYCLES = 2_000_000


def launch_spans(fn, name: str, device, reps: int = 1, module=None) -> dict:
    """The launches of kernel wrapper hmm.<name> (or module.<name>) in
    `reps` calls of `fn`,
    each timed alone by CUDA events recorded on `device`'s current stream
    just before and after it, the stream held busy first (HOLD_CYCLES), so
    that the span is the device's time for the launch and not the host's
    enqueue: {"device_s" (summed), "host_s" (the wrapper calls' host
    clock, summed), "launches"}.  The wrapper is swapped for the calls
    (its own counter is left as it was)."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    module = hmm if module is None else module
    orig = getattr(module, name)
    spans, host = [], []

    def timed(*args, **kw):
        stream = torch.cuda.current_stream(device)
        with torch.cuda.device(device):
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        host.append(time.perf_counter() - t0)
        stop.record(stream)
        spans.append((start, stop))
        return out

    timed.launches = 0
    torch.cuda.synchronize()
    setattr(module, name, timed)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
    return {"device_s": sum(a.elapsed_time(b) for a, b in spans) / 1e3,
            "host_s": sum(host), "launches": len(spans)}


def profiled_launches(fn, marker: str, reps: int) -> tuple:
    """(events, device ms) that torch.profiler records for the kernels
    whose name contains `marker` over `reps` calls of `fn`: K1m's
    cooperative launches are checked against their count by it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and marker in e.key]
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3)


def pooled_inputs(models, device, B: int, T: int, rng) -> tuple:
    """basecall.decode_chunk_pooled's arguments for a path chunk of B tasks
    of T events on `device`: the chunk's own rows as its event pool,
    kernel_inputs' models, scaling, transitions, lengths and events."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import convert

    names = ("r73.t.006", "r73.c.p1.006")
    pm = np.zeros((B, 6), np.float32)
    pm[:, 0] = rng.uniform(0.9, 1.1, B)
    pm[:, 1] = rng.uniform(-3.0, 3.0, B)
    pm[:, 3:] = rng.uniform(0.9, 1.1, (B, 3))
    stp = np.stack([rng.uniform(0.05, 0.2, B),
                    rng.uniform(0.2, 0.4, B)], 1).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[:4] = [T, 0, 1, T - 1]
    model_idx = np.arange(B, dtype=np.int32) % 2
    lm = np.stack([models[n].level_mean for n in names])[model_idx]
    states = rng.integers(0, 4096, (B, T))
    mean = (lm[np.arange(B)[:, None], states] * pm[:, :1] + pm[:, 1:2]
            + rng.normal(0.0, 1.0, (B, T))).astype(np.float32)
    stdv = rng.uniform(0.5, 2.0, (B, T)).astype(np.float32)
    start = np.cumsum(rng.uniform(0.01, 0.05, (B, T)), 1).astype(np.float32)
    for b, L in enumerate(lengths):
        mean[b, L:], stdv[b, L:], start[b, L:] = 1.0, 1.0, 0.0
    return (convert.tensor(mean, device), convert.tensor(stdv, device),
            convert.tensor(start, device),
            torch.arange(B, device=device),
            convert.tensor(rng.uniform(-0.01, 0.01, B).astype(np.float32),
                           device),
            convert.model_bank(models, names, device),
            convert.tensor(model_idx, device, torch.int32),
            convert.tensor(pm, device), convert.tensor(stp, device),
            convert.tensor(lengths, device, torch.int32))


def run_mesh(models, device, card: str, rng) -> dict:
    """The mesh path at the path chunk, B_MESH x T_MESH: the unplaced
    decode (K1 + K2) and, on each (data, model) mesh of MESH_SHAPES with
    every rank on `device`, basecall.decode_chunk_pooled on the arguments
    placed by mesh.shard_pooled_decode_inputs, path then score-only, each
    pair of decodes counted as the mesh path (every kernel count set to 0
    just before, read just after): one K1m launch a wave and data row
    (statepar.plan_waves on the card's resident blocks) and one K2m a data
    row.  path0, codes and logp bit-equal to the unplaced decode's.  Each
    decode's wall, host enqueue and device time (CUDA events), K1m's and
    K2m's device time (launch_spans: CUDA events around each launch of one
    more path decode each) and peak
    memory beside K1 + K2's; then K2m against K2's ring on the rows of the
    unplaced decode split over K2M_RANKS ranks, in turns (K2, K2m, K2m,
    K2), as drawn and at full lengths.  Returns {"launches" (summed over the
    meshes), "meshes": {(D, M): record}, "k1k2": record, "walks": {M:
    record}}."""
    import torch

    from nanocall_tpu_torch import basecall, roofline
    from nanocall_tpu_torch.ops import hmm, kernels
    from nanocall_tpu_torch.parallel import mesh, statepar

    args = pooled_inputs(models, device, B_MESH, T_MESH, rng)

    def timed(fn):
        """(result, wall s, host enqueue s, device s, peak bytes) of one
        call, from a synchronized card."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        stop.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (out, wall, enqueue, start.elapsed_time(stop) / 1e3,
                torch.cuda.max_memory_allocated() - base)

    [ref] = basecall.decode_chunk_pooled(*args)
    [ref_s] = basecall.decode_chunk_pooled(*args, with_path=False)
    _, wall, enqueue, dev_s, peak = timed(
        lambda: basecall.decode_chunk_pooled(*args))
    k1k2 = {"wall_s": wall, "enqueue_s": enqueue, "device_s": dev_s,
            "peak_gib": peak / 2**30}
    print(f"K1 + K2 (unplaced) at B={B_MESH} T={T_MESH}: {wall:.4f} s of "
          f"wall, {enqueue:.4f} s host enqueue, {dev_s:.4f} s device, peak "
          f"{peak / 2**30:.3f} GiB [{card}]")
    lengths = args[-1].cpu().numpy()
    total = {k.name: 0 for k in kernels.KERNELS}
    meshes = {}
    for D, M in MESH_SHAPES:
        grid = mesh.make_mesh(D * M, model_axis=M, devices=[device] * (D * M))
        placed = mesh.shard_pooled_decode_inputs(grid, *args)
        b = B_MESH // D
        waves = {w: len(statepar.plan_waves(b, [device] * M, {
            device: hmm.forward_wave_resident(device, w)})[device])
            for w in (True, False)}
        kernels.reset_launches()
        out, wall, enqueue, dev_s, peak = timed(
            lambda: basecall.decode_chunk_pooled(*placed))
        out_s, wall_s, enqueue_s, dev_s_s, _ = timed(
            lambda: basecall.decode_chunk_pooled(*placed, with_path=False))
        launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
        assert launches["viterbi_forward_slice"] == \
            D * (waves[True] + waves[False]), (launches, waves)
        assert launches["viterbi_traceback_slices"] == D, launches
        assert len(out) == D and all(o["codes"].device == device
                                     for o in out)
        got, got_s = mesh.join(out), mesh.join(out_s)
        for k in ("path0", "codes", "logp"):
            assert torch.equal(bits(got[k]), bits(ref[k].cpu())), \
                f"mesh {(D, M)} {k} differs from K1 + K2"
        assert torch.equal(bits(got_s["logp"]), bits(ref_s["logp"].cpu())), \
            f"mesh {(D, M)} score-only logp differs"
        for k, v in launches.items():
            total[k] += v
        del out, out_s, got, got_s
        k1m_t = launch_spans(lambda: basecall.decode_chunk_pooled(*placed),
                             "forward_wave_kernel", device)
        k2m_t = launch_spans(lambda: basecall.decode_chunk_pooled(*placed),
                             "traceback_slices_kernel", device)
        assert (k1m_t["launches"], k2m_t["launches"]) == \
            (D * waves[True], D), (k1m_t, k2m_t)
        k1m_us, k2m_us = 1e6 * k1m_t["device_s"], 1e6 * k2m_t["device_s"]
        ex = roofline.statepar_exchange_bytes(b, T_MESH, M)
        walk = sum(roofline.statepar_exchange_bytes(
            b, T_MESH, M, roofline.walk_rows(
                lengths[d * b:(d + 1) * b], T_MESH))["walk"]
            for d in range(D))
        bound = (D * roofline.kernel_bound("viterbi_forward_slice", b,
                                           T_MESH)["bound_ms"]
                 + D * roofline.kernel_bound("viterbi_traceback_slices", b,
                                             T_MESH)["bound_ms"])
        rec = {"wall_s": wall, "enqueue_s": enqueue, "device_s": dev_s,
               "score_wall_s": wall_s, "score_enqueue_s": enqueue_s,
               "score_device_s": dev_s_s, "k1m_device_s": k1m_us / 1e6,
               "k2m_device_s": k2m_us / 1e6, "peak_gib": peak / 2**30,
               "waves_a_row": waves, "k1m_launches_a_decode": D * waves[True],
               "bound_ms": bound,
               "bp_slice_bytes": b * (T_MESH - 1) * (4096 // M),
               "column_exchange_bytes": D * ex["column"],
               "walk_peer_bytes": walk}
        meshes[(D, M)] = rec
        print(f"mesh {(D, M)} (data, model) on one card: B={B_MESH} "
              f"T={T_MESH}, path0, codes and logp (and score-only logp) "
              f"bit-equal to K1 + K2; path decode {wall:.4f} s of wall "
              f"({enqueue:.4f} s host enqueue, {dev_s:.4f} s device; K1m "
              f"{k1m_us / 1e6:.4f} s in {D * waves[True]} launches, K2m "
              f"{k2m_us / 1e3:.3f} ms in {D}) vs K1 + K2 {k1k2['wall_s']:.4f} "
              f"s; score-only {wall_s:.4f} s ({enqueue_s:.4f} s enqueue, "
              f"{dev_s_s:.4f} s device); bound {bound:.3f} ms (K1m + K2m, "
              f"roofline.kernel_bound); peak device memory "
              f"{rec['peak_gib']:.3f} GiB vs K1 + K2 {k1k2['peak_gib']:.3f}; "
              f"backpointer slice {rec['bp_slice_bytes'] / 2**30:.3f} GiB a "
              f"rank; peers' column slices read {ex['column'] * D / 1e9:.3f} "
              f"GB, the walks' copies from peers' slices {walk / 1e9:.3f} GB;"
              f" waves a row {waves}; launches "
              f"{ {k: launches[k] for k in MESH_KERNELS} } [{card}]")
    walks = {}
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    fa, bps = hmm.viterbi_forward_grouped(gt, model, ev)
    del model, ev, gt
    full = torch.full_like(args[-1], T_MESH)
    for M in K2M_RANKS:
        W = 4096 // M
        column = [fa[:, m * W:(m + 1) * W].contiguous() for m in range(M)]
        slices = [bps[..., m * W:(m + 1) * W].contiguous() for m in range(M)]
        rec = {}
        for what, ln in (("drawn", args[-1]), ("full", full)):
            got = hmm.traceback_slices_kernel(6, column, slices, ln)
            want = hmm.traceback_kernel(6, fa, bps, ln)
            torch.cuda.synchronize()
            for k, a, c in zip(("path0", "codes", "logp"), got, want):
                assert torch.equal(bits(a), bits(c)), \
                    f"K2m {k} differs from K2 at {M} ranks, {what} lengths"
            calls = {"K2": lambda ln=ln: hmm.traceback_kernel(6, fa, bps, ln),
                     "K2m": lambda ln=ln: hmm.traceback_slices_kernel(
                         6, column, slices, ln)}
            turns = {"K2": [], "K2m": []}
            for who in ("K2", "K2m", "K2m", "K2"):
                turns[who].append(cuda_ms(calls[who], 5))
            rec[what] = turns
        walks[M] = rec
        bound = roofline.kernel_bound("viterbi_traceback_slices", B_MESH,
                                      T_MESH)["bound_ms"]
        print(f"K2m vs K2's ring at B={B_MESH} T={T_MESH} over {M} ranks, "
              f"bit-equal, ms in turns (K2, K2m, K2m, K2): as drawn "
              f"{rec['drawn']}, full lengths {rec['full']}; K2m bound "
              f"{bound:.4f} ms [{card}]")
        del column, slices
    del fa, bps
    return {"launches": total, "meshes": meshes, "k1k2": k1k2,
            "walks": walks}


def per_read_ops(device, B: int, rng):
    """Per-read structured tables of B reads at kinetics drawn around the
    CLI priors (transitions.build_structured_batch,
    convert.trans_ops_batch): every read's table packs, so K6a and K6am
    take their resident forms."""
    import numpy as np

    from nanocall_tpu_torch import convert, transitions
    from nanocall_tpu_torch.ops import hmm

    params = np.stack([rng.uniform(0.05, 0.2, B),
                       rng.uniform(0.2, 0.4, B)], 1)
    ops = convert.trans_ops_batch(
        *transitions.build_structured_batch(params, 6), 6, device)
    assert hmm.per_read(ops) and hmm.generic_forward_route(ops) == "resident"
    return ops


def check_generic_statepar(trans_ops, priors_ops, gt, model, ev) -> dict:
    """K6am, K6bm and the per-read K6a at the kernel phase's shape, on
    nan_inputs' model and events (NaN events in read 4 from event 700 on,
    a NaN model entry in read 6): one K6am launch (the wave of all B reads,
    2 ranks on the events' card) in its resident form under the loaded
    table and in its streaming form under the priors' table, each against
    its plain version on the same ranks (every rank's column buffer, both
    parities, and its backpointers as bits) and timed by launch_spans (5
    launches, counters zeroed before each); K6bm on the resident run's
    final slices and backpointer slices, with the from-state table and
    with from_idx (the rule of tables wider than 24 slots), against its
    plain version and against K6b's ring on the same rows whole; and K6a
    under per-read tables (resident and streaming, path and score-only)
    against its plain version.  Returns the records of K6am's two forms and
    K6bm; prints the per-read K6a's times."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm
    from nanocall_tpu_torch.parallel import statepar

    _, m, e = nan_inputs(gt, model, ev)
    dev = e["mean"].device
    B, T = e["mean"].shape
    lengths = e["length"]
    recs, walk = {}, None
    for name, ops, form in (
            ("viterbi_generic_wave_resident", trans_ops, "resident"),
            ("viterbi_generic_wave_streaming", priors_ops, "streaming")):
        assert hmm.generic_forward_route(ops) == form, name
        row = statepar.split_table_states(ops, m, e, [dev] * 2)
        ranks = [statepar._generic_wave_rank(p, True) for p in row.parts]
        plain = [r._replace(col=r.col.clone(), bps=r.bps.clone())
                 for r in ranks]
        wrapper = f"generic_wave_{form}_kernel"

        def k6am(ranks=ranks, wrapper=wrapper):
            for r in ranks:
                r.flags.zero_()
            getattr(hmm, wrapper)(ranks, [0, 1], 0, B)

        k6am()
        plain_ms, _ = cuda_ms_once(
            lambda: hmm.viterbi_forward_generic_wave_plain(plain, 0, B))
        torch.cuda.synchronize()
        for rk, rp in zip(ranks, plain):
            assert torch.equal(bits(rk.col), bits(rp.col)), \
                f"K6am ({form}) column slices differ from plain"
            assert torch.equal(rk.bps, rp.bps), \
                f"K6am ({form}) bps differ from plain"
        spans = launch_spans(k6am, wrapper, dev, 5)
        recs[name] = {
            "max_abs_err": max(max_err(rk.col, rp.col)
                               for rk, rp in zip(ranks, plain)),
            "ms": 1e3 * spans["device_s"] / 5,
            "host_us": 1e6 * spans["host_s"] / 5, "plain_ms": plain_ms,
            "shape": [B, T], "ranks": 2}
        if form == "resident":
            walk = (row.walk, [r.col[(T - 1) % 2] for r in ranks],
                    [r.bps for r in ranks])
        del ranks, plain
    table, final, slices = walk
    fa, bps = hmm.gather_column(final), torch.cat(slices, dim=2)
    ring = hmm.generic_traceback_ring_kernel(trans_ops, fa, bps, lengths)
    tb_plain_ms, tb_p = cuda_ms_once(
        lambda: hmm.viterbi_traceback_generic_slices_plain(
            table, final, slices, lengths))
    for rule, t in (("from-state table", table),
                    ("from_idx", table._replace(from_states=None))):
        tb_k = hmm.generic_traceback_slices_kernel(t, final, slices, lengths)
        torch.cuda.synchronize()
        for what, a, b, c in zip(("path", "logp"), tb_k, tb_p, ring):
            assert torch.equal(bits(a), bits(b)), \
                f"K6bm ({rule}) {what} differs from plain"
            assert torch.equal(bits(a), bits(c)), \
                f"K6bm ({rule}) {what} differs from K6b's ring"
    assert torch.isnan(tb_p[1]).any(), "the NaN inputs gave no NaN logp"
    recs["viterbi_generic_traceback_slices"] = {
        "max_abs_err": max_err(tb_k[1], tb_p[1]),
        "ms": cuda_ms(lambda: hmm.generic_traceback_slices_kernel(
            table, final, slices, lengths), 3),
        "idx_rule_ms": cuda_ms(lambda: hmm.generic_traceback_slices_kernel(
            table._replace(from_states=None), final, slices, lengths), 3),
        "k6b_ring_ms": cuda_ms(lambda: hmm.generic_traceback_ring_kernel(
            trans_ops, fa, bps, lengths), 3),
        "plain_ms": tb_plain_ms, "shape": [B, T], "ranks": 2}
    del walk, final, slices, fa, bps
    # K6a under per-read tables: its resident and streaming kernels
    ops = per_read_ops(dev, B, np.random.default_rng(2027))
    per_read = {}
    for form, o in (("resident", ops),
                    ("streaming", ops._replace(from_packed=None,
                                               from_codebook=None))):
        for with_path in (True, False):
            p_ms, want = cuda_ms_once(lambda: hmm.viterbi_forward_plain(
                o, m, e, with_path))
            got = hmm.viterbi_forward(o, m, e, with_path)
            torch.cuda.synchronize()
            assert torch.equal(bits(got[0]), bits(want[0])), \
                f"per-read K6a ({form}) final alpha differs from plain"
            if with_path:
                assert torch.equal(got[1], want[1]), \
                    f"per-read K6a ({form}) bps differ from plain"
            per_read[(form, with_path)] = {
                "ms": cuda_ms(lambda: hmm.viterbi_forward(o, m, e,
                                                          with_path), 3),
                "plain_ms": p_ms}
    recs["per_read_k6a"] = per_read
    return recs


def run_generic_mesh(models, device, card: str, rng, trans_ops,
                     priors_ops) -> dict:
    """The generic mesh path at the path chunk, B_MESH x T_MESH: under the
    loaded table (K6am resident), the priors' loaded table (streaming) and
    per-read tables of the chunk's reads (resident, per read), the unplaced
    decode (K6a + K6b) and, on each (data, model) mesh of MESH_SHAPES with
    every rank on `device`, statepar.viterbi_decode_placed on
    mesh.shard_decode_inputs' placement, path then score-only, each pair
    counted as the mesh path (every kernel count set to 0 just before,
    read just after): one K6am launch a wave and data row
    (statepar.plan_waves on K6am's own resident blocks) and one K6bm a data
    row; path and logp (and the score-only logp) bit-equal to the
    unplaced decode's.  Each decode's wall and device time, K6am's and
    K6bm's device time (launch_spans around each launch of one more path
    decode each).  Returns {"launches" (summed), "cells": {(table, D, M):
    record}, "k6": {table: record}}."""
    import torch

    from nanocall_tpu_torch import basecall, roofline
    from nanocall_tpu_torch.ops import hmm, kernels
    from nanocall_tpu_torch.parallel import mesh, statepar

    args = pooled_inputs(models, device, B_MESH, T_MESH, rng)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    del args
    tables = {"loaded (0.14, 0.21)": trans_ops,
              "priors' loaded (0.1, 0.3)": priors_ops,
              "per-read": per_read_ops(device, B_MESH, rng)}

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                start.elapsed_time(stop) / 1e3)

    total = {k.name: 0 for k in kernels.KERNELS}
    cells, k6 = {}, {}
    for tname, ops in tables.items():
        form = hmm.generic_forward_route(ops)
        wrapper = f"generic_wave_{form}_kernel"
        ref, wall, dev_s = timed(lambda: hmm.viterbi_decode(ops, model, ev))
        ref_s = hmm.viterbi_decode(ops, model, ev, with_path=False)
        k6[tname] = {"wall_s": wall, "device_s": dev_s, "form": form}
        deg = (ops.from_packed if form == "resident"
               else ops.from_idx).shape[-2]
        for D, M in MESH_SHAPES:
            grid = mesh.make_mesh(D * M, model_axis=M,
                                  devices=[device] * (D * M))
            placed = mesh.shard_decode_inputs(grid, ops, model, ev)
            b, W = B_MESH // D, 4096 // M
            waves = {w: len(statepar.plan_waves(b, [device] * M, {
                device: hmm.generic_wave_resident(
                    device, w, False, form == "resident", deg, W)})[device])
                for w in (True, False)}
            kernels.reset_launches()
            out, wall, dev_s = timed(
                lambda: statepar.viterbi_decode_placed(*placed))
            out_s, wall_s, dev_s_s = timed(
                lambda: statepar.viterbi_decode_placed(*placed,
                                                       with_path=False))
            launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
            assert launches[f"viterbi_generic_wave_{form}"] == \
                D * (waves[True] + waves[False]), (launches, waves)
            assert launches["viterbi_generic_traceback_slices"] == D, \
                launches
            assert sum(launches.values()) == \
                D * (waves[True] + waves[False] + 1), launches
            got, got_s = mesh.join(out), mesh.join(out_s)
            for k in ("path", "logp"):
                assert torch.equal(bits(got[k]), bits(ref[k].cpu())), \
                    f"generic mesh {tname} {(D, M)} {k} differs from K6a + K6b"
            assert torch.equal(bits(got_s["logp"]),
                               bits(ref_s["logp"].cpu())), \
                f"generic mesh {tname} {(D, M)} score-only logp differs"
            for k, v in launches.items():
                total[k] += v
            del out, out_s, got, got_s
            k6am_t = launch_spans(
                lambda: statepar.viterbi_decode_placed(*placed), wrapper,
                device)
            k6bm_t = launch_spans(
                lambda: statepar.viterbi_decode_placed(*placed),
                "generic_traceback_slices_kernel", device)
            assert (k6am_t["launches"], k6bm_t["launches"]) == \
                (D * waves[True], D), (k6am_t, k6bm_t)
            ex = roofline.statepar_exchange_bytes(b, T_MESH, M)
            rec = {"wall_s": wall, "device_s": dev_s,
                   "score_wall_s": wall_s, "score_device_s": dev_s_s,
                   "k6am_device_s": k6am_t["device_s"],
                   "k6bm_device_s": k6bm_t["device_s"],
                   "waves_a_row": waves, "form": form,
                   "column_exchange_bytes": D * ex["column"]}
            cells[(tname, D, M)] = rec
            print(f"generic mesh {(D, M)} under the {tname} table ({form} "
                  f"K6am): B={B_MESH} T={T_MESH}, path and logp (and "
                  f"score-only logp) bit-equal to K6a + K6b; path decode "
                  f"{wall:.4f} s of wall, {dev_s:.4f} s device (K6am "
                  f"{k6am_t['device_s']:.4f} s in {D * waves[True]} "
                  f"launches, K6bm {1e3 * k6bm_t['device_s']:.3f} ms in {D})"
                  f" vs K6a + K6b {k6[tname]['device_s']:.4f} s device; "
                  f"score-only {dev_s_s:.4f} s device; peers' column slices "
                  f"read {D * ex['column'] / 1e9:.3f} GB; waves a row "
                  f"{waves} [{card}]")
            del placed
        del ref, ref_s
    return {"launches": total, "cells": cells, "k6": k6}


def load_trans_table(device, p_stay: float = TRANS_P_STAY,
                     p_skip: float = TRANS_P_SKIP, name: str = "trans.tsv"):
    """The 21-neighbour table of (p_stay, p_skip), written as a transitions
    TSV build/chip_smoke/<name> and loaded back by the port CLI's `-s`
    loader: (the TSV path, the loaded table, its TransOps on `device`).
    K6c takes its resident kernel under the table of (TRANS_P_STAY,
    TRANS_P_SKIP) and of the priors; K6a its resident kernel under the
    former and its streaming one under the priors'."""
    from nanocall_tpu_torch import cli, convert
    from nanocall_tpu_torch.ops import hmm

    path = os.path.join(ROOT, "build", "chip_smoke", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    convert.write_fast_transitions(path, p_stay, p_skip)
    table = cli.init_transitions(smoke_config("-s", path))
    ops = convert.trans_ops(table, device)
    assert tuple(ops.from_idx.shape) == (21, 4096), ops.from_idx.shape
    priors = (p_stay, p_skip) == (PRIORS_P_STAY, PRIORS_P_SKIP)
    assert hmm.generic_forward_route(ops) == (
        "streaming" if priors else "resident")
    assert hmm.fwbw_route(ops) == "resident"
    return path, table, ops


#: K6a's kernels by name: (wrapper, with backpointers)
K6A = {"viterbi_generic_forward_path": ("generic_forward_path_kernel", True),
       "viterbi_resident_forward_path": ("resident_forward_path_kernel", True),
       "viterbi_generic_forward_score": ("generic_forward_score_kernel",
                                         False),
       "viterbi_resident_forward_score": ("resident_forward_score_kernel",
                                          False)}


def k6a_call(name: str, ops, model, ev):
    """(final_alpha, bps or None) of K6a's kernel `name`."""
    from nanocall_tpu_torch.ops import hmm

    wrapper, path = K6A[name]
    out = getattr(hmm, wrapper)(ops, model, ev)
    return out if path else (out, None)


def time_in_turns(calls: dict, reps: int = 3, sample=None) -> dict:
    """Functions of no argument timed in turns: each in order, then each
    in reverse (for two: a, b, b, a), cuda_ms over reps calls a turn.
    With `sample` (a function of no argument), its value is recorded
    beside every time.  Returns {name: {"ms": the mean of its turns,
    "ms_turns", "samples" (with `sample`)}}."""
    out = {}
    for name in (*calls, *reversed(list(calls))):
        ms = cuda_ms(calls[name], reps)
        r = out.setdefault(name, {"ms_turns": []})
        r["ms_turns"].append(ms)
        if sample:
            r.setdefault("samples", []).append(sample())
    for r in out.values():
        r["ms"] = sum(r["ms_turns"]) / len(r["ms_turns"])
    return out


def time_k6a_in_turns(ops, model, ev, reps: int = 3,
                      sample=None) -> dict:
    """K6a's streaming and resident kernels timed in turns under one table
    (time_in_turns), path and score-only each: streaming, resident,
    resident, streaming.  Returns {kernel name: {"ms", "ms_turns",
    "samples"}}."""
    out = {}
    for kind in ("path", "score"):
        out.update(time_in_turns(
            {name: (lambda name=name: k6a_call(name, ops, model, ev))
             for name in (f"viterbi_generic_forward_{kind}",
                          f"viterbi_resident_forward_{kind}")},
            reps, sample))
    return out


#: K6b's kernels by name: the streaming one and the ring
K6B = {"viterbi_generic_traceback": "generic_traceback_kernel",
       "viterbi_generic_traceback_ring": "generic_traceback_ring_kernel"}


def check_generic_kernels(ops, model, ev, sample=None) -> dict:
    """K6a's two kernels (streaming and resident, path and score-only) and
    K6b's two (streaming and the ring, which the table takes) against their
    plain versions on the same card under the loaded table: bit-equal
    outputs (tolerance 0); K6a's kernels timed in turns (time_k6a_in_turns,
    with `sample`), K6b's too (streaming, ring, ring, streaming).  Returns
    {kernel name: record}."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    lengths = ev["length"]
    path_ms, (fa_p, bps_p) = cuda_ms_once(lambda: hmm.viterbi_forward_plain(
        ops, model, ev, True))
    plain_ms = {True: path_ms, False: cuda_ms(
        lambda: hmm.viterbi_forward_plain(ops, model, ev, False), 1)}
    outs = {name: k6a_call(name, ops, model, ev) for name in K6A}
    torch.cuda.synchronize()
    recs = {}
    for name, (fa, bps) in outs.items():
        assert torch.equal(fa, fa_p), f"{name} final alpha differs from plain"
        if bps is not None:
            assert torch.equal(bps, bps_p), f"{name} backpointers differ"
        recs[name] = {"max_abs_err": max_err(fa, fa_p),
                      "plain_ms": plain_ms[K6A[name][1]]}
    fa_k, bps_k = outs["viterbi_generic_forward_path"]
    del outs
    assert hmm.generic_traceback_route(ops) == "ring"
    k6b_plain_ms, (path_p, logp_p) = cuda_ms_once(
        lambda: hmm.viterbi_traceback_plain(ops, fa_p, bps_p, lengths))
    for name, wrapper in K6B.items():
        path_k, logp_k = getattr(hmm, wrapper)(ops, fa_k, bps_k, lengths)
        torch.cuda.synchronize()
        assert torch.equal(path_k, path_p), f"{name} path differs from plain"
        assert torch.equal(bits(logp_k), bits(logp_p)), \
            f"{name} logp differs from plain"
        recs[name] = {"max_abs_err": max_err(logp_k, logp_p),
                      "plain_ms": k6b_plain_ms}
    for name, r in time_k6a_in_turns(ops, model, ev, sample=sample).items():
        recs[name].update(r)
    for name, r in time_in_turns(
            {name: (lambda w=wrapper: getattr(hmm, w)(ops, fa_k, bps_k,
                                                      lengths))
             for name, wrapper in K6B.items()}).items():
        recs[name].update(r)
    return with_shape(recs, ev)


def random_resident_table(device, seed: int = 5):
    """A TransOps of RANDOM_DEG slots, RANDOM_VALUES distinct log-probs
    (one of them -inf padding) in every slot, on random from-states, made
    from a numpy seed: the resident kernel's widest layout."""
    import numpy as np

    from nanocall_tpu_torch import convert, transitions

    rng = np.random.default_rng(seed)
    deg, values, n = RANDOM_DEG, RANDOM_VALUES, 4096
    idx = rng.integers(0, n, (deg, n)).astype(np.int32)
    pool = np.log(rng.uniform(0.01, 1.0, (deg, values))).astype(np.float32)
    pool[:, 0] = -np.inf
    pick = np.concatenate([np.tile(np.arange(values), (deg, 1)),
                           rng.integers(0, values, (deg, n - values))], 1)
    lp = np.take_along_axis(pool, rng.permuted(pick, axis=1), axis=1)
    return convert.trans_ops(transitions.SparseTransitions(
        from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), device)


def random_table_ops(device, deg: int, seed: int):
    """TransOps of a random table of `deg` slots of random states and
    log-probs (no packed layout of any kind), made from a numpy seed."""
    import numpy as np

    from nanocall_tpu_torch import convert, transitions

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4096, (deg, 4096)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (deg, 4096))).astype(np.float32)
    return convert.trans_ops(transitions.SparseTransitions(
        from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), device)


def check_table_routes(ops, model, ev, device) -> None:
    """viterbi_forward against its plain version (tolerance 0: the final
    alpha's bits and the backpointers, path and score-only) where the
    resident kernel's NaN tracking and the other kernel run, and
    viterbi_traceback (K6b) on its output against the plain version (path,
    logp as bits): under the loaded table `ops` with a NaN event in one
    read (NaN alphas from there on, and NaN final alphas) and a +inf one at
    the start of another (alphas of -inf: every slot ties); under a random
    table of the resident layout's widest (random_resident_table: 24
    slots, K6b's ring at 2 stages); under the 21-neighbour table of
    (TRANS_P_STAY, TRANS_P_SKIP) as sparse pairs in memory, whose slots
    hold up to 17 distinct log-probs (no text round trip merges them), so
    K6a takes its streaming kernel; and under a random table of 25 slots,
    whose from-state table does not fit beside K6b's ring: both streaming
    kernels."""
    import torch

    from nanocall_tpu_torch import convert, transitions
    from nanocall_tpu_torch.ops import hmm

    pairs = transitions.sparse_from_pairs(transitions.structured_to_pairs(
        transitions.build_structured(transitions.TransitionParams(
            TRANS_P_STAY, TRANS_P_SKIP), 6)), 6)
    ev_nan = {**ev, "mean": ev["mean"].clone()}
    ev_nan["mean"][0, ev["mean"].shape[1] // 2] = float("nan")
    ev_nan["mean"][5, 0] = float("inf")
    for what, ops_, ev_, route, k6b in (
            ("loaded, NaN and +inf events", ops, ev_nan, "resident", "ring"),
            (f"random {RANDOM_DEG} slots x {RANDOM_VALUES} values",
             random_resident_table(device), ev, "resident", "ring"),
            ("in-memory 21-neighbour pairs", convert.trans_ops(pairs, device),
             ev, "streaming", "ring"),
            ("random 25 slots", random_table_ops(device, 25, 25), ev,
             "streaming", "streaming")):
        assert hmm.generic_forward_route(ops_) == route, what
        assert hmm.generic_traceback_route(ops_) == k6b, what
        counts = {k: ops_.from_logp[k].view(torch.int32).unique().numel()
                  for k in range(ops_.from_logp.shape[0])}
        fa_p, bps_p = hmm.viterbi_forward_plain(ops_, model, ev_, True)
        fa_k, bps_k = hmm.viterbi_forward(ops_, model, ev_)
        fa_s, _ = hmm.viterbi_forward(ops_, model, ev_, with_path=False)
        torch.cuda.synchronize()
        fa_bits = fa_p.view(torch.int32)
        assert torch.equal(fa_k.view(torch.int32), fa_bits), what
        assert torch.equal(fa_s.view(torch.int32), fa_bits), what
        assert torch.equal(bps_k, bps_p), what
        wrapper = {"ring": hmm.generic_traceback_ring_kernel,
                   "streaming": hmm.generic_traceback_kernel}[k6b]
        n0 = wrapper.launches
        path_p, logp_p = hmm.viterbi_traceback_plain(ops_, fa_p, bps_p,
                                                     ev_["length"])
        path_k, logp_k = hmm.viterbi_traceback(ops_, fa_k, bps_k,
                                               ev_["length"])
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1, what
        assert torch.equal(path_k, path_p), what
        assert torch.equal(bits(logp_k), bits(logp_p)), what
        print(f"kernel K6a ({route}) under the {what} table (most distinct "
              f"log-probs in a slot: {max(counts.values())}; NaN final "
              f"alphas: {int(torch.isnan(fa_p).sum())}): B={B_KERNEL} "
              f"T={T_KERNEL} path and score-only bit-equal to plain, and "
              f"K6b ({k6b}) on its output")


def nan_fwbw_inputs(model, ev, rows):
    """Copies of the model and events with NaN events in row rows[0] from
    its middle on, a +inf event in row rows[1] and a NaN model entry at one
    state of row rows[2], those three rows of full length."""
    from nanocall_tpu_torch.ops import hmm

    model = hmm.ModelArrays(*(x.clone() for x in model))
    ev = {k: v.clone() for k, v in ev.items()}
    T = ev["mean"].shape[1]
    ev["length"][list(rows)] = T
    ev["mean"][rows[0], T // 2:] = float("nan")
    ev["mean"][rows[1], 5] = float("inf")
    model.level_mean[rows[2], 1234] = float("nan")
    return model, ev


GUARD = 0x7FBADBAD  # a NaN payload that no kernel makes


def guarded_call(wrapper, ops, model, ev, what) -> dict:
    """K6e's `wrapper` with its outputs in rows 1 .. B of (B + 2, T, n)
    buffers of GUARD bits (through hmm._custom_outputs); fails if the
    kernel wrote row 0 or B + 1.  Returns the outputs."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    B, T = ev["mean"].shape
    bufs = {k: torch.full((B + 2, T, 4096), GUARD, dtype=torch.int32,
                          device=ev["mean"].device).view(torch.float32)
            for k in ("alpha", "beta", "gamma")}
    out = {k: v[1:B + 1] for k, v in bufs.items()}
    alloc = hmm._custom_outputs
    hmm._custom_outputs = lambda *_: out
    try:
        got = wrapper(ops, model, ev)
    finally:
        hmm._custom_outputs = alloc
    torch.cuda.synchronize()
    assert got is out, what
    for k, v in bufs.items():
        for row in (0, B + 1):
            assert bool((v[row].view(torch.int32) == GUARD).all()), \
                f"{what}: {k}'s guard row {row} was written"
    return out


def edge_length_inputs(ev):
    """A copy of the events whose first reads have lengths 0, 1, 0, 2, 0:
    a read of length 0 at b = 0 and right after reads of 1 and 2 (where a
    row written before a read's own would land in a short read's rows)."""
    ev = {k: v.clone() for k, v in ev.items()}
    ev["length"][:5] = ev["length"].new_tensor([0, 1, 0, 2, 0])
    return ev


def check_custom_kernel(ops, model, ev) -> dict:
    """K6e's two kernels against their plain version on the same card:
    alpha, beta and gamma bit-equal (tolerance 0, compared as bits).  The
    resident kernel (which hmm.fwbw_custom takes under the loaded table:
    its <21> instance) and the streaming one on the inputs, on
    nan_fwbw_inputs' copies of them (NaN events, a +inf event, a NaN model
    entry) and on edge_length_inputs' (reads of length 0, 1 and 2 first,
    every kernel's outputs between guard rows); the resident kernel's <0>
    instance under a random packed table of 12 / 23 slots, on the inputs
    and the edge lengths.  Then both kernels timed in turns under the
    loaded table (streaming, resident, resident, streaming).  Returns
    {kernel name: record}."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm

    errs, plain_ms = {}, {}
    wrappers = {"fwbw_custom_resident": hmm.fwbw_custom_resident_kernel,
                "fwbw_custom": hmm.fwbw_custom_kernel}
    packed = random_packed_ops(np.random.default_rng(12), 12, 23,
                               ev["mean"].device)
    edge = edge_length_inputs(ev)
    cases = (("clean", ops, (model, ev)),
             ("NaN", ops, nan_fwbw_inputs(model, ev, (4, 5, 6))),
             ("edge lengths", ops, (model, edge)),
             ("random packed 12 / 23", packed, (model, ev)),
             ("random packed 12 / 23, edge lengths", packed, (model, edge)))
    for what, ops_, (m, e) in cases:
        assert hmm.fwbw_route(ops_) == "resident", what
        plain_ms[what], f_p = cuda_ms_once(
            lambda: hmm.fwbw_custom_plain(ops_, m, e))
        n0 = hmm.fwbw_custom_resident_kernel.launches
        outs = [("fwbw_custom_resident", what, hmm.fwbw_custom(ops_, m, e))]
        torch.cuda.synchronize()
        assert hmm.fwbw_custom_resident_kernel.launches == n0 + 1, what
        if ops_ is ops:
            outs.append(("fwbw_custom", what,
                         hmm.fwbw_custom_kernel(ops_, m, e)))
        if "edge" in what:
            for name, _, _ in list(outs):
                outs.append((name, f"{what}, guarded", guarded_call(
                    wrappers[name], ops_, m, e, f"{name} ({what})")))
        torch.cuda.synchronize()
        if what == "NaN":
            assert torch.isnan(f_p["gamma"][6]).any(), "no NaN gamma"
        for name, case, f_k in outs:
            for k in ("alpha", "beta", "gamma"):
                assert torch.equal(bits(f_k[k]), bits(f_p[k])), \
                    f"{name} {k} differs from plain ({case} inputs)"
                errs[name, k, case] = max_err(f_k[k], f_p[k])
        del f_p, outs
    recs = time_in_turns({
        "fwbw_custom": lambda: hmm.fwbw_custom_kernel(ops, model, ev),
        "fwbw_custom_resident": lambda: hmm.fwbw_custom_resident_kernel(
            ops, model, ev)})
    for name, r in recs.items():
        r.update(plain_ms=plain_ms["clean"], max_abs_err=max(
            v for k, v in errs.items() if k[0] == name))
    return with_shape(recs, ev)


def max_err(a, b) -> float:
    """Largest |a - b|, counting equal values (infinities included) and
    NaN against NaN as 0."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, (a - b).abs()).max()) \
        if a.numel() else 0.0


def em_kernel_inputs(models, reads, device, rng) -> dict:
    """The inputs of one EM round's K4 and K5 for G_EM training groups of
    the simulated reads (repeated to fill the chunk), packed by the port's
    pack_train_batch at T = T_EM, with varied parameters, and group 0's
    rows replaced by rows of length 0, 1, T-1 and T."""
    import numpy as np

    from nanocall_tpu_torch import basecall, convert, read_pipeline, train

    cfg = smoke_config()
    summaries, groups, strands = [], [], []
    for name, ed, _ in reads:
        s, evs = read_pipeline.summarize_ed(f"{name}.fast5", ed, models,
                                            cfg)
        summaries.append(s)
        if s.num_ed_events:
            strands.append(evs[0])
            groups += basecall._read_train_groups(len(summaries) - 1, s,
                                                  models, cfg, evs)
    groups = (groups * -(-G_EM // len(groups)))[:G_EM]
    ev, mdl, pm0, st0 = basecall.pack_train_batch(groups, summaries, models,
                                                  cfg, pad_T=T_EM)
    G = len(groups)
    pm0[:, 0] *= rng.uniform(0.95, 1.05, G)
    pm0[:, 1] += rng.uniform(-1.0, 1.0, G)
    pm0[:, 2] = rng.uniform(-0.01, 0.01, G)
    pm0[:, 3] *= rng.uniform(0.9, 1.1, G)
    st0[:] = np.stack([rng.uniform(0.05, 0.2, (G, 2)),
                       rng.uniform(0.2, 0.4, (G, 2))], -1)
    long_ev = max(strands, key=len)
    for si, L in enumerate((0, 1, T_EM - 1, T_EM)):
        for f, pad in (("mean", 1.0), ("stdv", 1.0), ("log_stdv", 0.0),
                       ("start", 0.0)):
            ev[f][0, si] = pad
            ev[f][0, si, :L] = getattr(long_ev, f)[:L]
        ev["length"][0, si] = L
        ev["strand"][0, si] = si % 2
        ev["valid"][0, si] = True
    batch = convert.train_batch(ev, mdl, pm0, st0, device)
    return {**train.round_inputs(*batch, K=6), "batch": batch}


def check_em_kernels(inp) -> dict:
    """K4 and K5 against their plain versions on the same card, at the EM
    chunk's shape: outputs bit-equal (tolerance 0), and times.  Returns
    {kernel name: record}."""
    import torch

    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em, hmm

    gtf, model, ev = inp["gtf"], inp["model"], inp["ev"]
    a_p, lpd_p = hmm.fwbw_grouped_forward_plain(gtf, model, ev)
    a_k, lpd_k = hmm.fwbw_forward_kernel(gtf, model, ev)
    none, lpd_f = hmm.fwbw_forward_kernel(gtf, model, ev, with_alphas=False)
    torch.cuda.synchronize()
    assert none is None
    errs = {"K4 alphas": max_err(a_k, a_p), "K4 log_pr_data":
            max_err(lpd_k, lpd_p), "K4 log_pr_data, no alphas stored":
            max_err(lpd_f, lpd_p)}
    outs = {}
    for flags, tag in (((True, True), "all statistics"),
                       ((True, False), "train_transitions off"),
                       ((False, True), "train_scaling off")):
        case = inp if flags[0] else {**inp, "W": None}
        args = train.em_backward_args(case, lpd_k, a_k, *flags)
        outs[tag] = (em.fused_bwd_mstats_plain(*args),
                     em.em_backward_kernel(*args))
    torch.cuda.synchronize()
    for tag, ((s_p, st_p), (s_k, st_k)) in outs.items():
        errs[f"K5 moments, {tag}"] = max_err(s_k, s_p)
        errs[f"K5 log totals, {tag}"] = max_err(st_k, st_p)
        assert torch.isfinite(s_k).all(), "K5 moments are not finite"
    print(f"em kernels: max |kernel - plain| {errs}")
    for what, e in errs.items():
        assert e == 0.0, f"{what} differ from plain by {e}"
    args = train.em_backward_args(inp, lpd_k, a_k, True, True)
    return with_shape({
        "fwbw_forward": {
            "max_abs_err": max(v for k, v in errs.items() if "K4" in k),
            "ms": cuda_ms(lambda: hmm.fwbw_forward_kernel(gtf, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.fwbw_grouped_forward_plain(
                gtf, model, ev), 1)},
        "em_backward": {
            "max_abs_err": max(v for k, v in errs.items() if "K5" in k),
            "ms": cuda_ms(lambda: em.em_backward_kernel(*args), 3),
            "plain_ms": cuda_ms(lambda: em.fused_bwd_mstats_plain(*args), 1)},
    }, ev)


def bits(x):
    """A float32 tensor's bit patterns (NaN payloads and zero signs
    included), other tensors as they are."""
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_em_under_nan(inp) -> None:
    """K4 (with and without stored alphas) and K5 (all three flag sets) at
    the EM chunk's shape on copies of the inputs with NaN events in row 5
    from event T_EM / 2 on, a NaN model entry at one state of row 6 (alpha
    NaN everywhere from the first step: torch.amax keeps it) and a +inf
    event in row 7, those three valid rows of full length: each bit-equal
    to its plain version (tolerance 0, compared as bits), K5 on the plain
    version's alphas: a max by fmaxf alone would drop the NaN."""
    import torch

    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em, hmm

    model = hmm.ModelArrays(*(x.clone() for x in inp["model"]))
    ev = {k: v.clone() for k, v in inp["ev"].items()}
    valid = inp["valid"].clone()
    ev["length"][5:8] = T_EM
    valid[5:8] = True
    ev["mean"][5, T_EM // 2:] = float("nan")
    model.level_mean[6, 1234] = float("nan")
    ev["mean"][7, 40] = float("inf")
    case = {**inp, "model": model, "ev": ev, "valid": valid}
    gtf = inp["gtf"]
    a_p, lpd_p = hmm.fwbw_grouped_forward_plain(gtf, model, ev)
    a_k, lpd_k = hmm.fwbw_forward_kernel(gtf, model, ev)
    none, lpd_f = hmm.fwbw_forward_kernel(gtf, model, ev, with_alphas=False)
    torch.cuda.synchronize()
    assert none is None and torch.isnan(a_p[T_EM - 1, 6]).all()
    assert torch.equal(bits(a_k), bits(a_p)), "K4 alphas under NaN"
    assert torch.equal(bits(lpd_k), bits(lpd_p)), "K4 log_pr_data under NaN"
    assert torch.equal(bits(lpd_f), bits(lpd_p)), \
        "K4 log_pr_data under NaN, no alphas stored"
    del a_k
    for flags in ((True, True), (True, False), (False, True)):
        args = train.em_backward_args(case if flags[0] else {**case,
                                                             "W": None},
                                      lpd_p, a_p, *flags)
        want = em.fused_bwd_mstats_plain(*args)
        got = em.em_backward_kernel(*args)
        torch.cuda.synchronize()
        for what, g, w in zip(("moments", "log totals"), got, want):
            assert torch.equal(bits(g), bits(w)), \
                f"K5 {what} under NaN, flags {flags}"


def nan_train_batch(batch):
    """A copy of a training batch (convert.train_batch's tensors) with
    group 1's rows valid and of full length, NaN events in its row 1 from
    event T / 2 on, a NaN level mean at one state of its row 2's strand's
    model, and a +inf event in its row 3."""
    ev, mdl, pm, st = batch
    ev = {k: v.clone() for k, v in ev.items()}
    mdl = {k: v.clone() for k, v in mdl.items()}
    T = ev["mean"].shape[2]
    ev["length"][1] = T
    ev["valid"][1] = True
    ev["mean"][1, 1, T // 2:] = float("nan")
    mdl["level_mean"][1, int(ev["strand"][1, 2]), 1234] = float("nan")
    ev["mean"][1, 3, 40] = float("inf")
    return ev, mdl, pm, st


def check_em_statepar(inp, card: str) -> dict:
    """K4m and K5m, the EM round's kernels with the 4096 states split over
    the ranks of a data row (parallel/statepar.py), at the EM chunk's full
    width (all G_EM x 4 rows of T_EM events one data row) over EM_RANKS
    ranks on the chunk's card: K4m (alphas stored, and the fit-only form)
    and K5m (both train flags, and each alone) on the clean chunk, K4m and
    K5m (both flags) on nan_train_batch's, each bit-equal (as bits) to its
    plain version over the same ranks (hmm.fwbw_forward_wave_plain,
    em.em_backward_wave_plain) and to K4 / K5 on the whole rows.  Each pass
    is one launch a wave (statepar.plan_waves on each kernel's own resident
    blocks), the counters zeroed before it; its device time is the sum of
    its launches' (launch_spans: CUDA events around each launch, 3 passes).
    Returns the two kernels' records at 2 ranks (their "ms" a pass,
    "plain_ms" the plain version's pass), and prints every rank count's
    times beside K4's and K5's and the bounds."""
    import torch

    from nanocall_tpu_torch import roofline, train
    from nanocall_tpu_torch.ops import em, hmm
    from nanocall_tpu_torch.parallel import statepar

    dev = inp["x_unc"].device
    recs = {}
    for what, batch in (("clean", inp["batch"]),
                        ("NaN", nan_train_batch(inp["batch"]))):
        whole = train.round_inputs(*batch, K=6)
        B, T = whole["x_unc"].shape
        a_k, lpd_k = hmm.fwbw_forward_kernel(whole["gtf"], whole["model"],
                                             whole["ev"])
        flag_sets = (((True, True), (True, False), (False, True))
                     if what == "clean" else ((True, True),))
        for M in EM_RANKS:
            W = 4096 // M
            ranks = statepar.split_round_states(*batch, [dev] * M)
            for stored in ((True, False) if what == "clean" else (True,)):
                fk = [statepar._fwd_wave_rank(r, stored) for r in ranks]
                fp = [statepar._fwd_wave_rank(r, stored) for r in ranks]

                def k4m(fk=fk, stored=stored):
                    for r in fk:
                        r.flags.zero_()
                    statepar._wave_kernels(
                        fk, hmm.fwbw_forward_wave_kernel,
                        lambda d, sys: hmm.fwbw_forward_wave_resident(
                            d, sys, stored))

                k4m()
                plain_ms, _ = cuda_ms_once(
                    lambda: hmm.fwbw_forward_wave_plain(fp, 0, B))
                torch.cuda.synchronize()
                for rk, rp in zip(fk, fp):
                    tag = f"K4m {what} M={M} stored={stored}"
                    assert torch.equal(bits(rk.lpd), bits(rp.lpd)), \
                        f"{tag} log_pr_data differs from plain"
                    assert torch.equal(bits(rk.lpd), bits(lpd_k)), \
                        f"{tag} log_pr_data differs from K4"
                    if stored:
                        assert torch.equal(bits(rk.alphas),
                                           bits(rp.alphas)), \
                            f"{tag} alphas differ from plain"
                if stored:
                    got = torch.cat([r.alphas for r in fk], dim=2)
                    assert torch.equal(bits(got), bits(a_k)), \
                        f"K4m {what} M={M} alphas differ from K4"
                    del got
                    fwd = fk
                spans = launch_spans(k4m, "fwbw_forward_wave_kernel", dev,
                                     3)
                rec = {"max_abs_err": max(max_err(rk.lpd, rp.lpd)
                                          for rk, rp in zip(fk, fp)),
                       "ms": 1e3 * spans["device_s"] / 3,
                       "host_us": 1e6 * spans["host_s"] / 3,
                       "plain_ms": plain_ms, "launches_a_pass":
                       spans["launches"] // 3, "shape": [B, T], "ranks": M}
                if what == "clean" and stored and M == EM_RANKS[0]:
                    recs["fwbw_forward_wave"] = rec
                print(f"kernel fwbw_forward_wave (K4m, {what}, "
                      f"{'alphas stored' if stored else 'fit-only'}): "
                      f"B={B} T={T} over {M} ranks bit-equal to plain and "
                      f"to K4; {rec['ms']:.3f} ms a pass of "
                      f"{rec['launches_a_pass']} launches by CUDA events "
                      f"around each vs plain {plain_ms:.3f} ms [{card}]")
                del fp
            for ts, tt in flag_sets:
                want = em.em_backward_kernel(*train.em_backward_args(
                    whole if ts else {**whole, "W": None}, lpd_k, a_k, ts,
                    tt))
                bk = [statepar._em_wave_rank(r, f)
                      for r, f in zip(ranks, fwd)]
                bp = [statepar._em_wave_rank(r, f)
                      for r, f in zip(ranks, fwd)]

                def k5m(bk=bk, ts=ts, tt=tt, W=W):
                    for r in bk:
                        r.flags.zero_()
                    statepar._wave_kernels(
                        bk, lambda *a: em.em_backward_wave_kernel(*a, ts, tt),
                        lambda d, sys: em.em_backward_wave_resident(
                            d, sys, ts, W))

                k5m()
                plain_ms, _ = cuda_ms_once(
                    lambda: em.em_backward_wave_plain(bp, 0, B, ts, tt))
                torch.cuda.synchronize()
                for name, g, p, w in zip(("moments", "log totals"),
                                         (bk[0].scal, bk[0].st3),
                                         (bp[0].scal, bp[0].st3), want):
                    tag = f"K5m {what} M={M} flags {(ts, tt)} {name}"
                    assert torch.equal(bits(g), bits(p)), \
                        f"{tag} differ from plain"
                    assert torch.equal(bits(g), bits(w)), \
                        f"{tag} differ from K5"
                spans = launch_spans(k5m, "em_backward_wave_kernel", dev, 3,
                                     module=em)
                rec = {"max_abs_err": max(max_err(bk[0].scal, bp[0].scal),
                                          max_err(bk[0].st3, bp[0].st3)),
                       "ms": 1e3 * spans["device_s"] / 3,
                       "host_us": 1e6 * spans["host_s"] / 3,
                       "plain_ms": plain_ms, "launches_a_pass":
                       spans["launches"] // 3, "shape": [B, T], "ranks": M}
                if what == "clean" and (ts, tt) == (True, True) and \
                        M == EM_RANKS[0]:
                    recs["em_backward_wave"] = rec
                print(f"kernel em_backward_wave (K5m, {what}, flags "
                      f"{(ts, tt)}): B={B} T={T} over {M} ranks bit-equal to "
                      f"plain and to K5; {rec['ms']:.3f} ms a pass of "
                      f"{rec['launches_a_pass']} launches by CUDA events "
                      f"around each vs plain {plain_ms:.3f} ms [{card}]")
                del bk, bp
            del ranks, fwd
        del a_k, whole
        torch.cuda.empty_cache()
    for name in ("fwbw_forward_wave", "em_backward_wave"):
        b = roofline.kernel_bound(name, *recs[name]["shape"])
        ex = roofline.statepar_exchange_bytes(*recs[name]["shape"],
                                              EM_RANKS[0])
        print(f"bound {name} at B={recs[name]['shape'][0]} "
              f"T={recs[name]['shape'][1]}: {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, the function's whatever the ranks); over "
              f"{EM_RANKS[0]} ranks the peers' slices read: alpha columns "
              f"{ex['alpha_column'] / 1e9:.3f} GB, g columns "
              f"{ex['g_column'] / 1e9:.3f} GB, maxima {ex['maxima']} B, "
              f"records {ex['partials']} B")
    return recs


def run_dryrun(device, card: str) -> dict:
    """The port's multi-device dry run (nanocall_tpu_torch.dryrun, the
    counterpart of __graft_entry__.py:68) on four ranks of `device`, a 2 x
    2 mesh, counted as its own path (every kernel count set to 0 just
    before, read just after): it must launch K4m and K5m (the placed EM
    round, bit-equal to the unplaced one), K6am's resident form and K6bm
    (the placed generic decode), K1m and K2m (the placed production decode)
    and K9's kernels, and prints JAX's summary line.  Returns {"launches",
    "wall_s", "line"}."""
    from nanocall_tpu_torch import dryrun
    from nanocall_tpu_torch.ops import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    line = dryrun.dryrun_multichip(4, devices=[device] * 4)
    wall = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    for k in DRYRUN_KERNELS:
        assert launches[k] > 0, f"the dry run did not launch {k}"
    assert line.endswith("seqpar_exact=True pipeline_fasta_equal=True"), line
    print(f"dry run (dryrun_multichip(4) on one card): {wall:.1f} s; "
          f"launches { {k: v for k, v in launches.items() if v} } [{card}]")
    return {"launches": launches, "wall_s": wall, "line": line}


def time_k6c_in_turns(ops, model, ev, reps: int = 3) -> dict:
    """K6c's streaming and resident kernels timed in turns under one table
    (time_in_turns; the streaming kernel on the table's TransOps without
    its packed layout): streaming, resident, resident, streaming.  Returns
    {kernel name: {"ms", "ms_turns"}}."""
    from nanocall_tpu_torch.ops import hmm

    bare = ops._replace(fwbw_packed=None)
    return time_in_turns({
        "fwbw_generic": lambda: hmm.fwbw_generic_kernel(bare, model, ev),
        "fwbw_resident": lambda: hmm.fwbw_resident_kernel(ops, model, ev)},
        reps)


def random_block_table(rng, deg: int, values: int = 16, groups: int = 4):
    """A (deg, 4096) slot table (states, float32 log-probs) of random states
    whose every (slot, block of 4096 / groups states) holds `values`
    distinct log-probs of its own, one of them -inf: at values <= 16 it has
    the resident K6c's layout (hmm.pack_fwbw_sides) at deg <= 23."""
    import numpy as np

    n = 4096
    w = n // groups
    idx = rng.integers(0, n, (deg, n)).astype(np.int32)
    lp = np.empty((deg, n), np.float32)
    for g in range(groups):
        pool = np.log(rng.uniform(0.01, 1.0, (deg, values))).astype(
            np.float32)
        pool[:, 0] = -np.inf
        pick = np.concatenate([np.tile(np.arange(values), (deg, 1)),
                               rng.integers(0, values, (deg, w - values))], 1)
        lp[:, g * w:(g + 1) * w] = np.take_along_axis(
            pool, rng.permuted(pick, axis=1), axis=1)
    return idx, lp


def random_packed_ops(rng, deg_from: int, deg_to: int, device):
    """TransOps of a random table of deg_from from-side and deg_to to-side
    slots (random_block_table) with the resident K6c's layout."""
    from nanocall_tpu_torch import convert, transitions

    (fi, fl), (ti, tl) = (random_block_table(rng, d) for d in (deg_from,
                                                               deg_to))
    return convert.trans_ops(transitions.SparseTransitions(
        from_idx=fi, from_logp=fl, to_idx=ti, to_logp=tl, K=6), device)


#: the slot counts (from side, to side) of the random packed tables the
#: resident K6c is checked under besides the loaded tables' 21 / 21
K6C_RANDOM_DEGS = ((12, 23), (23, 12))


def half_idle(ev: dict) -> dict:
    """The EM chunk's events with the second half of the rows of length 0
    on pack_train_batch's padding events (mean 1, stdv 1, log_stdv 0), as
    1D reads leave a trained run's chunks."""
    half = {k: v.clone() for k, v in ev.items()}
    B = half["mean"].shape[0]
    half["length"][B // 2:] = 0
    for k, x in (("mean", 1.0), ("stdv", 1.0), ("log_stdv", 0.0)):
        half[k][B // 2:] = x
    return half


def check_fwbw_kernels(inp, ops, priors_ops) -> dict:
    """K6d (the grouped backward, betas stored) and K6c against their plain
    versions on the same card, at the EM chunk's shape: outputs bit-equal
    (tolerance 0), and times.  K6d runs on the chunk, on nan_fwbw_inputs'
    copy (NaN events, a +inf event, a NaN model entry) and on the chunk
    with half its rows of length 0 (half_idle), its betas compared as
    bits; it is timed on the full and the half-idle chunk.  K6c runs
    through hmm.fwbw on the events with
    a NaN event in row 3 (of full length) and a +inf event opening row 2:
    its resident kernel under the loaded tables `ops` (TRANS_P_STAY,
    TRANS_P_SKIP) and `priors_ops` (the CLI priors) and under random packed
    tables of K6C_RANDOM_DEGS slots, its streaming kernel under `ops`
    without its packed layout; alpha, beta, em and log_pr_data compared as
    bits.  Then both kernels timed in turns under `ops`
    (time_k6c_in_turns).  Returns {kernel name: record}."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm

    gtf, model, ev = inp["gtf"], inp["model"], inp["ev"]
    half = half_idle(ev)
    errs = {}
    for what, (m, e) in (("", (model, ev)),
                         (", NaN", nan_fwbw_inputs(model, ev, (5, 7, 6))),
                         (", half idle", (model, half))):
        b_p = hmm.fwbw_grouped_backward_plain(gtf, m, e)
        b_k = hmm.fwbw_backward_kernel(gtf, m, e)
        torch.cuda.synchronize()
        assert torch.equal(bits(b_k), bits(b_p)), f"K6d beta{what}"
        errs[f"K6d beta{what}"] = max_err(b_k, b_p)
        del b_p, b_k
    ev_nan = {**ev, "mean": ev["mean"].clone()}
    assert int(ev["length"][3]) == T_EM and int(ev["length"][2]) == T_EM - 1
    ev_nan["mean"][3, T_EM // 2] = float("nan")
    ev_nan["mean"][2, 0] = float("inf")
    plain_ms = None
    for what, ops_, route in (
            (f"({TRANS_P_STAY}, {TRANS_P_SKIP})", ops, "resident"),
            (f"priors ({PRIORS_P_STAY}, {PRIORS_P_SKIP})", priors_ops,
             "resident"),
            *((f"random packed {d_from} / {d_to}", random_packed_ops(
                np.random.default_rng(d_from), d_from, d_to,
                ev["mean"].device), "resident")
              for d_from, d_to in K6C_RANDOM_DEGS),
            (f"({TRANS_P_STAY}, {TRANS_P_SKIP}) without its packed layout",
             ops._replace(fwbw_packed=None), "streaming")):
        assert hmm.fwbw_route(ops_) == route, what
        ms, f_p = cuda_ms_once(lambda: hmm.fwbw_plain(ops_, model, ev_nan))
        plain_ms = plain_ms or ms
        wrapper = (hmm.fwbw_resident_kernel if route == "resident"
                   else hmm.fwbw_generic_kernel)
        n0 = wrapper.launches
        f_k = hmm.fwbw(ops_, model, ev_nan)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1, what
        assert torch.isnan(f_p["alpha"][3]).any(), what
        for k in ("alpha", "beta", "em", "log_pr_data"):
            assert torch.equal(bits(f_k[k]), bits(f_p[k])), \
                f"K6c ({route}) {k} under the {what} table"
            errs[f"K6c {route} {k}, {what}"] = max_err(f_k[k], f_p[k])
        del f_p, f_k
    print(f"fwbw kernels: max |kernel - plain| {errs}")
    for what, e in errs.items():
        assert e == 0.0, f"{what} differs from plain by {e}"
    recs = {"fwbw_grouped_backward": {
        "max_abs_err": max(v for k, v in errs.items() if "K6d" in k),
        "ms": cuda_ms(lambda: hmm.fwbw_backward_kernel(gtf, model, ev), 3),
        "half_idle_ms": cuda_ms(lambda: hmm.fwbw_backward_kernel(
            gtf, model, half), 3),
        "plain_ms": cuda_ms(lambda: hmm.fwbw_grouped_backward_plain(
            gtf, model, ev), 1)}}
    for name, r in time_k6c_in_turns(ops, model, ev).items():
        route = "resident" if name == "fwbw_resident" else "streaming"
        recs[name] = {**r, "plain_ms": plain_ms, "max_abs_err": max(
            v for k, v in errs.items() if k.startswith(f"K6c {route}"))}
    return with_shape(recs, ev)


def check_fma_kernel(device) -> dict:
    """K8 against its plain version on the same card at B_KERNEL rows of
    n = 4096 lanes, T_KERNEL steps of roofline.FMA_K FMAs, on
    measure_fma_peak's inputs: bit-equal (tolerance 0: both round once per
    FMA, ops/fma.py), with both times; then a counting run (x = 0, c = 1,
    d = 2^-10: every FMA exact in float32) whose every lane must hold
    T k d, so a kernel that runs another number of FMAs fails.  Returns
    {kernel name: record}."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import roofline
    from nanocall_tpu_torch.ops import fma

    B, n, T, k = B_KERNEL, 4096, T_KERNEL, roofline.FMA_K
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.9, 1.1, (B, n)).astype(np.float32)).to(device)
    c, d = np.float32(0.9999), np.float32(1e-4)
    plain_ms, want = cuda_ms_once(lambda: fma.fma_chain_plain(x, c, d, T, k))
    got = fma.fma_chain_kernel(x, c, d, T, k)
    count = fma.fma_chain_kernel(torch.zeros_like(x), 1.0, 2.0**-10, T, k)
    torch.cuda.synchronize()
    err = max_err(got, want)
    lanes = int((got != want).sum())
    print(f"kernel K8: B={B} n={n} T={T} k={k}: max |kernel - plain| {err!r} "
          f"in {lanes} lanes (tolerance 0); counting run "
          f"{float(count.min())!r}..{float(count.max())!r} (want "
          f"{T * k * 2.0**-10!r})")
    assert torch.equal(got, want), f"K8 differs from plain by {err}"
    assert torch.all(count == T * k * 2.0**-10), "K8 ran another FMA count"
    return {"fma_chain": {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fma.fma_chain_kernel(x, c, d, T, k), 3),
        "plain_ms": plain_ms, "shape": [B, T]}}


def launch_split(fn, reps: int = 100) -> dict:
    """Where a call of `fn` spends its time: {"host_us": host clock per
    call over reps calls back to back (the enqueue: no synchronize inside),
    "device_us": the device time per call of the kernels it launches
    (torch.profiler over reps calls), "device_kernels": their names}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"host_us": 1e6 * host,
            "device_us": sum(e.self_device_time_total for e in dev) / reps,
            "device_kernels": sorted(e.key for e in dev)}


def check_reshape_kernel(device) -> dict:
    """K10 against its plain version on the same card at the repro's
    (8, 128, 4) -> (8, 512): bit-equal (tolerance 0); the kernel and the
    library call (x.reshape(8, 512).clone(), which is also the plain
    version) timed in turns (library, kernel, kernel, library; cuda_ms over
    1000 calls each: host-bound, so as many as the noise of a few
    microseconds asks), and each call split into host and device time
    (launch_split).  Returns {kernel name: record}."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import repro

    x = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 1.0, (8, 128, 4)).astype(np.float32)).to(device)
    want = repro.reshape_copy_plain(x)
    got = repro.reshape_copy_kernel(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "K10 differs from plain"
    calls = {"kernel": lambda: repro.reshape_copy_kernel(x),
             "library": lambda: x.reshape(8, 512).clone()}
    turns = {"kernel": [], "library": []}
    for who in ("library", "kernel", "kernel", "library"):
        turns[who].append(cuda_ms(calls[who], 1000))
    return {"reshape_copy": {
        "max_abs_err": max_err(got, want),
        "ms": sum(turns["kernel"]) / 2, "ms_turns": turns["kernel"],
        "plain_ms": cuda_ms(lambda: repro.reshape_copy_plain(x), 100),
        "library_ms": sum(turns["library"]) / 2,
        "library_ms_turns": turns["library"],
        "split": {who: launch_split(fn) for who, fn in calls.items()},
        "shape": [8, 512]}}


#: built_sass' answers, by library path: the census reads one library's
#: SASS dozens of times, and each cuobjdump of it takes seconds
_sass: dict = {}


def built_sass() -> str:
    """The SASS of the built library, by cuobjdump -sass (run once a
    library)."""
    from nanocall_tpu_torch.ops import _cuda

    path = _cuda._lib_path()
    if path not in _sass:
        tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        _sass[path] = subprocess.run([tool, "-sass", path],
                                     capture_output=True, text=True,
                                     check=True).stdout
    return _sass[path]


def kernel_instances(marker: str) -> list:
    """The (mangled) names of the built library's kernels whose name
    contains `marker`, sorted: each instance of a template kernel."""
    return sorted(set(re.findall(rf"Function : (\S*{marker}\S*)",
                                 built_sass())))


def sass_lines(marker: str) -> list:
    """The SASS instructions ((address, text) in order) of the first
    kernel of the built library whose name contains `marker`, by cuobjdump
    -sass."""
    body = built_sass().split(marker, 1)[1].split("Function :")[0]
    return [(int(m.group(1), 16), m.group(2).strip()) for m in (
        re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", ln)
        for ln in body.splitlines()) if m]


def fma_sass() -> dict:
    """{"ffma", "instructions"}: the FFMA and all SASS instructions of K8's
    n = 4096 instance (fma_chain_kernel<4>)."""
    lines = [t for _, t in sass_lines("fma_chain_kernelILi4E")]
    return {"ffma": sum(" FFMA " in f" {t} " for t in lines),
            "instructions": len(lines)}


#: SASS opcodes that issue to the 16-lane integer and compare pipe
ALU_OPS = ("FSETP", "ISETP", "LOP3", "SHF", "FSEL", "SEL", "PRMT", "PLOP3",
           "LEA", "IADD3", "FMNMX", "IMNMX")


def resident_sass() -> dict:
    """Instructions per slot and state in the slot loops of K6a's resident
    kernel (each instance's fastest loop: the body of a backward branch
    that reads table words, LDS.64, one per slot and thread), all of them
    and those on the integer and compare pipe (ALU_OPS):
    {"path" / "score": {"per_slot_state", "alu_per_slot_state"}}."""
    out = {}
    for kind, marker in (("path", "viterbi_resident_forward_kernelILb1"),
                         ("score", "viterbi_resident_forward_kernelILb0")):
        ins = sass_lines(marker)
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (a, t) in enumerate(ins):
            m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)", t)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
                body = [x for _, x in ins[at[int(m.group(1), 16)]:i + 1]]
                words = sum("LDS.64" in x for x in body)
                if words:
                    ops = [re.sub(r"^@!?U?P\w+\s+", "", x).split()[0]
                           .split(".")[0] for x in body]
                    alu = sum(o in ALU_OPS for o in ops)
                    loops.append((len(body) / (4 * words),
                                  alu / (4 * words)))
        per, alu = min(loops)
        out[kind] = {"per_slot_state": per, "alu_per_slot_state": alu}
    return out


def _opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def natural_loops(ins: list) -> list:
    """The loops of a kernel's SASS (sass_lines' (address, text) list): for
    each back edge, the instructions that can reach its branch without
    passing its target (the natural loop), as sorted indices into `ins`.
    A CALL returns to the next instruction; the callee is not followed."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    succ = [[] for _ in ins]
    for i, (_, t) in enumerate(ins):
        op = _opcode(t)
        m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)", t)
        if op == "BRA" and m and int(m.group(1), 16) in at:
            succ[i].append(at[int(m.group(1), 16)])
        if (op not in ("BRA", "EXIT", "RET", "BRX", "JMX")
                or t.startswith("@")) and i + 1 < len(ins):
            succ[i].append(i + 1)
    pred = [[] for _ in ins]
    for i, ss in enumerate(succ):
        for j in ss:
            pred[j].append(i)
    loops = []
    for i, ss in enumerate(succ):
        for h in ss:
            if h <= i:
                body, stack = {h, i}, [i]
                while stack:
                    for p in pred[stack.pop()]:
                        if p not in body:
                            body.add(p)
                            stack.append(p)
                loops.append(sorted(body))
    return loops


def time_loop(marker: str) -> tuple:
    """(sass_lines, the indices of its time loop) of the first kernel whose
    name contains `marker`: its largest natural loop that holds a block
    barrier."""
    ins = sass_lines(marker)
    return ins, max((lp for lp in natural_loops(ins)
                     if any(_opcode(ins[k][1]) == "BAR" for k in lp)),
                    key=len)


def step_loop_sass(marker: str) -> dict:
    """A static census of the time loop of the first kernel of the built
    library whose name contains `marker`: the largest natural loop that
    holds a block barrier, every branch inside it counted (the inactive-
    step and NaN paths among them; a division's out-of-line slow path is a
    CALL, counted once).  Returns {"instructions", "per_state" (a thread
    holds 4 states), and per state the block barriers ("bar"), shuffles
    ("shfl"), shared loads ("lds") and stores ("sts"), global loads
    ("ldg") and stores ("stg"), local loads and stores (spills, "local"),
    MUFU ("mufu") and float adds, multiplies and FMAs ("ffma")}."""
    ins, body = time_loop(marker)
    ops = [_opcode(ins[k][1]) for k in body]
    out = {"instructions": len(body), "per_state": len(body) / 4}
    for key, names in (("bar", ("BAR",)), ("shfl", ("SHFL",)),
                       ("lds", ("LDS",)), ("sts", ("STS",)),
                       ("ldg", ("LDG",)), ("stg", ("STG",)),
                       ("local", ("LDL", "STL")), ("mufu", ("MUFU",)),
                       ("ffma", ("FADD", "FMUL", "FFMA"))):
        out[key] = sum(o in names for o in ops) / 4
    return out


#: K1m's eight instances: path and score-only, the exchange at gpu scope
#: (every rank of the row on one card) and at system scope (across cards),
#: two states a thread (slices of 2048) or one (1024 and narrower)
K1M_LOOPS = tuple(
    (f"K1m {kind}{', system scope' if sys else ''}, {own} a thread",
     f"viterbi_forward_wave_kernelILb{int(kind == 'path')}ELb{sys}"
     f"ELi{own}EE")
    for kind in ("path", "score") for sys in (0, 1) for own in (2, 1))
#: the time loops of the redesigned K1 (K1 path and score-only, K3's
#: forward chunk, K1m's eight instances), K4, K5 and K6d
STEP_LOOPS = (("K1 path", "viterbi_forward_kernelILb0ELb1EE"),
              ("K1 score", "viterbi_forward_kernelILb0ELb0EE"),
              ("K3 forward chunk", "viterbi_forward_kernelILb1ELb1EE"),
              *K1M_LOOPS,
              ("K4", "fwbw_forward_kernel"),
              ("K5", "em_backward_kernel"),
              ("K6d", "fwbw_backward_kernel"))


def barrier_loops_sass(marker: str) -> list:
    """The time loops of a kernel with several (the natural loops that hold
    a block barrier and a shared-memory load and lie in no larger such
    loop), in address order: for
    each {"instructions", and the count of block barriers ("bar"), shared
    loads ("lds"), global loads ("ldg", with "ldg_16" of them 16-bit) and
    stores ("stg"), MUFU ("mufu") and local loads and stores ("local")}, the
    whole loop counted once (an inner loop's body once, however often it
    runs)."""
    ins = sass_lines(marker)
    loops = {frozenset(lp) for lp in natural_loops(ins)
             if {"BAR", "LDS"} <= {_opcode(ins[k][1]) for k in lp}}
    out = []
    for lp in sorted((sorted(x) for x in loops
                      if not any(x < o for o in loops)), key=min):
        ops = [_opcode(ins[k][1]) for k in lp]
        rec = {"instructions": len(lp)}
        for key, names in (("bar", ("BAR",)), ("lds", ("LDS",)),
                           ("ldg", ("LDG",)), ("stg", ("STG",)),
                           ("mufu", ("MUFU",)), ("local", ("LDL", "STL"))):
            rec[key] = sum(o in names for o in ops)
        rec["ldg_16"] = sum(_opcode(ins[k][1]) == "LDG" and "16" in re.sub(
            r"^@!?U?P\w+\s+", "", ins[k][1]).split()[0] for k in lp)
        out.append(rec)
    return out


def walk_loop_sass(marker: str) -> dict:
    """A static census of a traceback walk: the largest natural loop of the
    built kernel whose name contains `marker` that holds a shared-memory
    load (the row ring's byte) and issues no bulk copy (the producer's),
    every branch inside it counted (the mbarrier wait's spin among them).
    Returns {"instructions", and the count of shared loads ("lds"), global
    loads ("ldg") and stores ("stg")}; all 0 when no loop qualifies."""
    ins = sass_lines(marker)
    body = max((lp for lp in natural_loops(ins)
                if "LDS" in (ops := [_opcode(ins[k][1]) for k in lp])
                and not any(o.startswith("UBLKCP") for o in ops)),
               key=len, default=[])
    ops = [_opcode(ins[k][1]) for k in body]
    return {"instructions": len(body), "lds": ops.count("LDS"),
            "ldg": ops.count("LDG"), "stg": ops.count("STG")}


def check_sass_claims() -> dict:
    """The census claims of the kernels' headers: K4's and K6d's time loops
    hold at most 2 block barriers; K2's walk and K6b's ring walk read their
    rows (and K6b its from-state table) from shared memory and make no load
    from global memory (the ring's bulk copies fetch them), and K6b's walk
    stores its path; each instance of the resident K6c has two time loops
    (forward, backward) that hold a barrier each and read global memory
    only by the 4 loads of the stored emissions (a thread's states): no
    16-bit load, no slot-table byte (the table and codebooks are read by
    LDS); each instance of the resident K6e has two time loops, the forward
    with 3 block barriers (the norm's max and sums, the new beta) and
    global loads only of the step's 3 event values, the backward with 1
    barrier and loads only of the 8 stored alpha and beta values of a
    thread's states: no 16-bit load, no slot-table byte; each K1m
    instance's time loop reads the column by strong global loads
    (ld.relaxed: L1 bypassed, never the non-coherent path), at least 4 (a
    thread's states), and spills nothing (no local load or store), and
    K2m's walk, on K2's ring, makes no global load.  Returns {"K4",
    "K6d": step_loop_sass, "K2 walk", "K2m walk", "K6b ring walk":
    walk_loop_sass, "K6c resident", "K6e resident": {instance: [loop
    records]}, K1m's instances: {global and local load and store opcode:
    count in the time loop}}."""
    k1m = {}
    for what, marker in K1M_LOOPS:
        ins, body = time_loop(marker)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", ins[k][1]).split()[0] for k in body)
        k1m[what] = {op: n for op, n in ops.items()
                     if op.startswith(("LDG", "LDL", "STL"))}
        assert sum(n for op, n in k1m[what].items() if "STRONG" in op) >= 4, \
            (what, k1m[what])
        assert not any(op.startswith(("LDL", "STL")) for op in k1m[what]), \
            (what, k1m[what])
    k2m = walk_loop_sass("viterbi_traceback_slices_kernel")
    assert k2m["lds"] >= 1 and k2m["ldg"] == 0, k2m
    k4 = step_loop_sass("fwbw_forward_kernel")
    assert k4["bar"] * 4 <= 2, k4
    k6d = step_loop_sass("fwbw_backward_kernel")
    assert k6d["bar"] * 4 <= 2, k6d
    k2 = walk_loop_sass("viterbi_traceback_kernel")
    assert k2["lds"] >= 1 and k2["ldg"] == 0, k2
    k6b = walk_loop_sass("viterbi_generic_traceback_ring_kernel")
    assert k6b["lds"] >= 2 and k6b["ldg"] == 0 and k6b["stg"] >= 1, k6b
    k6c = {}
    for name in kernel_instances("fwbw_resident_kernel"):
        loops = k6c[name] = barrier_loops_sass(name)
        assert len(loops) == 2, (name, loops)
        for lp in loops:
            assert lp["bar"] >= 1 and lp["ldg"] <= 4 and not lp["ldg_16"], \
                (name, loops)
    assert k6c, "no resident K6c in the built library"
    k6e = {}
    for name in kernel_instances("fwbw_custom_resident_kernel"):
        loops = k6e[name] = barrier_loops_sass(name)
        assert len(loops) == 2, (name, loops)
        (fwd, bwd) = loops
        assert fwd["bar"] == 3 and fwd["ldg"] <= 3, (name, loops)
        assert bwd["bar"] == 1 and bwd["ldg"] <= 8, (name, loops)
        assert not fwd["ldg_16"] and not bwd["ldg_16"], (name, loops)
    assert len(k6e) == 2, "not both resident K6e instances in the library"
    return {"K4": k4, "K6d": k6d, "K2 walk": k2, "K2m walk": k2m,
            "K6b ring walk": k6b, "K6c resident": k6c, "K6e resident": k6e,
            **k1m}


def run_measure(device) -> dict:
    """The measurement path (roofline.measure_fma_peak, K8 behind it) at
    each of PEAK_SHAPES, with the launch counts set to 0 before it:
    {"peaks": {(B, T): ops/s}, "seconds": {(B, T): per call},
    "launches"}."""
    from nanocall_tpu_torch import roofline
    from nanocall_tpu_torch.ops import kernels

    kernels.reset_launches()
    peaks, seconds = {}, {}
    for B, T in PEAK_SHAPES:
        peaks[(B, T)], seconds[(B, T)] = roofline.measure_fma_peak(
            B, 4096, T, k=roofline.FMA_K, device=device)
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    assert launches["fma_chain"] == 5 * len(PEAK_SHAPES), launches
    return {"peaks": peaks, "seconds": seconds, "launches": launches}


def run_repro_tool() -> dict:
    """tools/torch_reshape_repro.py's main on the card, in process (stdout
    captured), with the launch counts set to 0 before it: it must print
    PASS and launch K10 once.  Returns the launches."""
    import importlib.util
    import io

    import torch

    from nanocall_tpu_torch.ops import kernels

    spec = importlib.util.spec_from_file_location(
        "torch_reshape_repro",
        os.path.join(ROOT, "tools", "torch_reshape_repro.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    print(f"repro tool: {buf.getvalue().strip()}")
    assert rc == 0 and buf.getvalue().startswith("PASS"), buf.getvalue()
    assert launches["reshape_copy"] == 1, launches
    return launches


def share_line(name: str, rec: dict, peak: float) -> str:
    """A kernel's float32 rate and its shares (roofline.kernel_shares) of
    67 TFLOP/s and of the K8 peak at its shape, as one line of text."""
    from nanocall_tpu_torch import roofline

    sh = roofline.kernel_shares(name, *rec["shape"], rec["ms"], peak)
    return (f"{sh['f32_ops_per_s'] / 1e12:.3f} TFLOP/s = "
            f"{100 * sh['share_of_f32_spec']:.2f}% of the 67 TFLOP/s spec, "
            f"{100 * sh['share_of_k8_peak']:.2f}% of the measured K8 peak "
            f"{peak / 1e12:.3f} TFLOP/s")


def simulated_reads(models, rng, n_1d: int = N_1D,
                    n_2strand: int = N_2STRAND, specs=None,
                    prefix: str = "sim"):
    """[(name, EdEventData, [true bases per strand])]: n_1d 1D reads of
    2,000-8,000 events and n_2strand 2-strand hairpin reads of 3,000 +
    3,000, or the reads of specs, (2-strand, events per strand) each, drawn
    by the package simulator (nanocall_tpu_torch.simulate.simulate_read at
    identity scaling, noise NOISE: 70 pad events at each end, a hairpin of
    8 events at 110 pA, event lengths of 10..39 samples at 4 kHz)."""
    from nanocall_tpu_torch import ingest, simulate

    reads = []
    if specs is None:
        specs = ([(False, int(n)) for n in rng.integers(2000, 8001, n_1d)]
                 + [(True, 3000)] * n_2strand)
    for i, (two_strand, n) in enumerate(specs):
        name = f"{prefix}{i:02d}"
        mean, stdv, start, length, truth = simulate.simulate_read(
            models, "r73.t.006", "r73.c.p1.006" if two_strand else None, n,
            rng, noise_scale=NOISE)
        ed = ingest.ed_from_arrays(mean, stdv, start, length, 4000.0, name)
        reads.append((name, ed, truth.base_seqs))
    return reads


def write_tool_inputs(models, rng, n_events: int, tag: str):
    """The dev tools' inputs as TSVs in build/chip_smoke/tools/: the r73
    template model (unscaled: the read is simulated at identity scaling)
    and one 1D read of n_events simulated from it (simulate_read, its pads
    cut off; times in seconds).  Returns (model path, events path, the
    read's true bases)."""
    from nanocall_tpu_torch import events, pore_model, simulate

    d = os.path.join(ROOT, "build", "chip_smoke", "tools")
    os.makedirs(d, exist_ok=True)
    pm_path = os.path.join(d, "r73.t.006.tsv")
    pore_model.save_tsv(models["r73.t.006"], pm_path)
    mean, stdv, start, length, truth = simulate.simulate_read(
        models, "r73.t.006", None, n_events, rng, noise_scale=NOISE)
    strand = slice(SIM_PAD, SIM_PAD + n_events)
    ev_path = os.path.join(d, f"events_{tag}.tsv")
    events.save_tsv(events.EventSequence(
        mean[strand], stdv[strand], start[strand] / 4000.0,
        length[strand] / 4000.0), ev_path)
    return pm_path, ev_path, truth.base_seqs[0]


def call_tool(argv) -> tuple:
    """(stdout, launches by kernel, wall seconds) of one tools.main call on
    the card, in process; the launch counts start from 0."""
    import io

    import torch

    from nanocall_tpu_torch import tools
    from nanocall_tpu_torch.ops import kernels

    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, (argv, rc)
    return (buf.getvalue(), {k.name: k.wrapper.launches
                             for k in kernels.KERNELS}, wall)


def check_posteriors(text: str) -> list:
    """run-fwbw's printed posteriors: at least one, each in [0.1, 1], in
    descending order.  Returns them."""
    post = [float(line.split("\t")[1]) for line in text.strip().splitlines()]
    assert post, "run-fwbw printed no posterior"
    assert all(0.1 <= p <= 1.0 + 1e-6 for p in post), post
    assert post == sorted(post, reverse=True), post
    return post


def check_matrix_dump(path: str, custom: bool) -> None:
    """run-fwbw's -o dump of a TOOLS_DUMP_EVENTS read: every (event, state)
    line once, in order, and posteriors that sum to 1 per event within
    1e-3 (exp(gamma), or exp(alpha + beta - log Pr[data]))."""
    import numpy as np

    n = 4096
    m = np.loadtxt(path, delimiter="\t")
    assert m.shape == (TOOLS_DUMP_EVENTS * n, 5 if custom else 4), m.shape
    assert np.array_equal(m[:, 0], np.repeat(np.arange(TOOLS_DUMP_EVENTS), n))
    assert np.array_equal(m[:, 1], np.tile(np.arange(n), TOOLS_DUMP_EVENTS))
    vals = m[:, 2:].reshape(TOOLS_DUMP_EVENTS, n, -1)
    if custom:
        post = np.exp(vals[..., 2])
    else:
        lpd = np.logaddexp.reduce(vals[-1, :, 0])
        post = np.exp(vals[..., 0] + vals[..., 1] - lpd)
    sums = post.sum(1)
    assert np.allclose(sums, 1.0, atol=1e-3), (path, sums.min(), sums.max())


def check_k3_refused(d: str, ev_path: str) -> None:
    """The decoding tools with -K 3 on the card: the K = 6 kernels raise
    their ValueError, and nothing is launched or falls back."""
    import numpy as np

    from nanocall_tpu_torch import kmer, pore_model, transitions
    from nanocall_tpu_torch.ops import kernels

    n3 = kmer.n_states(3)
    pore_model.save_tsv(pore_model.PoreModel(*(
        np.full(n3, v, np.float32) for v in (80.0, 1.5, 1.0, 0.3)), K=3),
        os.path.join(d, "k3_model.tsv"))
    transitions.save_tsv(transitions.build_structured(K=3),
                         os.path.join(d, "k3_trans.tsv"))
    args = ["-p", os.path.join(d, "k3_model.tsv"), "-s",
            os.path.join(d, "k3_trans.tsv"), "-e", ev_path, "-K", "3",
            "--device", "cuda"]
    for tool in (["run-viterbi"], ["run-fwbw"], ["run-fwbw", "--custom-fwbw"]):
        kernels.reset_launches()
        try:
            call_tool([*tool, *args])
        except ValueError as e:
            assert "K=6" in str(e), e
        else:
            raise AssertionError(f"{' '.join(tool)} -K 3 ran on the card")
        assert not any(k.wrapper.launches for k in kernels.KERNELS)


def run_tools(models, trans_path: str, rng) -> dict:
    """run-viterbi, run-fwbw and run-fwbw --custom-fwbw on the card at full
    width (n = 4096, the loaded table, a read of TOOLS_EVENTS), each
    checked and required to launch its kernels; each fwbw run again with -o
    on a read of TOOLS_DUMP_EVENTS (check_matrix_dump); both fwbw runs once
    more with the table's K6c layout taken away (convert.trans_ops
    wrapped): the streaming K6c and K6e print the resident ones'
    posteriors byte for byte;
    then -K 3 (check_k3_refused).  Returns {run: {"launches" (both calls of a fwbw
    run), "wall_s" (the TOOLS_EVENTS call), ...}}."""
    from nanocall_tpu_torch import simulate

    pm_path, ev_long, truth = write_tool_inputs(models, rng, TOOLS_EVENTS,
                                                "long")
    _, ev_short, _ = write_tool_inputs(models, rng, TOOLS_DUMP_EVENTS,
                                       "short")

    def args(ev_path):
        return ["-p", pm_path, "-s", trans_path, "-e", ev_path, "--device",
                "cuda"]

    out, launches, wall = call_tool(["run-viterbi", *args(ev_long)])
    seq = out.strip()
    w = round(IDENTITY_WINDOW * len(truth) / max(len(seq), 1))
    ident = simulate.identity(seq[:IDENTITY_WINDOW], truth[:w])
    assert ident > IDENTITY_MIN, ident
    runs = {"run_viterbi": {"launches": launches, "wall_s": wall,
                            "bases": len(seq), "identity": ident}}
    fwbw_out = {}
    for name, extra in (("run_fwbw", []),
                        ("run_fwbw_custom", ["--custom-fwbw"])):
        out, launches, wall = call_tool(["run-fwbw", *args(ev_long), *extra])
        fwbw_out[bool(extra)] = out
        post = check_posteriors(out)
        dump = os.path.join(os.path.dirname(pm_path), f"{name}_o.tsv")
        out, launches_o, _ = call_tool(["run-fwbw", *args(ev_short), *extra,
                                        "-o", dump])
        check_posteriors(out)
        check_matrix_dump(dump, bool(extra))
        runs[name] = {"launches": {k: c + launches_o[k]
                                   for k, c in launches.items()},
                      "wall_s": wall, "top_posterior": post[0],
                      "printed": len(post)}
    # both fwbw runs again with the table's K6c layout taken away: the
    # streaming K6c and K6e print the same posteriors
    from unittest import mock

    from nanocall_tpu_torch import convert

    make = convert.trans_ops
    with mock.patch.object(convert, "trans_ops", lambda table, dev: make(
            table, dev)._replace(fwbw_packed=None)):
        for name, extra, resident in (
                ("run_fwbw_streaming", [], "fwbw_resident"),
                ("run_fwbw_custom_streaming", ["--custom-fwbw"],
                 "fwbw_custom_resident")):
            out_s, launches, wall = call_tool(["run-fwbw", *args(ev_long),
                                               *extra])
            assert out_s == fwbw_out[bool(extra)], \
                f"{name}: run-fwbw {extra} differs on the streaming kernel"
            assert launches[resident] == 0, launches
            runs[name] = {"launches": launches, "wall_s": wall}
    for name, must in TOOL_KERNELS.items():
        for k in must:
            assert runs[name]["launches"][k] > 0, f"{name} did not launch {k}"
    check_k3_refused(os.path.dirname(pm_path), ev_short)
    return runs


def run_dump(models, reads, device) -> dict:
    """basecall.dump_training_data on the in-memory summaries of two
    simulated reads, into build/chip_smoke/dump/: it must launch K6c's
    resident kernel once per subsequence, and its TSVs meet the reference's invariants
    (tests/test_pipeline.py:626-646).  Returns {"launches", "wall_s",
    "subsequences"}."""
    import shutil

    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall, read_pipeline
    from nanocall_tpu_torch.ops import kernels

    cfg = smoke_config()
    out = os.path.join(ROOT, "build", "chip_smoke", "dump")
    shutil.rmtree(out, ignore_errors=True)
    stream = [read_pipeline.summarize_ed(f"{name}.fast5", ed, models, cfg)
              for name, ed, _ in reads[:2]]
    kernels.reset_launches()
    t0 = time.perf_counter()
    grp = basecall.dump_training_data(stream, models, cfg, device, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    assert grp is not None, "no read was trainable"
    S = len(grp.seqs)
    # the structured tables of trained parameters pack (at most 8
    # log-probs a slot): the resident K6c
    assert launches["fwbw_resident"] == S, launches
    assert launches["fwbw_generic"] == 0, launches
    n = 4096
    assert sorted(os.listdir(out)) == sorted(
        f"{s}.{k}.tab" for k in range(S)
        for s in ("emissions", "transitions", "fw", "bw"))
    for k, (ev, _) in enumerate(grp.seqs):
        em, fw, bw = (np.loadtxt(os.path.join(out, f"{s}.{k}.tab"))
                      for s in ("emissions", "fw", "bw"))
        assert em.shape == fw.shape == bw.shape == (len(ev), n)
        assert np.allclose(fw[0], em[0] - np.log(n), atol=2e-4)
        post = np.exp(fw + bw - np.logaddexp.reduce(fw[-1]))
        assert np.allclose(post.sum(1), 1.0, atol=1e-3)
        with open(os.path.join(out, f"transitions.{k}.tab")) as fh:
            rows = 0
            for i, line in enumerate(fh):
                rows += 1
                if i < 64:
                    row = np.array(line.split("\t"), np.float64)
                    mass = np.exp(row).sum()
                    assert row.shape == (n,) and 0.9 < mass <= 1.0 + 1e-4
        assert rows == n
    return {"launches": launches, "wall_s": wall, "subsequences": S}


class StageTimer:
    """Wall seconds per named stage: the `timer` run_pipeline takes."""

    def __init__(self):
        self.stages: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + time.perf_counter() - t0)


def smoke_config(*flags):
    """The port CLI's Config for `sim --pore r73 -t 1 <flags>`."""
    from nanocall_tpu_torch import cli

    return cli.config_from_args(cli.build_parser().parse_args(
        ["sim", "--pore", "r73", "-t", "1", *flags]))


def read_fasta(path: str) -> dict:
    """{record name: sequence} of a FASTA file."""
    records, name = {}, None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:]
                records[name] = ""
            elif line:
                records[name] += line
    return records


def run_end_to_end(models, reads, device, train: bool, must_launch,
                   trans=None, tag: str = "", trace_dir: str = "",
                   sharder=None, fasta: str = "") -> dict:
    """run_pipeline over the reads, untrained (`--no-train`) or with the
    default EM training, under the loaded table when `trans` (the TSV
    path and the table load_trans_table returns), inside
    observe.device_trace(trace_dir) when trace_dir is given (`--trace-dir`),
    over the data sharder `sharder` when given, with FASTA and stats
    written by the port CLI's writer into build/chip_smoke/<tag> (or the
    FASTA to `fasta`, the stats beside it); checks the records, identity
    and launches."""
    import torch

    from nanocall_tpu_torch import basecall, cli, observe, read_pipeline, \
        simulate
    from nanocall_tpu_torch.ops import kernels

    name = tag or (("trained" if train else "untrained")
                   + ("_trans" if trans else ""))
    out = os.path.join(ROOT, "build", "chip_smoke", name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cfg = smoke_config("-o", fasta or out + ".fa",
                       "--stats", (fasta or out) + ".tsv",
                       *([] if train else ["--no-train"]),
                       *(["-s", trans[0]] if trans else []))
    decoded = {}  # strands the decode must write, with their event counts

    def stream():
        for name, ed, _ in reads:
            s, evs = read_pipeline.summarize_ed(f"{name}.fast5", ed, models,
                                                cfg)
            if s.num_ed_events:
                for st in (0, 1):
                    if len(evs[st]) >= cfg.min_ed_events:
                        decoded[(name, st)] = len(evs[st])
            yield s, evs

    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with observe.device_trace(trace_dir, device):
        summaries, results = basecall.run_pipeline(
            stream(), models, cfg, device, timer=timer,
            default_transitions=trans[1] if trans else None, sharder=sharder)
    wall = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    cli.write_outputs(summaries, results, models, cfg)
    fasta = read_fasta(cfg.output)
    with open(cfg.stats_fn) as fh:
        n_stats = len(fh.read().strip().splitlines()) - 1
    assert len(summaries) == len(reads) == n_stats
    assert decoded, "no strand was decodable"
    assert len(fasta) == len(decoded), (len(fasta), sorted(decoded))
    assert {(r.seq_name.split(":")[0], r.strand) for r in results} == \
        set(decoded)
    for k in must_launch:
        assert launches[k] > 0, f"kernel {k} was not launched by the run"
    if train:
        trained = [s for s in summaries if s.fits]
        assert trained, "no read was trained"
        for s in trained:
            if not s.scale_strands_together:  # a 1D read
                best = max(s.fits, key=lambda k: s.fits[k])
                p = s.pm_params[best]
                assert 0.8 < p.scale < 1.2 and abs(p.shift) < 10.0, \
                    (s.read_id, p)

    truths = {name: truth for name, _, truth in reads}
    idents = []
    for r in results:
        seq = fasta[r.seq_name]
        truth = truths[r.seq_name.split(":")[0]][r.strand]
        assert len(r.path) == len(r.ev) and seq and seq == r.base_seq
        # the same stretch of both: the truth's window scaled by the lengths
        w = round(IDENTITY_WINDOW * len(truth) / len(seq))
        idents.append(simulate.identity(seq[:IDENTITY_WINDOW], truth[:w]))
    events = sum(decoded.values())
    assert min(idents) > IDENTITY_MIN, idents
    return {"reads": len(reads), "records": len(fasta), "events": events,
            "wall_s": wall, "events_per_s": events / wall,
            "stages": timer.stages, "identity_min": min(idents),
            "identity_mean": sum(idents) / len(idents),
            "launches": launches, "peak_gib": peak / 2**30}


def stats_close(a_path: str, b_path: str, rtol: float) -> None:
    """Two stats TSVs: the same rows and text fields, numbers within
    rtol."""
    with open(a_path) as fa, open(b_path) as fb:
        rows_a = [r.split("\t") for r in fa.read().splitlines()]
        rows_b = [r.split("\t") for r in fb.read().splitlines()]
    assert len(rows_a) == len(rows_b) and rows_a[0] == rows_b[0]
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        assert len(ra) == len(rb), (ra, rb)
        for x, y in zip(ra, rb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (ra, rb)
                continue
            assert abs(fx - fy) <= rtol * max(abs(fx), abs(fy)) or fx == fy, \
                (ra, rb)


def run_trans_streaming(models, reads, device, trans) -> dict:
    """The untrained run under the loaded table again, with its TransOps
    built without the packed layout and the from-state table
    (convert.trans_ops wrapped for the run): K6a's and K6b's streaming
    kernels decode it.  The resident run (the one before) launched no
    streaming K6a or K6b, this one no resident K6a or ring K6b, and the
    two FASTA files are byte-equal.  Returns the run's result."""
    from unittest import mock

    from nanocall_tpu_torch import convert

    make = convert.trans_ops

    def bare(table, dev):
        return make(table, dev)._replace(from_packed=None, from_codebook=None,
                                         from_states=None)

    with mock.patch.object(convert, "trans_ops", bare):
        r = run_end_to_end(models, reads, device, False, STREAMING_KERNELS,
                           trans, tag="untrained_trans_streaming")
    for k in ("viterbi_resident_forward_path",
              "viterbi_resident_forward_score",
              "viterbi_generic_traceback_ring"):
        assert r["launches"][k] == 0, f"the streaming run launched {k}"
    out = os.path.join(ROOT, "build", "chip_smoke")
    with open(os.path.join(out, "untrained_trans.fa"), "rb") as a, \
            open(os.path.join(out, "untrained_trans_streaming.fa"), "rb") as b:
        assert a.read() == b.read(), "the streaming run's FASTA differs"
    return r


def run_sharded(models, reads, device, card: str) -> dict:
    """The untrained and the trained runs of the reads again over a data
    sharder of two shards on the one card (DataSharder(devices=[cuda:0,
    cuda:0])): the untrained FASTA byte-equal to the unsharded run's, the
    trained stats within rtol 2e-3 of its (with the identity checks of
    every run), decode chunks (and in the trained run EM chunks) cut into
    shards, and each run's kernels launched.  {run name: result}."""
    from nanocall_tpu_torch.parallel import mesh

    class CountingSharder(mesh.DataSharder):
        """Counts the chunks it cut, EM (an event dict first) and decode."""

        def __init__(self, devices):
            super().__init__(devices=devices)
            self.cut = {"em": 0, "decode": 0}

        def shard(self, tree, batch_size: int) -> list:
            self.cut["em" if isinstance(tree[0], dict) else "decode"] += 1
            return super().shard(tree, batch_size)

    out = os.path.join(ROOT, "build", "chip_smoke")
    runs = {}
    for train, kernels_, tag in ((False, UNTRAINED_KERNELS, "untrained"),
                                 (True, TRAINED_KERNELS, "trained")):
        sharder = CountingSharder([device, device])
        assert sharder.active and sharder.align == 2
        runs[tag] = run_end_to_end(models, reads, device, train, kernels_,
                                   tag=f"{tag}_sharded", sharder=sharder)
        assert sharder.cut["decode"] > 0, sharder.cut
        assert sharder.cut["em"] > 0 or not train, sharder.cut
        runs[tag]["cut"] = dict(sharder.cut)
        print_run(f"{tag} over 2 shards on one card", runs[tag], card)
    with open(os.path.join(out, "untrained.fa"), "rb") as a, \
            open(os.path.join(out, "untrained_sharded.fa"), "rb") as b:
        assert a.read() == b.read(), "the sharded untrained FASTA differs"
    stats = [os.path.join(out, f"trained{x}.tsv") for x in ("", "_sharded")]
    stats_close(*stats, 2e-3)
    with open(stats[0], "rb") as a, open(stats[1], "rb") as b:
        same = a.read() == b.read()
    print(f"sharder: untrained FASTA byte-equal, trained stats within rtol "
          f"2e-3 of the unsharded runs (byte-equal: {same}); chunks cut "
          f"{ {k: r['cut'] for k, r in runs.items()} }")
    return runs


def run_multihost(models, reads, device, card: str) -> dict:
    """Two hosts emulated in this process: multihost.partition_files over
    the reads, run_pipeline untrained per host into its
    multihost.shard_output_path, then multihost.merge_shards; the merged
    FASTA must equal the untrained run's byte for byte.  Returns the
    launches of both hosts' runs."""
    from nanocall_tpu_torch.parallel import multihost

    out = os.path.join(ROOT, "build", "chip_smoke", "multihost.fa")
    launches = {}
    for host in range(2):
        part = multihost.partition_files(list(reads), host, 2)
        multihost.remove_stale_shard(out, host, 2)
        r = run_end_to_end(models, part, device, False, HOST_KERNELS,
                           tag=f"host{host}",
                           fasta=multihost.shard_output_path(out, host, 2))
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    multihost.merge_shards(out, 2)
    with open(os.path.join(os.path.dirname(out), "untrained.fa"), "rb") as a, \
            open(out, "rb") as b:
        assert a.read() == b.read(), "the merged multi-host FASTA differs"
    print(f"multihost: 2 hosts' shards ({len(reads)} reads) merged; FASTA "
          f"byte-equal to the untrained run's [{card}]")
    return launches


def check_trace(trace_dir: str) -> None:
    """The traced run wrote a Chrome trace that names the K1 and K2
    kernels (CUPTI records the kernels the ctypes library launches), and
    its FASTA equals the untrained run's byte for byte."""
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        text = fh.read()
    for k in ("viterbi_forward_kernel", "viterbi_traceback_kernel"):
        assert k in text, f"the trace names no {k}"
    out = os.path.join(ROOT, "build", "chip_smoke")
    with open(os.path.join(out, "untrained.fa"), "rb") as a, \
            open(os.path.join(out, "traced.fa"), "rb") as b:
        assert a.read() == b.read(), "the traced run's FASTA differs"
    print(f"trace: {len(text)} bytes of Chrome trace names the K1 and K2 "
          f"kernels; FASTA byte-equal to the untrained run's")


def print_run(what: str, e2e: dict, card: str) -> None:
    stages = ", ".join(
        f"{k} {v:.3f} s = {e2e['events'] / v:.0f} events/s"
        for k, v in e2e["stages"].items())
    print(f"end_to_end {what}: {e2e['reads']} reads, {e2e['records']} FASTA "
          f"records, {e2e['events']} events in {e2e['wall_s']:.3f} s = "
          f"{e2e['events_per_s']:.0f} events/s ({stages}); identity min "
          f"{e2e['identity_min']:.3f} mean {e2e['identity_mean']:.3f} "
          f"(first {IDENTITY_WINDOW} bases); peak device memory "
          f"{e2e['peak_gib']:.3f} GiB; launches {e2e['launches']} [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from nanocall_tpu_torch import cli, roofline
    from nanocall_tpu_torch.ops import _cuda, hmm, kernels

    device = torch.device("cuda", 0)
    card = smi_line()
    print(card)
    t_main = time.perf_counter()

    def stamp(what: str) -> None:
        """The seconds since the card line, before a phase: where a run's
        time goes, against the time limit."""
        print(f"[{time.perf_counter() - t_main:.1f} s] {what}", flush=True)
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; nvcc: "
          f"{[l for l in nvcc.splitlines() if 'release' in l][0]}")

    t0 = time.perf_counter()
    _cuda.load()
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load "
          f"(nvcc {_cuda.build_seconds:.2f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    sass = fma_sass()
    print(f"K8 SASS (fma_chain_kernel<4>, cuobjdump -sass): {sass['ffma']} "
          f"FFMA of {sass['instructions']} instructions")
    for kind, c in resident_sass().items():
        print(f"K6a resident SASS ({kind}): {c['per_slot_state']:.2f} "
              f"instructions per slot and state in its fastest slot loop, "
              f"{c['alu_per_slot_state']:.2f} of them on the integer and "
              f"compare pipe")

    for what, marker in STEP_LOOPS:
        c = step_loop_sass(marker)
        per = ", ".join(f"{k} {v:g}" for k, v in c.items()
                        if k not in ("instructions", "per_state"))
        print(f"{what} SASS (cuobjdump -sass): {c['instructions']} "
              f"instructions in its time loop, {c['per_state']:g} per state "
              f"and step; per state {per}")
    census = check_sass_claims()
    for what in ("K4", "K6d"):
        print(f"{what} SASS: {census[what]['bar'] * 4:g} block barriers in "
              f"its time loop (at most 2)")
    print(f"K2 SASS, its walk loop: {census['K2 walk']} (no global load)")
    print(f"K2m SASS, its walk loop on K2's ring: {census['K2m walk']} (no "
          f"global load)")
    for what, _ in K1M_LOOPS:
        print(f"{what} SASS, the global and local loads and stores of its "
              f"time loop: {census[what]} (the column by strong loads; no "
              f"spill)")
    for name in kernel_instances("viterbi_traceback_chunk_kernel"):
        print(f"K3 / K9 traceback chunk SASS ({name}), its walk loop: "
              f"{walk_loop_sass(name)}")
    print(f"K6b ring SASS, its walk loop: {census['K6b ring walk']} (no "
          f"global load; the path's stores)")
    for name, loops in census["K6c resident"].items():
        for what, lp in zip(("forward", "backward"), loops):
            print(f"K6c resident SASS ({name}), {what} time loop (its state "
                  f"loop counted once): {lp}; its only global loads are the "
                  f"{lp['ldg']} loads of the stored emissions")
    for name, loops in census["K6e resident"].items():
        for what, lp in zip(("forward", "backward"), loops):
            print(f"K6e resident SASS ({name}), {what} time loop (its state "
                  f"loop counted once): {lp}; {lp['bar']} block barriers, "
                  f"no slot-table byte from global memory")
    for what, marker in (("K6c streaming", "fwbw_generic_kernel"),):
        print(f"{what} SASS: {step_loop_sass(marker)}")

    stamp("models, tables and the decode kernels at 16 x 2048")
    models = cli.init_models(smoke_config())
    t0 = time.perf_counter()
    trans = load_trans_table(device)
    priors = load_trans_table(device, PRIORS_P_STAY, PRIORS_P_SKIP,
                              "trans_priors.tsv")
    print(f"transitions: 21-neighbour tables of (p_stay, p_skip) = "
          f"({TRANS_P_STAY}, {TRANS_P_SKIP}) and the priors "
          f"({PRIORS_P_STAY}, {PRIORS_P_SKIP}) written and loaded back in "
          f"{time.perf_counter() - t0:.2f} s; from_idx "
          f"{tuple(trans[2].from_idx.shape)}; K6a resident / streaming, K6c "
          f"resident under both")
    rng = np.random.default_rng(2024)
    gt, model, ev = kernel_inputs(models, device, B_KERNEL, T_KERNEL, rng)
    recs = check_kernels(gt, model, ev)
    check_forward_under_nan(gt, model, ev)
    print(f"K1 (path, score), K3's forward chunk, K9 (2 ranks) and K2 at "
          f"B={B_KERNEL} T={T_KERNEL} with NaN events, a NaN stay entry and "
          f"a NaN model entry: bit-equal to their plain versions, K3's "
          f"decode to K1 + K2 [{card}]")
    recs.update(check_generic_kernels(trans[2], model, ev))
    check_table_routes(trans[2], model, ev, device)
    recs.update(check_custom_kernel(trans[2], model, ev))
    for name, r in recs.items():
        turns = f" (in turns: {r['ms_turns']})" if "ms_turns" in r else ""
        print(f"kernel {name}: B={B_KERNEL} T={T_KERNEL} n=4096 bit-equal to "
              f"plain; {r['ms']:.3f} ms{turns} vs plain {r['plain_ms']:.3f} "
              f"ms [{card}]")
    stamp("K8 and the measurement path")
    recs.update(check_fma_kernel(device))
    measure = run_measure(device)
    peak = measure["peaks"][(B_KERNEL, T_KERNEL)]
    k8, k8_bound = recs["fma_chain"], roofline.kernel_bound(
        "fma_chain", B_KERNEL, T_KERNEL)
    print(f"kernel fma_chain (K8): B={B_KERNEL} n=4096 T={T_KERNEL} "
          f"k={roofline.FMA_K} bit-equal to plain; {k8['ms']:.3f} ms vs plain "
          f"{k8['plain_ms']:.3f} ms; bound {k8_bound['bound_ms']:.4f} ms "
          f"({k8_bound['bound_by']}); {share_line('fma_chain', k8, peak)} "
          f"[{card}]")
    for (B, T), pk in measure["peaks"].items():
        print(f"measured K8 peak (roofline.measure_fma_peak) at B={B} x "
              f"T={T} x k={roofline.FMA_K}: {pk / 1e12:.3f} TFLOP/s = "
              f"{100 * pk / roofline.H100_F32_OPS_PER_S:.2f}% of 67 TFLOP/s, "
              f"{measure['seconds'][(B, T)] * 1e3:.3f} ms per call [{card}]")
    for name in ("viterbi_forward_path", "viterbi_forward_score"):
        print(f"kernel {name} at B={B_KERNEL} T={T_KERNEL}: "
              f"{share_line(name, recs[name], peak)} [{card}]")
    recs.update(check_reshape_kernel(device))
    k10 = recs["reshape_copy"]
    k10_bound = roofline.kernel_bound("reshape_copy", 8, 512)
    split = k10["split"]
    print(f"kernel reshape_copy (K10): (8, 128, 4) -> (8, 512) bit-equal to "
          f"plain; {k10['ms']:.4f} ms vs plain {k10['plain_ms']:.4f} ms, "
          f"library call x.reshape(8, 512).clone() {k10['library_ms']:.4f} "
          f"ms (in turns: library {k10['library_ms_turns']}, kernel "
          f"{k10['ms_turns']}); per call, host enqueue kernel "
          f"{split['kernel']['host_us']:.2f} us vs library "
          f"{split['library']['host_us']:.2f} us, device time kernel "
          f"{split['kernel']['device_us']:.3f} us "
          f"{split['kernel']['device_kernels']} vs library "
          f"{split['library']['device_us']:.3f} us "
          f"{split['library']['device_kernels']}; bound "
          f"{k10_bound['bound_ms']:.6f} ms ({k10_bound['bound_by']}) "
          f"[{card}]")
    repro_launches = run_repro_tool()
    stamp("K3 at 16 x 2048 and the wide walks")
    check_tchunk_kernels(gt, model, ev, TC_KERNEL)
    print(f"kernel K3: B={B_KERNEL} T={T_KERNEL} Tc={TC_KERNEL} forward and "
          f"traceback chunks bit-equal to plain, the chunked decode to "
          f"K1 + K2 [{card}]")
    small = (gt, model, ev)  # K9 takes them again after K3's long phase
    check_ring_wide(models, device, np.random.default_rng(2025))
    print(f"K2, K3's chunks (Tc={TC_WIDE}) and K9's states chunk at "
          f"B={B_WIDE} T={T_WIDE}, lengths 0 to T: bit-equal to their plain "
          f"versions [{card}]")

    stamp("K3 at long-read width")
    gt, model, ev = kernel_inputs(models, device, B_LONG, T_LONG, rng)
    check_tchunk_vs_full_scan(gt, model, ev, TC_LONG)
    k3, decode = time_tchunk_kernels(gt, model, ev, TC_LONG)
    for name, r in k3.items():
        print(f"kernel {name}: B={B_LONG} one chunk of {TC_LONG} events "
              f"bit-equal to plain; {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms [{card}]")
    print(f"kernel K3: B={B_LONG} T={T_LONG} Tc={TC_LONG} decode bit-equal "
          f"to K1 + K2; chunked {decode['chunked_ms']:.3f} ms, full scan "
          f"{decode['full_scan_ms']:.3f} ms [{card}]")
    recs.update(k3)
    stamp("K9")
    t0 = time.perf_counter()
    k1k2 = hmm.viterbi_decode_grouped(*small)
    k9_bound = roofline.seqpar_bound(B_KERNEL, T_KERNEL)
    for D in D_KERNEL:
        for M in (1, D):
            t = check_seqpar(*small, D, M, k1k2, plain=True)
            print(f"K9 (viterbi_decode_seqpar): B={B_KERNEL} T={T_KERNEL} "
                  f"over {D} ranks on one card, n_blocks {M}: path and logp "
                  f"bit-equal to the plain version, logp to K1's, paths to "
                  f"K2's codes; {t['ms']:.3f} ms vs plain "
                  f"{t['plain_ms']:.3f} ms; bound {k9_bound['bound_ms']:.4f} "
                  f"ms ({k9_bound['bound_by']}) [{card}]")
    print(f"K9 at B={B_KERNEL} T={T_KERNEL}: "
          f"{time.perf_counter() - t0:.1f} s")
    del small, k1k2
    t0 = time.perf_counter()
    seq = run_seqpar(gt, model, ev, card)
    print(f"K9 at long-read width: {time.perf_counter() - t0:.1f} s")
    del gt, model, ev
    torch.cuda.empty_cache()
    stamp("the mesh phase")
    t0 = time.perf_counter()
    mesh_rng = np.random.default_rng(2026)
    sp = check_statepar(*kernel_inputs(models, device, B_KERNEL, T_KERNEL,
                                       mesh_rng))
    for name, r in sp.items():
        extra = (f" a launch by CUDA events around each (host enqueue "
                 f"{r['host_us']:.2f} us)" if "host_us" in r
                 else f" (K2's ring on the same rows {r['k2_ms']:.4f} ms)")
        print(f"kernel {name}: B={B_KERNEL} T={T_KERNEL} over 2 ranks, NaN "
              f"inputs, bit-equal to plain; {r['ms']:.4f} ms{extra} vs "
              f"plain {r['plain_ms']:.3f} ms [{card}]")
    print(f"K1m + K2m at B={B_KERNEL} T={T_KERNEL} over {MESH_RANKS} ranks "
          f"on one card, path and score-only, clean and with NaN events, a "
          f"NaN stay entry and a NaN model entry: bit-equal to K1 + K2 and "
          f"(with backpointers, 2 ranks) to their plain versions [{card}]")
    recs.update(sp)
    mesh_run = run_mesh(models, device, card, mesh_rng)
    torch.cuda.empty_cache()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gsp = check_generic_statepar(trans[2], priors[2], *kernel_inputs(
        models, device, B_KERNEL, T_KERNEL, np.random.default_rng(2028)))
    for (form, with_path), r in gsp.pop("per_read_k6a").items():
        print(f"K6a under per-read tables ({form}, "
              f"{'path' if with_path else 'score-only'}): B={B_KERNEL} "
              f"T={T_KERNEL} NaN inputs, bit-equal to plain; {r['ms']:.3f} "
              f"ms vs plain {r['plain_ms']:.3f} ms [{card}]")
    for name, r in gsp.items():
        extra = (f" a launch by CUDA events around each (host enqueue "
                 f"{r['host_us']:.2f} us)" if "host_us" in r
                 else f" (from_idx rule {r['idx_rule_ms']:.4f} ms, K6b's "
                      f"ring on the same rows {r['k6b_ring_ms']:.4f} ms)")
        print(f"kernel {name}: B={B_KERNEL} T={T_KERNEL} over 2 ranks, NaN "
              f"inputs, bit-equal to plain; {r['ms']:.4f} ms{extra} vs "
              f"plain {r['plain_ms']:.3f} ms [{card}]")
    recs.update(gsp)
    generic_mesh = run_generic_mesh(models, device, card,
                                    np.random.default_rng(2029), trans[2],
                                    priors[2])
    torch.cuda.empty_cache()
    print(f"generic mesh phase: {time.perf_counter() - t0:.1f} s")

    stamp("the EM kernels")
    reads = simulated_reads(models, rng)
    inp = em_kernel_inputs(models, reads, device, rng)
    em = check_em_kernels(inp)
    check_em_under_nan(inp)
    print(f"K4 (alphas stored and not) and K5 (all three flag sets) at "
          f"B={4 * G_EM} T={T_EM} with NaN events, a NaN model entry and a "
          f"+inf event: bit-equal to their plain versions [{card}]")
    em.update(check_fwbw_kernels(inp, trans[2], priors[2]))
    print(f"K6d at B={4 * G_EM} T={T_EM} (clean, with NaN events, a +inf "
          f"event and a NaN model entry, and with half the rows of length "
          f"0) and K6e at B={B_KERNEL} T={T_KERNEL} (clean and NaN): "
          f"bit-equal to their plain versions; K6d "
          f"{em['fwbw_grouped_backward']['ms']:.3f} ms on the full chunk, "
          f"{em['fwbw_grouped_backward']['half_idle_ms']:.3f} ms on the "
          f"half-idle one [{card}]")
    t0 = time.perf_counter()
    em.update(check_em_statepar(inp, card))
    print(f"EM state-axis phase: {time.perf_counter() - t0:.1f} s")
    del inp
    torch.cuda.empty_cache()
    dry = run_dryrun(device, card)
    for name, r in em.items():
        turns = f" (in turns: {r['ms_turns']})" if "ms_turns" in r else ""
        print(f"kernel {name}: B={4 * G_EM} T={T_EM} n=4096 bit-equal to "
              f"plain; {r['ms']:.3f} ms{turns} vs plain {r['plain_ms']:.3f} "
              f"ms [{card}]")
    recs.update(em)
    torch.cuda.empty_cache()
    em_s = (em["fwbw_forward"]["ms"] + em["em_backward"]["ms"]) / 1e3
    for against, pk in (("the measured K8 peak at the EM chunk",
                         measure["peaks"][(4 * G_EM, T_EM)]),
                        ("the 67 TFLOP/s spec", None)):
        rep = roofline.em_mfu_report(4 * G_EM * T_EM / em_s, 4096,
                                     fma_peak_ops_per_s=pk)
        print(f"em_mfu_report (K4 + K5 at {4 * G_EM} x T={T_EM}, "
              f"{em_s * 1e3:.3f} ms per round) against {against}: "
              f"{rep['achieved_vpu_ops_per_s'] / 1e12:.3f} TFLOP/s = "
              f"{100 * rep['mfu_vs_fma_peak']:.2f}%; HBM "
              f"{100 * rep['hbm_utilization_vs_spec']:.2f}% of 3.35 TB/s; "
              f"binding {rep['binding_resource']} [{card}]")

    stamp("the end-to-end runs")
    untrained = run_end_to_end(models, reads, device, False,
                               UNTRAINED_KERNELS)
    print_run("untrained (--no-train)", untrained, card)
    trace_dir = os.path.join(ROOT, "build", "chip_smoke", "trace")
    traced = run_end_to_end(models, reads, device, False, UNTRAINED_KERNELS,
                            tag="traced", trace_dir=trace_dir)
    check_trace(trace_dir)
    print_run("untrained inside --trace-dir (torch.profiler)", traced, card)
    trained = run_end_to_end(models, reads, device, True, TRAINED_KERNELS)
    print_run("trained (default)", trained, card)
    trans_trained = run_end_to_end(models, reads, device, True,
                                   TRANS_TRAINED_KERNELS, trans)
    print_run("trained under the loaded table (-s)", trans_trained, card)
    priors_trained = run_end_to_end(models, reads, device, True,
                                    TRANS_TRAINED_KERNELS, priors,
                                    tag="trained_trans_priors")
    print_run("trained under the loaded table of the priors (-s)",
              priors_trained, card)
    for r in (trans_trained, priors_trained):
        assert r["launches"]["fwbw_generic"] == 0, r["launches"]
    trans_untrained = run_end_to_end(models, reads, device, False,
                                     TRANS_UNTRAINED_KERNELS, trans)
    for k in ("viterbi_generic_forward_path", "viterbi_generic_forward_score",
              "viterbi_generic_traceback"):
        assert trans_untrained["launches"][k] == 0, f"the -s run launched {k}"
    print_run("untrained under the loaded table (-s --no-train)",
              trans_untrained, card)
    trans_streaming = run_trans_streaming(models, reads, device, trans)
    print_run("untrained under the loaded table without its packed layout "
              "(FASTA byte-equal)", trans_streaming, card)
    long_reads = simulated_reads(models, rng, specs=LONG_READS,
                                 prefix="long")
    long = run_end_to_end(models, long_reads, device, True, LONG_KERNELS,
                          tag="long")
    for k in ("viterbi_forward_path", "viterbi_traceback"):
        assert long["launches"][k] == 0, f"a long path chunk ran {k}"
    print_run("long reads, trained (default)", long, card)
    stamp("the sharder and two hosts")
    t0 = time.perf_counter()
    sharded = run_sharded(models, reads, device, card)
    multihost_launches = run_multihost(models, reads, device, card)
    print(f"sharder and multihost phases: {time.perf_counter() - t0:.1f} s")
    stamp("the dev tools")
    tool_runs = run_tools(models, trans[0], rng)
    for name, r in tool_runs.items():
        extra = {k: v for k, v in r.items() if k not in ("launches",
                                                          "wall_s")}
        print(f"tool {name}: {r['wall_s']:.3f} s of wall on a read of "
              f"{TOOLS_EVENTS} events {extra}; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} } (fwbw: "
              f"with the -o run on {TOOLS_DUMP_EVENTS} events) [{card}]")
    print("tools: -o matrix dumps give posteriors summing to 1; -K 3 on the "
          "card raised the kernels' ValueError and launched nothing")
    stamp("the training-data dump")
    dump = run_dump(models, reads, device)
    print(f"dump_training_data: {dump['subsequences']} subsequences in "
          f"{dump['wall_s']:.3f} s, invariants hold; launches "
          f"{ {k: v for k, v in dump['launches'].items() if v} } [{card}]")
    print(f"identity mean: trained {trained['identity_mean']:.3f}, "
          f"untrained {untrained['identity_mean']:.3f}; under the loaded "
          f"table trained {trans_trained['identity_mean']:.3f}, untrained "
          f"{trans_untrained['identity_mean']:.3f}; long reads "
          f"{long['identity_mean']:.3f}")

    stamp("the kernels line")
    runs = {"untrained": untrained["launches"], "trained": trained["launches"],
            "trained_trans": trans_trained["launches"],
            "trained_trans_priors": priors_trained["launches"],
            "untrained_trans": trans_untrained["launches"],
            "untrained_trans_streaming": trans_streaming["launches"],
            "long": long["launches"], "traced": traced["launches"],
            **{name: r["launches"] for name, r in tool_runs.items()},
            "dump": dump["launches"], "measure": measure["launches"],
            "repro": repro_launches, "seqpar": seq["launches"],
            "mesh": mesh_run["launches"],
            "generic_mesh": generic_mesh["launches"],
            "dryrun": dry["launches"],
            "sharded_untrained": sharded["untrained"]["launches"],
            "sharded_trained": sharded["trained"]["launches"],
            "multihost": multihost_launches}
    records = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": sum(r[k.name] for r in runs.values()),
                "launches_by_run": {w: r[k.name] for w, r in runs.items()},
                "library_ms": None, **recs[k.name],
                **roofline.kernel_bound(k.name, *recs[k.name]["shape"])}
               for k in kernels.KERNELS]
    assert len(records) == 28 and all(r["launches"] for r in records), \
        {r["name"]: r["launches"] for r in records}
    for r in records:
        shape = tuple(r["shape"])
        r.update(roofline.kernel_shares(r["name"], *shape, r["ms"],
                                        measure["peaks"].get(shape)))
        k8 = (f"{100 * r['share_of_k8_peak']:.2f}% of the K8 peak at that "
              f"shape" if r["share_of_k8_peak"] is not None
              else "K8 not measured at that shape")
        print(f"share {r['name']} at B={shape[0]} T={shape[1]}: "
              f"{r['f32_ops_per_s'] / 1e12:.4f} TFLOP/s = "
              f"{100 * r['share_of_f32_spec']:.3f}% of 67 TFLOP/s, {k8} "
              f"[{card}]")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
