#!/usr/bin/env python3
"""Smoke run of nanocall_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It

  1. prints the card (nvidia-smi name and power limit), and the CUDA and
     nvcc versions;
  2. builds the CUDA kernels from nanocall_tpu_torch/csrc and prints the
     build seconds and ptxas' register / spill report;
  3. writes the 21-neighbour transition table of (p_stay 0.14, p_skip
     0.21) as a transitions TSV and loads it back through the port CLI's
     `-s/--trans` loader: the loaded table of the r73 width, in-degree 21;
  4. runs each decode kernel on the card at the decode's full width
     (n = 4096 states, B = 16 reads of up to T = 2048 events, lengths from
     0 to T, per-read scaling and transitions): the grouped K1 (path and
     score-only) and K2, and under the loaded table the generic K6a (path
     and score-only) and K6b; holds each to its plain PyTorch version on
     the same inputs: tolerance 0, every output bit-equal; prints both
     times; then K3, the chunked-time decode's forward and traceback
     kernels, at the same shape in chunks of 600 events (a short last
     chunk): each chunk's outputs against the plain versions (tolerance 0)
     and the chunked decode against K1 + K2 (path0, codes, logp
     bit-equal);
  5. runs K3 at long-read widths, B = 4 reads x T = 40,960 events in chunks
     of 8,192: the chunked decode bit-equal to K1 + K2 (the plain versions
     would take minutes there; they are held to K1/K2's above), one
     chunk (events [8192, 16384)) against its plain versions on the same
     carry (tolerance 0) with both times, and both decodes' times;
  6. runs the EM kernels at the EM chunk's full width: n = 4096, 128
     training groups x 4 = 512 rows of T = 128 events, packed by
     nanocall_tpu_torch.basecall.pack_train_batch from the simulated reads
     below, with rows of length 0, 1, T-1 and T, invalid rows, both r73
     strands' models and varied scaling and transition parameters: K4
     forward, with and without the alpha store; K5 fused backward with all
     statistics, with train_transitions off and with train_scaling off;
     K6d, the grouped backward with its betas stored; and K6c, the generic
     forward-backward under the loaded table (alpha, beta and em of
     3 x 1.07 GB); holds each to its plain version (tolerance 0) and prints
     both times;
  7. drives the pipeline end to end (nanocall_tpu_torch.basecall.
     run_pipeline, `--pore r73 -t 1`) on 24 simulated reads (1D reads of
     2,000-8,000 events and 2-strand hairpin reads of 3,000 + 3,000, fed as
     in-memory event arrays through nanocall_tpu_torch.ingest, since fast5
     reading needs h5py) and writes FASTA and stats with the port CLI's
     writer into build/chip_smoke/, four times: untrained (`--no-train`;
     K1 path and score-only, K2); the default trained run (EM training,
     then the decode; K4, K5, K1, K2); trained under the loaded table
     (`-s`: legacy EM rounds with K4, K6d and K6c, then the decode of the
     trained tasks by K1 and K2); and untrained under it (`-s --no-train`:
     every task at the priors, so K6a path and score-only, and K6b).  Each
     run checks one FASTA record per decoded strand, identity to the
     simulated truth above 0.6, and that each of its kernels launched; a
     trained run also checks that every trained 1D read's best candidate
     has 0.8 < scale < 1.2 and |shift| < 10 (the reads are simulated at
     identity scaling); each prints its stage times and peak device memory;
  8. a fifth run, "long": the default trained run on 4 long reads (1D
     reads of 33,000, 60,000 and 99,000 events, a hairpin read of 40,000 +
     40,000), whose path chunks all take the chunked decode: it must
     launch K4, K5 and both K3 kernels, and neither K1 with backpointers
     nor K2;
  9. prints a JSON line of the kernels (launch counts: the end-to-end
     runs' sum, and each run's; each kernel's time, its plain version's,
     its shape and its bound on the H100's published peaks), the card
     line, and last {"ok": true, ...}.

The script imports nothing of JAX and nothing of the JAX package
nanocall_tpu: it reaches the system only through nanocall_tpu_torch, and
simulates its reads itself.  Nothing is caught: any failure exits non-zero
before the last line.  With no CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import difflib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_KERNEL, T_KERNEL = 16, 2048
TC_KERNEL = 600  # K3's chunk at the kernel phase's shape: a short last chunk
B_LONG, T_LONG, TC_LONG = 4, 40960, 8192  # K3 at long-read widths
#: the long run's reads: (2-strand, events per strand)
LONG_READS = ((False, 33000), (False, 60000), (False, 99000), (True, 40000))
G_EM, T_EM = 128, 128  # the default EM chunk: 128 groups x 4 rows, T = 128
N_1D, N_2STRAND = 18, 6
P_STAY, P_SKIP = 0.1, 0.3  # the simulated reads' kinetics (the defaults)
NOISE = 0.5  # the simulated event means' noise, in model level stdvs
IDENTITY_MIN = 0.6  # tests/test_pipeline.py's bar for untrained decodes
IDENTITY_WINDOW = 2000  # called bases compared per strand (difflib is quadratic)
#: kernels each end-to-end run must launch
UNTRAINED_KERNELS = ("viterbi_forward_path", "viterbi_forward_score",
                     "viterbi_traceback")
TRAINED_KERNELS = ("fwbw_forward", "em_backward", "viterbi_forward_path",
                   "viterbi_traceback")
TRANS_TRAINED_KERNELS = ("fwbw_forward", "fwbw_grouped_backward",
                         "fwbw_generic", "viterbi_forward_path",
                         "viterbi_traceback")
TRANS_UNTRAINED_KERNELS = ("viterbi_generic_forward_path",
                           "viterbi_generic_forward_score",
                           "viterbi_generic_traceback")
LONG_KERNELS = ("fwbw_forward", "em_backward", "viterbi_forward_chunk",
                "viterbi_traceback_chunk")
#: the loaded table's kinetics: not the CLI priors (0.1, 0.3), so a task
#: routed to the wrong kernel would decode under other transitions
TRANS_P_STAY, TRANS_P_SKIP = 0.14, 0.21


#: the H100 SXM's published peaks: HBM3 bytes/s, float32 operations/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: float32 operations per (event, state) cell, counted from each kernel's
#: source: the emission is 18 (log_emission's subtractions, divisions,
#: products and sums); K1's step adds 3 sums, 2 maxima, 3 equality tests,
#: the column maxima (3/4 + 15/16 comparisons) and the update; K4 and K6d
#: the max, exp, block sums, the 11-operation correction and log; K5 K6d's
#: recursion plus the posterior (3) and 14 moments and 3 log totals (about
#: 37); K6a a sum and a max per slot (21 slots) and 21 equality tests; K6c
#: 5 per slot and pass (sum, max, difference, exp, sum) over both passes
CELL_OPS = {
    "viterbi_forward_path": 28.6875, "viterbi_forward_score": 28.6875,
    "viterbi_forward_chunk": 28.6875, "fwbw_forward": 36.6875,
    "fwbw_grouped_backward": 37.6875, "em_backward": 77.6875,
    "viterbi_generic_forward_path": 82.0,
    "viterbi_generic_forward_score": 61.0, "fwbw_generic": 235.0,
}


def bound(name: str, B: int, T: int, deg: int = 21) -> dict:
    """{"bound_ms", "bound_by"}: the least time the card could take for one
    call of kernel `name` on B rows of T events (for a chunk kernel, T is
    the chunk's events) at n = 4096 states: the larger of the bytes it
    must move (each input read once, each output written once; a
    traceback reads one backpointer byte per event) over the memory rate,
    and its float32 operations over the float32 rate."""
    n = 4096
    cells = B * T * n
    ev = 12 * B * T + 4 * B  # mean, stdv, log_stdv, length
    codes = 3 * B * (-(-(T - 1) // 4))
    nbytes = {
        "viterbi_forward_path": ev + 40 * B * n + (T - 1) * B * n,
        "viterbi_forward_score": ev + 40 * B * n,
        "viterbi_forward_chunk": ev + 44 * B * n + T * B * n,
        "viterbi_traceback": 4 * B * n + B * (T - 1) + 12 * B + codes,
        "viterbi_traceback_chunk": B * T + 16 * B + 3 * B * T // 4,
        "fwbw_forward": ev + 36 * B * n + n + 4 * T * B * n + 4 * B,
        "em_backward": ev + 4 * T * B * n + 60 * B * n,
        "fwbw_grouped_backward": ev + 36 * B * n + n + 4 * T * B * n,
        "viterbi_generic_forward_path": (ev + 28 * B * n + 8 * deg * n
                                         + (T - 1) * B * n),
        "viterbi_generic_forward_score": ev + 28 * B * n + 8 * deg * n,
        "viterbi_generic_traceback": (4 * B * n + 5 * B * (T - 1) + 8 * B
                                      + 2 * B * T),
        "fwbw_generic": ev + 24 * B * n + 16 * deg * n + 12 * T * B * n,
    }[name]
    ops = CELL_OPS.get(name, 0.0) * cells
    if name in ("viterbi_traceback", "viterbi_generic_traceback"):
        ops = B * n  # the end state's argmax
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def load_trans_table(device):
    """The 21-neighbour table of (TRANS_P_STAY, TRANS_P_SKIP), written as a
    transitions TSV and loaded back by the port CLI's `-s` loader: (the TSV
    path, the loaded table, its TransOps on `device`)."""
    from nanocall_tpu_torch import cli, convert

    path = os.path.join(ROOT, "build", "chip_smoke", "trans.tsv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    convert.write_fast_transitions(path, TRANS_P_STAY, TRANS_P_SKIP)
    table = cli.init_transitions(smoke_config("-s", path))
    ops = convert.trans_ops(table, device)
    assert tuple(ops.from_idx.shape) == (21, 4096), ops.from_idx.shape
    return path, table, ops


def check_generic_kernels(ops, model, ev) -> dict:
    """K6a (path and score-only) and K6b against their plain versions on
    the same card under the loaded table: bit-equal outputs (tolerance 0)
    and times.  Returns {kernel name: record}."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    lengths = ev["length"]
    fa_p, bps_p = hmm.viterbi_forward_plain(ops, model, ev, True)
    fa_k, bps_k = hmm.generic_forward_path_kernel(ops, model, ev)
    fa_s = hmm.generic_forward_score_kernel(ops, model, ev)
    torch.cuda.synchronize()
    assert torch.equal(fa_k, fa_p), "K6a final alpha differs from plain"
    assert torch.equal(bps_k, bps_p), "K6a backpointers differ from plain"
    assert torch.equal(fa_s, fa_p), "K6a score-only alpha differs from plain"
    path_p, logp_p = hmm.viterbi_traceback_plain(ops, fa_p, bps_p, lengths)
    path_k, logp_k = hmm.generic_traceback_kernel(ops, fa_k, bps_k, lengths)
    torch.cuda.synchronize()
    assert torch.equal(path_k, path_p), "K6b path differs from plain"
    assert torch.equal(logp_k, logp_p), "K6b logp differs from plain"
    return with_shape({
        "viterbi_generic_forward_path": {
            "max_abs_err": max_err(fa_k, fa_p),
            "ms": cuda_ms(lambda: hmm.generic_forward_path_kernel(
                ops, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_forward_plain(
                ops, model, ev, True), 1)},
        "viterbi_generic_forward_score": {
            "max_abs_err": max_err(fa_s, fa_p),
            "ms": cuda_ms(lambda: hmm.generic_forward_score_kernel(
                ops, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_forward_plain(
                ops, model, ev, False), 1)},
        "viterbi_generic_traceback": {
            "max_abs_err": max_err(logp_k, logp_p),
            "ms": cuda_ms(lambda: hmm.generic_traceback_kernel(
                ops, fa_k, bps_k, lengths), 3),
            "plain_ms": cuda_ms(lambda: hmm.viterbi_traceback_plain(
                ops, fa_p, bps_p, lengths), 1)},
    }, ev)


def max_err(a, b) -> float:
    """Largest |a - b|, counting equal values (infinities included) as 0."""
    import torch

    same = a == b
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
    return train.round_inputs(*batch, K=6)


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


def check_fwbw_kernels(inp, ops) -> dict:
    """K6d (the grouped backward, betas stored) and K6c (the generic
    forward-backward under the loaded table) against their plain versions
    on the same card, at the EM chunk's shape: outputs bit-equal
    (tolerance 0), and times.  Returns {kernel name: record}."""
    import torch

    from nanocall_tpu_torch.ops import hmm

    gtf, model, ev = inp["gtf"], inp["model"], inp["ev"]
    b_p = hmm.fwbw_grouped_backward_plain(gtf, model, ev)
    b_k = hmm.fwbw_backward_kernel(gtf, model, ev)
    torch.cuda.synchronize()
    errs = {"K6d beta": max_err(b_k, b_p)}
    del b_p, b_k
    f_p = hmm.fwbw_plain(ops, model, ev)
    f_k = hmm.fwbw_generic_kernel(ops, model, ev)
    torch.cuda.synchronize()
    for k in ("alpha", "beta", "em", "log_pr_data"):
        errs[f"K6c {k}"] = max_err(f_k[k], f_p[k])
    assert torch.isfinite(f_k["log_pr_data"]).all(), "K6c lpd not finite"
    del f_p, f_k
    print(f"fwbw kernels: max |kernel - plain| {errs}")
    for what, e in errs.items():
        assert e == 0.0, f"{what} differs from plain by {e}"
    return with_shape({
        "fwbw_grouped_backward": {
            "max_abs_err": errs["K6d beta"],
            "ms": cuda_ms(lambda: hmm.fwbw_backward_kernel(gtf, model, ev),
                          3),
            "plain_ms": cuda_ms(lambda: hmm.fwbw_grouped_backward_plain(
                gtf, model, ev), 1)},
        "fwbw_generic": {
            "max_abs_err": max(v for k, v in errs.items() if "K6c" in k),
            "ms": cuda_ms(lambda: hmm.fwbw_generic_kernel(ops, model, ev), 3),
            "plain_ms": cuda_ms(lambda: hmm.fwbw_plain(ops, model, ev), 1)},
    }, ev)


def _walk(n: int, rng):
    """(states (n,), bases): a stay/step/skip walk over 6-mers and the bases
    it reads.  A step appends one random base to the sequence, a skip two,
    and state i is the 6-mer ending at the walk's position after event i
    (most significant base first, A, C, G, T = 0..3)."""
    import numpy as np

    u = rng.random(n)
    moves = np.where(u < P_STAY, 0, np.where(u < 1.0 - P_SKIP, 1, 2))
    moves[0] = 0
    new = rng.integers(0, 4, (n, 2))
    seq = np.concatenate([rng.integers(0, 4, 6),
                          new[np.arange(2) < moves[:, None]]])
    L = len(seq)
    kmers = sum(seq[j:L - 5 + j] << 2 * (5 - j) for j in range(6))
    return kmers[np.cumsum(moves)], "".join(np.array(list("ACGT"))[seq])


def _emit(model, states, rng):
    """Event means and stdvs drawn from a pore model at identity scaling:
    normal means with NOISE x the level stdv, inverse-Gaussian stdvs."""
    import numpy as np

    mean = rng.normal(model.level_mean[states],
                      NOISE * model.level_stdv[states])
    stdv = np.maximum(rng.wald(model.sd_mean[states],
                               model.sd_lambda[states]), 0.05)
    return mean, stdv


def simulate_read(models, rng, n_events: int, two_strand: bool):
    """One read's event-detection arrays and its strands' true bases:
    (mean, stdv, start, length, [template bases, complement bases]).
    70 events of random r73 template signal pad each end; a 2-strand read
    has its complement after an 8-event abasic hairpin at 110 pA; event
    lengths are 10..39 samples."""
    import numpy as np

    tmpl, comp = models["r73.t.006"], models["r73.c.p1.006"]
    parts = [_emit(tmpl, rng.integers(0, 4096, 70), rng)]
    truths = []
    for strand, model in enumerate((tmpl, comp) if two_strand else (tmpl,)):
        if strand:
            parts.append((rng.normal(110.0, 0.5, 8), rng.uniform(0.3, 0.8, 8)))
        states, bases = _walk(n_events, rng)
        parts.append(_emit(model, states, rng))
        truths.append(bases)
    parts.append(_emit(tmpl, rng.integers(0, 4096, 70), rng))
    mean = np.maximum(np.concatenate([p[0] for p in parts]), 1.0)
    stdv = np.concatenate([p[1] for p in parts])
    length = rng.integers(10, 40, len(mean)).astype(np.float64)
    start = np.concatenate([[0.0], np.cumsum(length)[:-1]])
    return mean, stdv, start, length, truths


def simulated_reads(models, rng, n_1d: int = N_1D,
                    n_2strand: int = N_2STRAND, specs=None,
                    prefix: str = "sim"):
    """[(name, EdEventData, [true bases per strand])]: n_1d 1D reads of
    2,000-8,000 events and n_2strand 2-strand hairpin reads of 3,000 +
    3,000, or the reads of specs, (2-strand, events per strand) each."""
    from nanocall_tpu_torch import ingest

    reads = []
    if specs is None:
        specs = ([(False, int(n)) for n in rng.integers(2000, 8001, n_1d)]
                 + [(True, 3000)] * n_2strand)
    for i, (two_strand, n) in enumerate(specs):
        name = f"{prefix}{i:02d}"
        mean, stdv, start, length, truths = simulate_read(models, rng, n,
                                                          two_strand)
        ed = ingest.ed_from_arrays(mean, stdv, start, length, 4000.0, name)
        reads.append((name, ed, truths))
    return reads


def identity(a: str, b: str) -> float:
    """difflib's similarity ratio of two base sequences."""
    return difflib.SequenceMatcher(None, a, b, autojunk=False).ratio()


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
                   trans=None, tag: str = "") -> dict:
    """run_pipeline over the reads, untrained (`--no-train`) or with the
    default EM training, under the loaded table when `trans` (the TSV
    path and the table load_trans_table returns), with FASTA and stats
    written by the port CLI's writer into build/chip_smoke/<tag>; checks
    the records, identity and launches."""
    import torch

    from nanocall_tpu_torch import basecall, cli, read_pipeline
    from nanocall_tpu_torch.ops import kernels

    name = tag or (("trained" if train else "untrained")
                   + ("_trans" if trans else ""))
    out = os.path.join(ROOT, "build", "chip_smoke", name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cfg = smoke_config("-o", out + ".fa", "--stats", out + ".tsv",
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
    summaries, results = basecall.run_pipeline(
        stream(), models, cfg, device, timer=timer,
        default_transitions=trans[1] if trans else None)
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
        idents.append(identity(seq[:IDENTITY_WINDOW], truth[:w]))
    events = sum(decoded.values())
    assert min(idents) > IDENTITY_MIN, idents
    return {"reads": len(reads), "records": len(fasta), "events": events,
            "wall_s": wall, "events_per_s": events / wall,
            "stages": timer.stages, "identity_min": min(idents),
            "identity_mean": sum(idents) / len(idents),
            "launches": launches, "peak_gib": peak / 2**30}


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

    from nanocall_tpu_torch import cli
    from nanocall_tpu_torch.ops import _cuda, kernels

    device = torch.device("cuda", 0)
    card = smi_line()
    print(card)
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

    models = cli.init_models(smoke_config())
    t0 = time.perf_counter()
    trans = load_trans_table(device)
    print(f"transitions: 21-neighbour table of p_stay {TRANS_P_STAY}, "
          f"p_skip {TRANS_P_SKIP} written and loaded back in "
          f"{time.perf_counter() - t0:.2f} s; from_idx "
          f"{tuple(trans[2].from_idx.shape)}")
    rng = np.random.default_rng(2024)
    gt, model, ev = kernel_inputs(models, device, B_KERNEL, T_KERNEL, rng)
    recs = check_kernels(gt, model, ev)
    recs.update(check_generic_kernels(trans[2], model, ev))
    for name, r in recs.items():
        print(f"kernel {name}: B={B_KERNEL} T={T_KERNEL} n=4096 bit-equal to "
              f"plain; {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms "
              f"[{card}]")
    check_tchunk_kernels(gt, model, ev, TC_KERNEL)
    print(f"kernel K3: B={B_KERNEL} T={T_KERNEL} Tc={TC_KERNEL} forward and "
          f"traceback chunks bit-equal to plain, the chunked decode to "
          f"K1 + K2 [{card}]")
    del gt, model, ev

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
    del gt, model, ev
    torch.cuda.empty_cache()

    reads = simulated_reads(models, rng)
    inp = em_kernel_inputs(models, reads, device, rng)
    em = check_em_kernels(inp)
    em.update(check_fwbw_kernels(inp, trans[2]))
    del inp
    for name, r in em.items():
        print(f"kernel {name}: B={4 * G_EM} T={T_EM} n=4096 bit-equal to "
              f"plain; {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms "
              f"[{card}]")
    recs.update(em)
    torch.cuda.empty_cache()

    untrained = run_end_to_end(models, reads, device, False,
                               UNTRAINED_KERNELS)
    print_run("untrained (--no-train)", untrained, card)
    trained = run_end_to_end(models, reads, device, True, TRAINED_KERNELS)
    print_run("trained (default)", trained, card)
    trans_trained = run_end_to_end(models, reads, device, True,
                                   TRANS_TRAINED_KERNELS, trans)
    print_run("trained under the loaded table (-s)", trans_trained, card)
    trans_untrained = run_end_to_end(models, reads, device, False,
                                     TRANS_UNTRAINED_KERNELS, trans)
    print_run("untrained under the loaded table (-s --no-train)",
              trans_untrained, card)
    long_reads = simulated_reads(models, rng, specs=LONG_READS,
                                 prefix="long")
    long = run_end_to_end(models, long_reads, device, True, LONG_KERNELS,
                          tag="long")
    for k in ("viterbi_forward_path", "viterbi_traceback"):
        assert long["launches"][k] == 0, f"a long path chunk ran {k}"
    print_run("long reads, trained (default)", long, card)
    print(f"identity mean: trained {trained['identity_mean']:.3f}, "
          f"untrained {untrained['identity_mean']:.3f}; under the loaded "
          f"table trained {trans_trained['identity_mean']:.3f}, untrained "
          f"{trans_untrained['identity_mean']:.3f}; long reads "
          f"{long['identity_mean']:.3f}")

    runs = {"untrained": untrained["launches"], "trained": trained["launches"],
            "trained_trans": trans_trained["launches"],
            "untrained_trans": trans_untrained["launches"],
            "long": long["launches"]}
    records = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": sum(r[k.name] for r in runs.values()),
                "launches_by_run": {w: r[k.name] for w, r in runs.items()},
                **recs[k.name], **bound(k.name, *recs[k.name]["shape"]),
                "library_ms": None} for k in kernels.KERNELS]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
