#!/usr/bin/env python3
"""Smoke run of nanocall_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

from the root of a checkout.  It

  1. prints the card (nvidia-smi name and power limit), the CUDA and nvcc
     versions, and whether the native host library built;
  2. builds the CUDA kernels from nanocall_tpu_torch/csrc and prints the
     build seconds and ptxas' register / spill report;
  3. runs each kernel on the card at the decode's full width (n = 4096
     states, B = 16 reads of up to T = 2048 events, lengths from 0 to T,
     per-read scaling and transitions) and holds it to its plain PyTorch
     version on the same inputs: tolerance 0, every output bit-equal;
     prints both times;
  4. drives the untrained decode end to end (nanocall_tpu_torch.basecall.
     run_pipeline with the flags `--no-train --pore r73 -t 1`) on 24
     simulated reads: 1D reads of 2,000-8,000 events and 2-strand hairpin
     reads of 3,000 + 3,000, whose complement strands go through model
     contests; the reads enter as in-memory event arrays
     (nanocall_tpu_torch.ingest), since fast5 reading needs h5py.  It checks
     one FASTA record per decoded strand, identity to the simulated truth,
     and that every kernel was launched by that run;
  5. prints a JSON line of the kernels, the card line, and last
     {"ok": true, "device": {...}}.

Nothing is caught: any failure exits non-zero before the last line.  With
no CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_KERNEL, T_KERNEL = 16, 2048
N_1D, N_2STRAND = 18, 6
IDENTITY_MIN = 0.6  # tests/test_pipeline.py's bar for untrained decodes
IDENTITY_WINDOW = 2000  # called bases compared per strand (difflib is quadratic)


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
    return rec


def simulated_reads(models, rng, n_1d: int = N_1D,
                    n_2strand: int = N_2STRAND):
    """[(name, EdEventData, truth)]: n_1d 1D reads of 2,000-8,000 events
    and n_2strand 2-strand hairpin reads of 3,000 + 3,000."""
    from nanocall_tpu import simulate
    from nanocall_tpu_torch import ingest

    reads = []
    specs = ([(None, int(n)) for n in rng.integers(2000, 8001, n_1d)]
             + [("r73.c.p1.006", 3000)] * n_2strand)
    for i, (comp, n) in enumerate(specs):
        name = f"sim{i:02d}"
        mean, stdv, start, length, truth = simulate.simulate_read(
            models, "r73.t.006", comp, n, rng, noise_scale=0.5)
        ed = ingest.ed_from_arrays(mean, stdv, start, length, 4000.0, name)
        reads.append((name, ed, truth))
    return reads


def run_end_to_end(models, reads, device) -> dict:
    from nanocall_tpu import output, simulate
    from nanocall_tpu_torch import basecall, cli, ingest
    from nanocall_tpu_torch.ops import hmm

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["sim", "--no-train", "--pore", "r73", "-t", "1"]))
    decoded = {}  # strands the decode must write, with their event counts

    def stream():
        for name, ed, _ in reads:
            s, evs = ingest.summarize_ed(f"{name}.fast5", ed, models, cfg)
            if s.num_ed_events:
                for st in (0, 1):
                    if len(evs[st]) >= cfg.min_ed_events:
                        decoded[(name, st)] = len(evs[st])
            yield s, evs

    hmm.reset_launches()
    t0 = time.perf_counter()
    summaries, results = basecall.run_pipeline(stream(), models, cfg, device)
    wall = time.perf_counter() - t0
    launches = {k.name: k.wrapper.launches for k in hmm.KERNELS}

    fasta = io.StringIO()
    output.write_results_fasta(fasta, results, cfg.fasta_line_width)
    n_records = fasta.getvalue().count(">")
    assert len(summaries) == len(reads)
    assert decoded, "no strand was decodable"
    assert n_records == len(decoded), (n_records, sorted(decoded))
    assert {(r.seq_name.split(":")[0], r.strand) for r in results} == \
        set(decoded)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched by the end-to-end run"

    truths = {name: truth for name, _, truth in reads}
    idents = []
    for r in results:
        truth = truths[r.seq_name.split(":")[0]].base_seqs[r.strand]
        assert len(r.path) == len(r.ev) and r.base_seq
        # the same stretch of both: the truth's window scaled by the lengths
        w = round(IDENTITY_WINDOW * len(truth) / len(r.base_seq))
        idents.append(simulate.identity(r.base_seq[:IDENTITY_WINDOW],
                                        truth[:w]))
    events = sum(decoded.values())
    return {"reads": len(reads), "records": n_records, "events": events,
            "wall_s": wall, "events_per_s": events / wall,
            "identity_min": min(idents),
            "identity_mean": sum(idents) / len(idents),
            "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from nanocall_tpu import native
    from nanocall_tpu.models import load_builtin_models
    from nanocall_tpu_torch.ops import _cuda, hmm

    device = torch.device("cuda", 0)
    card = smi_line()
    print(card)
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; nvcc: "
          f"{[l for l in nvcc.splitlines() if 'release' in l][0]}; "
          f"native.available()={native.available()}")

    t0 = time.perf_counter()
    _cuda.load()
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load "
          f"(nvcc {_cuda.build_seconds:.2f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    models = load_builtin_models("r73")
    rng = np.random.default_rng(2024)
    gt, model, ev = kernel_inputs(models, device, B_KERNEL, T_KERNEL, rng)
    recs = check_kernels(gt, model, ev)
    for name, r in recs.items():
        print(f"kernel {name}: B={B_KERNEL} T={T_KERNEL} n=4096 bit-equal to "
              f"plain; {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms "
              f"[{card}]")
    del gt, model, ev
    torch.cuda.empty_cache()

    e2e = run_end_to_end(models, simulated_reads(models, rng), device)
    print(f"end_to_end: {e2e['reads']} reads, {e2e['records']} FASTA records, "
          f"{e2e['events']} events in {e2e['wall_s']:.3f} s = "
          f"{e2e['events_per_s']:.0f} events/s; identity min "
          f"{e2e['identity_min']:.3f} mean {e2e['identity_mean']:.3f} "
          f"(first {IDENTITY_WINDOW} bases); launches {e2e['launches']} "
          f"[{card}]")
    assert e2e["identity_min"] > IDENTITY_MIN, e2e

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": e2e["launches"][k.name],
                **recs[k.name]} for k in hmm.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
