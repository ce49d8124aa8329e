#!/usr/bin/env python3
"""Check the port's multi-device path across every visible NVIDIA GPU.

    python3 tools/torch_multi_gpu.py

It needs two cards or more (it exits 2 with fewer) and

1. launches K1 + K2 and K10 on every card with cuda:0 current: cuda:0
   stays current and a bare "cuda" still allocates there (the C entries
   hand the caller's device back);
2. runs K9 (parallel.seqpar) with one rank per card, at 16 x 2048
   (chip_smoke.py's kernel inputs) with n_blocks 1 and D: path and logp
   bit-equal to its plain version over the same cards and to K1 + K2 on
   cuda:0 (chip_smoke.check_seqpar), with both times; then at 4 x 40,960
   with n_blocks 1 and D against K3's decode on cuda:0, with K9's time over
   the cards beside its time with every rank on cuda:0 and K3's;
3. decodes chip_smoke.py's path chunk (128 x 8,192, pooled_inputs)
   through basecall.decode_chunk_pooled placed by
   parallel.mesh.shard_pooled_decode_inputs on (data, model) meshes of
   distinct cards: (1, 2), and with four cards (2, 2) from make_mesh's
   default device list: path0, codes and logp bit-equal to the unplaced
   decode on cuda:0 (K1 + K2), with one K1m launch a wave and card (its
   exchange at system scope: the peers' column slices and counters read
   in place over peer access) and one K2m a data row, whose ring copies
   the peers' backpointer slices by cp.async.bulk over peer access (the
   check that a bulk copy reads a peer card's memory); each mesh's wall
   beside the same mesh with every rank on cuda:0 and K1 + K2's;
4. runs chip_smoke.py's 24 simulated reads through basecall.run_pipeline,
   untrained and trained, over the default data sharder (every card:
   basecall.default_sharder) and over cuda:0 alone: FASTA byte-equal, stats
   within rtol 2e-3, every card allocated memory in the sharded runs; the
   wall seconds of each run.

Every failure raises; the last line is a JSON summary, after the card line
of nvidia-smi (name and power limit of each card).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def check_current_device(models, n: int) -> None:
    """Kernels launched on every card leave cuda:0 current."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm, repro

    torch.cuda.set_device(0)
    for i in range(n):
        dev = torch.device("cuda", i)
        inputs = chip_smoke.kernel_inputs(models, dev, 4, 256,
                                          np.random.default_rng(i))
        hmm.viterbi_decode_grouped(*inputs)
        repro.reshape_copy(torch.ones((8, 128, 4), device=dev))
        assert torch.cuda.current_device() == 0, i
        assert torch.empty(1, device="cuda").device.index == 0, i
    torch.cuda.synchronize()
    print(f"current device: cuda:0 after launches on each of {n} cards")


def run_seqpar(models, cards, card_line: str) -> dict:
    """Phase 2: K9 with one rank per card."""
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import hmm
    from nanocall_tpu_torch.parallel import seqpar

    D, dev0 = len(cards), cards[0]
    rng = np.random.default_rng(2024)
    small = chip_smoke.kernel_inputs(models, dev0, chip_smoke.B_KERNEL,
                                     chip_smoke.T_KERNEL, rng)
    k1k2 = hmm.viterbi_decode_grouped(*small)
    out = {}
    for M in (1, D):
        t = chip_smoke.check_seqpar(*small, D, M, k1k2, plain=True,
                                    devices=cards)
        out[f"small_M{M}"] = t
        print(f"K9 over {D} cards, B={chip_smoke.B_KERNEL} "
              f"T={chip_smoke.T_KERNEL} n_blocks {M}: bit-equal to the plain "
              f"version and to K1 + K2; {t['ms']:.3f} ms vs plain "
              f"{t['plain_ms']:.3f} ms [{card_line}]")
    del small, k1k2
    B, T, Tc = chip_smoke.B_LONG, chip_smoke.T_LONG, chip_smoke.TC_LONG
    gt, model, ev = chip_smoke.kernel_inputs(models, dev0, B, T, rng)
    k3 = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, Tc)
    for M in (1, D):
        chip_smoke.check_seqpar(gt, model, ev, D, M, k3, plain=False,
                                devices=cards)
    del k3
    k3_ms = chip_smoke.cuda_ms(
        lambda: hmm.viterbi_decode_grouped_tchunk(gt, model, ev, Tc), 1)
    for M in (1, D):
        for where, devs in (("cards", cards), ("one card", [dev0] * D)):
            ms = chip_smoke.cuda_ms(lambda devs=devs, M=M: (
                seqpar.viterbi_decode_seqpar(gt, model, ev, devs, M)), 1)
            out[f"long_M{M}_{where}"] = ms
    torch.cuda.synchronize()
    print(f"K9 at B={B} T={T}, logp bit-equal to K3's: over {D} cards "
          f"{out['long_M1_cards']:.3f} ms (n_blocks 1), "
          f"{out[f'long_M{D}_cards']:.3f} ms (n_blocks {D}); {D} ranks on "
          f"one card {out['long_M1_one card']:.3f} / "
          f"{out[f'long_M{D}_one card']:.3f} ms; K3 {k3_ms:.3f} ms "
          f"[{card_line}]")
    out["k3_ms"] = k3_ms
    return out


def run_mesh(models, cards, card_line: str) -> dict:
    """Phase 3: the state-parallel decode across cards."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.ops import hmm, kernels
    from nanocall_tpu_torch.parallel import mesh, statepar

    B, T = chip_smoke.B_MESH, chip_smoke.T_MESH
    args = chip_smoke.pooled_inputs(models, cards[0], B, T,
                                    np.random.default_rng(2027))
    [ref] = basecall.decode_chunk_pooled(*args)
    ref = {k: v.cpu() for k, v in ref.items()}

    def wall(placed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = basecall.decode_chunk_pooled(*placed)
        for i in range(len(cards)):
            torch.cuda.synchronize(i)
        return time.perf_counter() - t0, out

    k1k2_s, _ = wall(args)
    out = {"k1k2_s": k1k2_s}
    for D, M in ((1, 2), (2, 2)):
        if D * M > len(cards):
            continue
        grid = (mesh.make_mesh(D * M, model_axis=M) if D * M == 4
                else mesh.make_mesh(D * M, model_axis=M, devices=cards))
        assert grid.shape == {"data": D, "model": M}, grid.shape
        kernels.reset_launches()
        s, got = wall(mesh.shard_pooled_decode_inputs(grid, *args))
        waves = sum(len(statepar.plan_waves(B // D, row, {
            d: hmm.forward_wave_resident(d, True, True) for d in row})[row[0]])
            * len(set(row)) for row in grid.devices)
        assert (hmm.forward_wave_kernel.launches,
                hmm.traceback_slices_kernel.launches) == (waves, D), \
            (hmm.forward_wave_kernel.launches, waves)
        assert [o["codes"].device for o in got] == [row[0] for row in
                                                    grid.devices]
        got = mesh.join(got)
        for k in ("path0", "codes", "logp"):
            assert torch.equal(chip_smoke.bits(got[k]),
                               chip_smoke.bits(ref[k])), (D, M, k)
        one = mesh.make_mesh(D * M, model_axis=M,
                             devices=[cards[0]] * (D * M))
        s_one, _ = wall(mesh.shard_pooled_decode_inputs(one, *args))
        out[f"mesh_{D}x{M}_s"], out[f"mesh_{D}x{M}_one_card_s"] = s, s_one
        print(f"mesh ({D}, {M}) over {D * M} cards, B={B} T={T}: path0, "
              f"codes and logp bit-equal to K1 + K2 on cuda:0; {s:.3f} s of "
              f"wall vs {s_one:.3f} s with every rank on cuda:0 and K1 + K2 "
              f"{k1k2_s:.3f} s [{card_line}]")
    return out


def run_sharded(models, cards, card_line: str) -> dict:
    """Phase 4: the pipeline over every card against cuda:0 alone."""
    import numpy as np
    import torch

    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.parallel import mesh

    reads = chip_smoke.simulated_reads(models, np.random.default_rng(7))
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    walls = {}
    for train, kernels_, tag in (
            (False, chip_smoke.UNTRAINED_KERNELS, "untrained"),
            (True, chip_smoke.TRAINED_KERNELS, "trained")):
        sharder = basecall.default_sharder(chip_smoke.smoke_config(), "cuda")
        assert sharder.devices == cards, sharder.devices
        for where, sh in (("one", mesh.DataSharder(devices=cards[:1])),
                          ("all", sharder)):
            for i in range(len(cards)):
                torch.cuda.reset_peak_memory_stats(i)
            r = chip_smoke.run_end_to_end(models, reads, cards[0], train,
                                          kernels_, tag=f"mg_{tag}_{where}",
                                          sharder=sh)
            peaks = [torch.cuda.max_memory_allocated(i)
                     for i in range(len(cards))]
            if where == "all":
                assert all(peaks), peaks
            walls[f"{tag}_{where}"] = r["wall_s"]
            print(f"{tag} over {where} of {len(cards)} cards: "
                  f"{r['wall_s']:.3f} s, {r['records']} records, identity "
                  f"mean {r['identity_mean']:.3f}, peak GiB per card "
                  f"{[round(p / 2**30, 3) for p in peaks]} [{card_line}]")
    paths = {k: os.path.join(out_dir, f"mg_{k}") for k in walls}
    with open(paths["untrained_one"] + ".fa", "rb") as a, \
            open(paths["untrained_all"] + ".fa", "rb") as b:
        assert a.read() == b.read(), "the sharded untrained FASTA differs"
    chip_smoke.stats_close(paths["trained_one"] + ".tsv",
                           paths["trained_all"] + ".tsv", 2e-3)
    print("sharder over every card: untrained FASTA byte-equal, trained "
          "stats within rtol 2e-3")
    return walls


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_multi_gpu: needs two CUDA devices or more, found {n}",
              file=sys.stderr)
        return 2
    from nanocall_tpu_torch import cli
    from nanocall_tpu_torch.ops import _cuda

    card_line = chip_smoke.smi_line().replace("\n", "; ")
    print(card_line)
    _cuda.load()
    cards = [torch.device("cuda", i) for i in range(n)]
    models = cli.init_models(chip_smoke.smoke_config())
    check_current_device(models, n)
    seq = run_seqpar(models, cards, card_line)
    mesh_walls = run_mesh(models, cards, card_line)
    walls = run_sharded(models, cards, card_line)
    print(card_line)
    print(json.dumps({"ok": True, "cards": n, "seqpar": seq,
                      "mesh": mesh_walls, "pipeline_wall_s": walls}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_multi_gpu: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
