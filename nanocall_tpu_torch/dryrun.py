"""The port's multi-device dry run (nanocall_tpu's __graft_entry__.py:68-191,
dryrun_multichip), step by step with the same shapes and seeds:

    python -m nanocall_tpu_torch.dryrun [N]

on a (data, model) mesh of N devices (default: every visible GPU; without
one it raises), model axis 2 where N is even:

  1. one fused EM round of G = 2 D groups (S = 4, T = 16, the r73 template
     model) placed by mesh.shard_train_inputs and run by
     statepar.train_one_round_placed (K4m, K5m): fit finite, and every
     output bit-equal to the unplaced train.train_one_round on the first
     device;
  2. the generic decode of B = 2 D reads of 32 events under the structured
     table, placed by mesh.shard_decode_inputs (K6am, K6bm);
  3. the production decode, basecall.decode_chunk_pooled on
     mesh.shard_pooled_decode_inputs' placement (K1m, K2m);
  4. K9, the decode with its time axis over all N devices, path and logp
     bit-equal to the one-device grouped decode;
  5. the sharded pipeline: simulated reads, fed in memory through
     ingest.ed_from_arrays (no fast5 file, so no h5py), decoded by
     basecall.run_pipeline unsharded and over a DataSharder of the N
     devices: FASTA byte-equal.

Its last line is the summary `dryrun_multichip ok: mesh=... train G=...
decode B=... pooled_decode B=... seqpar_exact=True
pipeline_fasta_equal=True`.  A device may repeat ([cuda:0] * 4 runs every
rank on one card; the tests pass [cpu] * 8, which runs the plain
versions).  Nothing of JAX or nanocall_tpu is imported.
"""

from __future__ import annotations

import io
import sys

import numpy as np
import torch

from . import basecall, convert, output, read_pipeline, simulate, train, \
    transitions
from .config import Config
from .ingest import ed_from_arrays
from .models import load_builtin_models
from .ops import hmm
from .parallel import mesh as mesh_mod
from .parallel import seqpar, statepar


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _train_round(grid, devices, models, rng) -> int:
    """Step 1: the placed EM round against the unplaced one."""
    G, S, T = grid.shape["data"] * 2, 4, 16
    stdv = rng.uniform(0.5, 1.5, (G, S, T)).astype(np.float32)
    ev = {
        "mean": rng.uniform(40.0, 90.0, (G, S, T)).astype(np.float32),
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "start": np.cumsum(
            rng.uniform(0.01, 0.05, (G, S, T)).astype(np.float32), axis=-1),
        "length": np.full((G, S), T, np.int32),
        "strand": np.tile(np.array([0, 0, 1, 1], np.int32), (G, 1)),
        "valid": np.ones((G, S), bool),
    }
    pm = models["r73.t.006"]
    mdl = {k: np.tile(getattr(pm, k), (G, 2, 1)).astype(np.float32)
           for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")}
    pm0 = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (G, 1))
    st0 = np.tile(np.array([0.1, 0.3], np.float32), (G, 2, 1))
    first = devices[0]
    ev_t, mdl_t = _tensors(ev, first), _tensors(mdl, first)
    pm_t, st_t = (torch.from_numpy(x).to(first) for x in (pm0, st0))
    out = mesh_mod.join(statepar.train_one_round_placed(
        *mesh_mod.shard_train_inputs(grid, ev_t, mdl_t, pm_t, st_t), K=6))
    assert torch.isfinite(out["fit"]).all(), out["fit"]
    want = train.train_one_round(ev_t, mdl_t, pm_t, st_t, K=6)
    for k, v in want.items():
        assert torch.equal(_bits(out[k]), _bits(v.cpu())), \
            f"the placed round's {k} differs from the unplaced round's"
    return G


def _decode_inputs(B: int, T: int, seed: int, device):
    """__graft_entry__.py:6-23's inputs: the structured table of the
    priors at K = 6, the r73 template model as one row, B reads of T
    uniform events."""
    rng = np.random.default_rng(seed)
    pm = load_builtin_models("r73")["r73.t.006"]
    ops = convert.trans_ops(transitions.build_structured(K=6), device)
    model = hmm.make_model_arrays(*(torch.from_numpy(np.asarray(x)).to(device)
                                    for x in pm.state_arrays()))
    stdv = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    ev = {
        "mean": rng.uniform(40.0, 90.0, (B, T)).astype(np.float32),
        "stdv": stdv,
        "log_stdv": np.log(stdv),
        "length": np.full(B, T, np.int32),
    }
    return ops, model, _tensors(ev, device)


def _decodes(grid, devices, models, rng) -> int:
    """Steps 2 and 3: the placed generic decode and the placed production
    decode."""
    B, Td = grid.shape["data"] * 2, 32
    first = devices[0]
    ops, model, dev_ev = _decode_inputs(B, Td, 1, first)
    dout = mesh_mod.join(statepar.viterbi_decode_placed(
        *mesh_mod.shard_decode_inputs(grid, ops, model, dev_ev)))
    assert dout["path"].shape == (B, Td)
    assert torch.isfinite(dout["logp"]).all()

    pm = models["r73.t.006"]
    pool_mean = rng.uniform(40.0, 90.0, (B, Td)).astype(np.float32)
    pool_stdv = rng.uniform(0.5, 1.5, (B, Td)).astype(np.float32)
    pool_start = np.cumsum(
        rng.uniform(0.01, 0.05, (B, Td)).astype(np.float32), axis=-1)
    bank = _tensors({k: getattr(pm, k)[None].astype(np.float32)
                     for k in ("level_mean", "level_stdv", "sd_mean",
                               "sd_lambda")}, first)
    pm_params = np.zeros((B, 6), np.float32)
    pm_params[:, [0, 3, 4, 5]] = 1.0
    t = _tensors({
        "mean": pool_mean, "stdv": pool_stdv, "start": pool_start,
        "idx": np.arange(B, dtype=np.int64),
        "drifts": np.full(B, 0.01, np.float32),
        "model_idx": np.zeros(B, np.int32), "pm": pm_params,
        "stp": np.full((B, 2), [0.1, 0.3], np.float32),
        "lengths": np.full(B, Td, np.int32)}, first)
    placed = mesh_mod.shard_pooled_decode_inputs(
        grid, t["mean"], t["stdv"], t["start"], t["idx"], t["drifts"], bank,
        t["model_idx"], t["pm"], t["stp"], t["lengths"])
    pout = mesh_mod.join(basecall.decode_chunk_pooled(*placed))
    # codes are 6-bit packed: 3 bytes per 4 per-event codes
    assert pout["codes"].shape == (B, 3 * (-(-(Td - 1) // 4)))
    assert torch.isfinite(pout["logp"]).all()
    return B


def _seqpar_equality(devices) -> bool:
    """Step 4: K9 over every device against the one-device grouped decode
    (K1 + K2): logp bit-equal, and each read's path the states rebuilt
    from the grouped decode's codes up to its length, its end state
    after."""
    from . import native

    n = len(devices)
    models = load_builtin_models("r73")
    pm = models["r73.t.006"]
    first = devices[0]
    rng = np.random.default_rng(11)
    B, T = max(4, n), 16 * n
    mean = np.zeros((B, T), np.float32)
    stdv = np.zeros((B, T), np.float32)
    for b in range(B):
        m, s, _, _, _ = simulate.simulate_read(
            models, "r73.t.006", None, T, rng, noise_scale=0.5)
        mean[b], stdv[b] = m[:T], s[:T]
    lengths = np.full(B, T, np.int32)
    lengths[1] = T - 5
    ev = _tensors({"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
                   "length": lengths}, first)
    model = hmm.make_model_arrays(
        *(torch.from_numpy(np.asarray(x)).to(first)
          for x in pm.state_arrays()), B=B)
    p = transitions.TransitionParams()
    gt = hmm.make_grouped_trans_device(
        torch.full((B,), p.p_stay, device=first),
        torch.full((B,), p.p_skip, device=first), 6)
    ref = hmm.viterbi_decode_grouped(gt, model, ev)
    out = seqpar.viterbi_decode_seqpar(gt, model, ev, devices)
    assert torch.equal(_bits(out["logp"].cpu()), _bits(ref["logp"].cpu())), \
        "K9's logp differs from the one-device decode's"
    path = out["path"].cpu().numpy().astype(np.int32)
    path0, codes = ref["path0"].cpu().numpy(), ref["codes"].cpu().numpy()
    for b, L in enumerate(lengths.tolist()):
        want = native.path_from_packed_codes(int(path0[b]), codes[b], L, 6)
        assert (path[b, :L] == want).all(), f"K9's path of read {b} differs"
        assert (path[b, L - 1:] == path[b, L - 1]).all(), \
            f"K9's path past the length of read {b}"
    return True


def _pipeline_fasta_equality(devices) -> bool:
    """Step 5: simulated reads through run_pipeline, unsharded and over a
    DataSharder of the devices: FASTA byte-equal."""
    n = len(devices)
    models = load_builtin_models("r73")
    rng = np.random.default_rng(7)
    reads = []
    for i in range(max(8, n)):
        mean, stdv, start, length, _ = simulate.simulate_read(
            models, "r73.t.006", None, 200, rng, noise_scale=0.5)
        reads.append(ed_from_arrays(mean, stdv, start, length, 4000.0,
                                    f"r{i}"))

    def run(shards) -> str:
        cfg = Config(pore="r73", train=False,
                     num_shards=len(shards)).apply_pore_preset()
        cfg.template_only = True
        stream = (read_pipeline.summarize_ed(f"r{i}.fast5", ed, models, cfg)
                  for i, ed in enumerate(reads))
        _, results = basecall.run_pipeline(
            stream, models, cfg, shards[0],
            sharder=mesh_mod.DataSharder(devices=shards))
        buf = io.StringIO()
        output.write_results_fasta(buf, results)
        return buf.getvalue()

    single, sharded = run(devices[:1]), run(devices)
    assert single and single == sharded, (
        "sharded pipeline FASTA diverged from the single-device run "
        f"(lens {len(single)} vs {len(sharded)})")
    return True


def dryrun_multichip(n_devices: int | None = None, devices=None) -> str:
    """The five steps above on make_mesh(n_devices, model_axis=2 if
    n_devices is even else 1, devices=devices): devices default to every
    visible GPU (a RuntimeError without one), n_devices to all of them.
    Every failure raises.  Prints and returns the summary line."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip runs on the visible GPUs and "
                               "there is none; pass devices= to use others")
        devices = mesh_mod.local_devices("cuda")
    devices = [mesh_mod.indexed(d) for d in devices]
    n = n_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = devices[:n]
    grid = mesh_mod.make_mesh(n, model_axis=2 if n % 2 == 0 else 1,
                              devices=devices)
    rng = np.random.default_rng(0)
    models = load_builtin_models("r73")
    G = _train_round(grid, devices, models, rng)
    B = _decodes(grid, devices, models, rng)
    seqpar_eq = _seqpar_equality(devices)
    fasta_eq = _pipeline_fasta_equality(devices)
    line = (f"dryrun_multichip ok: mesh={grid.shape} train G={G} decode "
            f"B={B} pooled_decode B={B} seqpar_exact={seqpar_eq} "
            f"pipeline_fasta_equal={fasta_eq}")
    print(line)
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
