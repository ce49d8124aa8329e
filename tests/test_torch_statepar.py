"""The mesh's state axis on the CPU: the port's make_mesh,
shard_pooled_decode_inputs and state-parallel decode (parallel/statepar.py,
the plain K1m and K2m) against nanocall_tpu.parallel.mesh on the 8-device
CPU mesh and against the port's own unsharded decode.

Tolerances: against the port's unsharded decode_chunk_pooled, every output
bit-equal (NaN bits included: every rank runs K1's step body on the whole
column); against JAX's _decode_chunk_pooled under make_mesh(8,
model_axis=2), paths and codes equal and logp within rtol 1e-5, the
tolerance of tests/test_torch_seqpar.py (XLA reorders the jitted emission,
and jnp.log and torch.log differ in the last bit on some inputs).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nanocall_tpu import basecall as jbasecall
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.parallel import mesh as jmesh
from nanocall_tpu_torch import basecall, convert, roofline
from nanocall_tpu_torch.ops import hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
#: the (data, model) meshes every decode runs on
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (4, 2)]


@functools.lru_cache(maxsize=None)
def _sharding_case():
    """tests/test_sharding.py:107's inputs (B = 8, T = 48, r73.t.006, seed
    3) as numpy arrays, in _decode_chunk_pooled's order."""
    rng = np.random.default_rng(3)
    B, T = 8, 48
    pm = load_builtin_models("r73")["r73.t.006"]
    pool_mean = rng.uniform(40.0, 90.0, (B, T)).astype(np.float32)
    pool_stdv = rng.uniform(0.5, 1.5, (B, T)).astype(np.float32)
    pool_start = np.cumsum(
        rng.uniform(0.01, 0.05, (B, T)).astype(np.float32), axis=-1)
    bank = {f: getattr(pm, f)[None].astype(np.float32)
            for f in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")}
    pm_params = np.zeros((B, 6), np.float32)
    pm_params[:, [0, 3, 4, 5]] = 1.0
    pm_params[:, 1] = rng.uniform(-1, 1, B)
    stp = np.stack([rng.uniform(0.08, 0.12, B), rng.uniform(0.25, 0.35, B)],
                   axis=-1).astype(np.float32)
    lengths = rng.integers(T // 2, T + 1, B).astype(np.int32)
    return (pool_mean, pool_stdv, pool_start, np.arange(B, dtype=np.int32),
            np.full(B, 0.01, np.float32), bank, np.zeros(B, np.int32),
            pm_params, stp, lengths)


def _to_torch(args):
    return tuple({k: torch.from_numpy(v) for k, v in a.items()}
                 if isinstance(a, dict) else torch.from_numpy(a)
                 for a in args)


def _port_args(B: int, T: int, seed: int, nan: bool = False):
    """decode_chunk_pooled's inputs for B tasks of T events: both r73
    models, varied scaling and transitions, lengths 0, 1 and T among
    ragged ones; with `nan`, a NaN event in read 3 and a NaN level mean of
    the first model at a state of the second half (read 4 uses it)."""
    rng = np.random.default_rng(seed)
    models = load_builtin_models("r73")
    pm = np.zeros((B, 6), np.float32)
    pm[:, [0, 3, 4, 5]] = 1.0
    pm[:, 1] = rng.uniform(-1, 1, B)
    stp = np.stack([rng.uniform(0.08, 0.12, B), rng.uniform(0.25, 0.35, B)],
                   axis=-1).astype(np.float32)
    lm = models["r73.t.006"].level_mean
    mean = (lm[rng.integers(0, 4096, (B, T))]
            + rng.normal(0, 1, (B, T))).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[:3] = [0, 1, T]
    lengths[3:5] = T
    if nan:
        mean[3, T // 2] = np.nan
    bank = convert.model_bank(models, ("r73.t.006", "r73.c.p1.006"), CPU)
    if nan:
        bank["level_mean"][0, 3000] = float("nan")
    model_idx = np.arange(B) % 2
    model_idx[4:5] = 0
    return (convert.tensor(mean, CPU),
            convert.tensor(rng.uniform(0.5, 1.5, (B, T)), CPU),
            convert.tensor(np.cumsum(rng.uniform(0.01, 0.05, (B, T)), -1),
                           CPU),
            torch.arange(B), convert.tensor(np.full(B, 0.01), CPU), bank,
            convert.tensor(model_idx, CPU, torch.int32),
            convert.tensor(pm, CPU), convert.tensor(stp, CPU),
            convert.tensor(lengths, CPU, torch.int32))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor compared as bits: floats as their int32 patterns."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _cpu_mesh(D: int, M: int) -> mesh.Mesh:
    return mesh.make_mesh(D * M, model_axis=M, devices=[CPU] * (D * M))


@pytest.mark.parametrize("model_axis", [2, 3])
def test_make_mesh_grid_matches_jax(model_axis):
    """make_mesh(8, model_axis) lays the device list out as JAX's: the
    same (data, model) shape and device order, and model 1 where
    model_axis does not divide 8."""
    want = jmesh.make_mesh(8, model_axis=model_axis)
    order = {d.id: i for i, d in enumerate(jax.devices())}
    got = mesh.make_mesh(8, model_axis=model_axis, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert np.array_equal(got.ids,
                          np.vectorize(lambda d: order[d.id])(want.devices))
    assert [len(row) for row in got.devices] == [got.shape["model"]] * \
        got.shape["data"]
    assert mesh.make_mesh(devices=[CPU] * 3, model_axis=3).shape == \
        {"data": 1, "model": 3}
    with pytest.raises(ValueError):
        mesh.make_mesh(9, devices=[CPU] * 8)


def test_make_mesh_raises_without_a_gpu(monkeypatch):
    """make_mesh() builds on the visible GPUs: on a host without one it
    raises, and never picks the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no"):
        mesh.make_mesh(4, model_axis=2)


def test_placement_matches_jax_addressable_shards():
    """Each argument's part on mesh cell (d, m) has the shape of JAX's
    shard on the device at the same cell of make_mesh(8, model_axis=2),
    and its values (the renumbered idx aside: 0 .. B/data - 1 on each
    row)."""
    args = _sharding_case()
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        placed_j = jmesh.shard_pooled_decode_inputs(jm, *args)
    placed = mesh.shard_pooled_decode_inputs(_cpu_mesh(4, 2),
                                             *_to_torch(args))
    cell = {dev.id: (d, m) for d, row in enumerate(jm.devices)
            for m, dev in enumerate(row)}

    def check(arr_j, got, what):
        assert len(arr_j.addressable_shards) == 8, what
        for shard in arr_j.addressable_shards:
            d, m = cell[shard.device.id]
            part = got.shards[d][m]
            assert tuple(part.shape) == shard.data.shape, (what, d, m)
            if what == "idx":
                assert torch.equal(part, torch.arange(part.shape[0]))
            else:
                assert np.array_equal(part.numpy(), np.asarray(shard.data)), \
                    (what, d, m)

    names = ("pool_mean", "pool_stdv", "pool_start", "idx", "drifts", "bank",
             "model_idx", "pm_params", "stp", "lengths")
    for name, arr_j, got in zip(names, placed_j, placed):
        if name == "bank":
            assert sorted(got) == sorted(arr_j)
            for k in arr_j:
                assert got[k].spec == (None, "model")
                check(arr_j[k], got[k], f"bank[{k}]")
        else:
            assert got.spec == ("data",), name
            check(arr_j, got, name)


@pytest.mark.parametrize("inputs", ["clean", "nan"])
@pytest.mark.parametrize("with_path", [True, False])
@pytest.mark.parametrize("D,M", MESHES)
def test_mesh_decode_bit_equal_to_unsharded(D, M, with_path, inputs):
    """decode_chunk_pooled on the placed arguments of a (D, M) CPU mesh,
    joined over the data rows: every output bit-equal to the unplaced
    decode's (path0, codes and logp; logp alone score-only), under NaN
    inputs too."""
    args = _port_args(8, 24, 11, nan=inputs == "nan")
    [want] = basecall.decode_chunk_pooled(*args, with_path=with_path)
    got = basecall.decode_chunk_pooled(
        *mesh.shard_pooled_decode_inputs(_cpu_mesh(D, M), *args),
        with_path=with_path)
    assert isinstance(got, list) and len(got) == D
    got = mesh.join(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(_bits(got[key]), _bits(want[key])), key
    if inputs == "nan":
        assert torch.isnan(want["logp"]).any()


def test_mesh_decode_matches_jax_production_decode():
    """tests/test_sharding.py:107's inputs through JAX's _decode_chunk_pooled
    under make_mesh(8, model_axis=2) and through the port on a 4 x 2 CPU
    mesh: path0 and codes equal, logp within rtol 1e-5."""
    args = _sharding_case()
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        want = jax.device_get(jbasecall._decode_chunk_pooled(
            *jmesh.shard_pooled_decode_inputs(jm, *args), K=6,
            with_path=True))
    got = mesh.join(basecall.decode_chunk_pooled(
        *mesh.shard_pooled_decode_inputs(_cpu_mesh(4, 2), *_to_torch(args)),
        K=6, with_path=True))
    for key in ("path0", "codes"):
        assert np.array_equal(got[key].numpy().astype(np.int64),
                              np.asarray(want[key]).astype(np.int64)), key
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)


@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_split_states_decode_bit_equal_to_k1_k2(ranks):
    """split_states' ranks over whole (B, n) tables against the port's
    viterbi_decode_grouped on them, path and score-only: bit-equal, at
    slices down to 512 states."""
    args = _port_args(4, 16, 7)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    rows = [statepar.split_states(gt, model, ev, [CPU] * ranks)]
    for with_path in (True, False):
        want = hmm.viterbi_decode_grouped(gt, model, ev, with_path=with_path)
        [got] = statepar.viterbi_decode_statepar(rows, with_path=with_path)
        for key in want:
            assert torch.equal(got[key], want[key]), (with_path, key)


def test_forward_slice_step_equals_the_grouped_step():
    """One plain K1m step per rank of 4 from the gathered column: the
    ranks' alpha and backpointer slices joined are the one-device step's
    (viterbi_forward_grouped_plain over two events)."""
    args = _port_args(3, 2, 5)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    ev["length"] = torch.full((3,), 2, dtype=torch.int32)
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    alpha, bps = hmm.viterbi_forward_grouped_plain(gt, model, ev)
    parts = statepar.split_states(gt, model, ev, [CPU] * 4)
    col = torch.empty((2, 4, 3, 1024))
    bp = torch.empty((4, 3, 1024), dtype=torch.uint8)
    for t in (0, 1):
        for m, p in enumerate(parts):
            hmm.viterbi_forward_slice_plain(p.gt, p.model, p.ev, col[1 - t],
                                            t, m * 1024, col[t, m],
                                            bp[m] if t else None)
    assert torch.equal(hmm.gather_column(col[1]), alpha)
    assert torch.equal(hmm.gather_column(bp), bps[0])


def test_statepar_shape_validation():
    """Ranks of unequal slices, rows of unequal T, an uneven split of the
    states or of the tasks, and a placed chunk under a loaded table or an
    active sharder raise ValueError."""
    args = _port_args(4, 8, 2)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    two = statepar.split_states(gt, model, ev, [CPU] * 2)
    four = statepar.split_states(gt, model, ev, [CPU] * 4)
    with pytest.raises(ValueError):
        statepar.split_states(gt, model, ev, [CPU] * 3)
    with pytest.raises(ValueError):
        statepar.viterbi_decode_statepar([[two[0], four[1]]])
    short = {k: (v[:, :4] if v.ndim == 2 else v) for k, v in ev.items()}
    with pytest.raises(ValueError):
        statepar.viterbi_decode_statepar(
            [two, statepar.split_states(gt, model, short, [CPU] * 2)])
    with pytest.raises(ValueError):
        statepar.viterbi_decode_statepar([])
    with pytest.raises(ValueError):
        mesh.shard_pooled_decode_inputs(_cpu_mesh(3, 1), *args)
    with pytest.raises(ValueError):
        mesh.shard_pooled_decode_inputs(_cpu_mesh(1, 3), *args)
    placed = mesh.shard_pooled_decode_inputs(_cpu_mesh(2, 2), *args)
    with pytest.raises(ValueError):
        basecall.decode_chunk_pooled(
            *placed, sharder=mesh.DataSharder(devices=[CPU] * 2))


def test_slice_kernel_wrappers_refuse_cpu_tensors():
    """K1m's and K2m's wrappers launch on CUDA tensors only: on CPU tensors
    they raise (the plain versions are reached through
    viterbi_decode_statepar, never through a kernel wrapper)."""
    args = _port_args(4, 4, 1)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    ranks = [statepar._wave_rank(p, True)
             for p in statepar.split_states(gt, model, ev, [CPU] * 2)]
    col = torch.zeros((2, 4, 2048))
    n0 = (hmm.forward_wave_kernel.launches,
          hmm.traceback_slices_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        hmm.forward_wave_kernel(ranks, [0, 1], 0, 4)
    bps = [torch.zeros((3, 4, 2048), dtype=torch.uint8)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        hmm.traceback_slices_kernel(6, col, bps, ev["length"])
    assert (hmm.forward_wave_kernel.launches,
            hmm.traceback_slices_kernel.launches) == n0


def test_slice_kernel_counts():
    """roofline's counts of K1m and K2m are those of the function a data
    row's decode computes, whatever its ranks: K1's (events, 9 tables and
    the final column once, a backpointer byte per event after the first
    and state; K1's operations for all n states) and K2's; the exchange
    apart: the peers' slices read in place and the walk's ring copies from
    the other ranks' slices.  At 128 x 8192 K1m is bound by operations,
    1.839 ms, as K1 is."""
    B, n = 128, 4096
    for T in (1, 8192):
        assert roofline.kernel_counts("viterbi_forward_slice", B, T) == (
            12 * B * T + 4 * B + 40 * B * n + (T - 1) * B * n,
            28.6875 * B * T * n)
        assert roofline.kernel_counts("viterbi_forward_slice", B, T) == \
            roofline.kernel_counts("viterbi_forward_path", B, T)
        assert roofline.kernel_counts("viterbi_traceback_slices", B, T) == \
            roofline.kernel_counts("viterbi_traceback", B, T)
    for ranks in (1, 2, 4):
        W = n // ranks
        ex = roofline.statepar_exchange_bytes(B, 8192, ranks, 7)
        assert ex == {"column": 8191 * ranks * (ranks - 1) * 4 * B * W,
                      "walk": 7 * (ranks - 1) * W,
                      "alpha_column": 8192 * ranks * (ranks - 1) * 4 * B * W,
                      "g_column": 8191 * ranks * (ranks - 1) * 4 * B * W,
                      "maxima": 8191 * ranks * (ranks - 1) * 12 * B,
                      "partials": (ranks - 1) * 36 * B * 8192}
    b = roofline.kernel_bound("viterbi_forward_slice", B, 8192)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(
        1e3 * 28.6875 * B * 8192 * n / roofline.H100_F32_OPS_PER_S)
    assert b["bound_ms"] == pytest.approx(1.839, abs=5e-4)
    assert roofline.walk_rows([6, 2, 0, 1, 9000], 8192) == 5 + 1 + 8191
    assert roofline.walk_rows(torch.tensor([3, 3]), 2) == 2


@pytest.mark.parametrize("B,devices,resident,per", [
    (128, ["a", "a"], {"a": 132}, 66),
    (128, ["a"] * 4, {"a": 132}, 33),
    (64, ["a", "a"], {"a": 132}, 64),
    (128, ["a", "b"], {"a": 132, "b": 100}, 100),
    (128, ["a", "b", "a", "b"], {"a": 132, "b": 132}, 66),
    (10, ["a", "b", "b"], {"a": 5, "b": 7}, 3),
    (3, ["a"] * 64, {"a": 132}, 2),
])
def test_plan_waves(B, devices, resident, per):
    """plan_waves covers every read once, in contiguous waves of at most
    `per` reads, whose grid (reads x the row's ranks on a card) fits each
    card's resident blocks, and cuts the same waves for every card of the
    row; a card too small for one read raises."""
    waves = statepar.plan_waves(B, devices, resident)
    assert sorted(waves) == sorted(set(devices))
    cuts = list(waves.values())
    assert all(c == cuts[0] for c in cuts)
    reads = [b for lo, hi in cuts[0] for b in range(lo, hi)]
    assert reads == list(range(B))
    assert max(hi - lo for lo, hi in cuts[0]) == min(per, B)
    for d, cut in waves.items():
        for lo, hi in cut:
            assert (hi - lo) * devices.count(d) <= resident[d], (d, lo, hi)
    with pytest.raises(ValueError):
        statepar.plan_waves(B, devices, {d: devices.count(d) - 1
                                         for d in devices})


@pytest.mark.parametrize("T", [8, 9])
@pytest.mark.parametrize("M", [2, 4, 8])
def test_forward_wave_plain_keeps_both_parities(M, T):
    """The plain K1m's double buffer, which the kernel's exchange reads in
    place and chip_smoke.py compares with the kernel's whole: after a wave
    of all reads, every rank's col[(T - 1) % 2] holds its slice of the
    final column and col[(T - 2) % 2] its slice of the column before
    (viterbi_forward_grouped_plain over the first T - 1 events, lengths
    unchanged), on NaN inputs; the counters are left at 0."""
    args = _port_args(6, T, 31 + T, nan=True)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    last, _ = hmm.viterbi_forward_grouped_plain(gt, model, ev)
    before, _ = hmm.viterbi_forward_grouped_plain(gt, model, {
        k: v if k == "length" else v[:, :T - 1] for k, v in ev.items()})
    ranks = [statepar._wave_rank(p, False)
             for p in statepar.split_states(gt, model, ev, [CPU] * M)]
    hmm.viterbi_forward_wave_plain(ranks, 0, 6)
    for t, want in ((T - 1, last), (T - 2, before)):
        got = hmm.gather_column([r.col[t % 2] for r in ranks])
        assert torch.equal(_bits(got), _bits(want)), (M, T, t)
    assert torch.isnan(last).any()
    assert all(not r.flags.any() for r in ranks)


@pytest.mark.parametrize("M", [1, 128])
def test_forward_wave_kernel_refuses_rank_counts(M):
    """K1m takes 2 to 64 ranks (slices of 2048 to 64 states): a row of one
    rank decodes by K1 + K2 (statepar), and 128 ranks would cut slices of
    32 states; either raises before any launch, and counts nothing."""
    args = _port_args(4, 4, 1)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    ranks = [statepar._wave_rank(p, True)
             for p in statepar.split_states(gt, model, ev, [CPU] * M)]
    n0 = hmm.forward_wave_kernel.launches
    with pytest.raises(ValueError, match="2 to 64 ranks"):
        hmm.forward_wave_kernel(ranks, [0], 0, 4)
    assert hmm.forward_wave_kernel.launches == n0


def test_forward_wave_plain_equals_the_grouped_forward():
    """The plain K1m over two waves of a row of 2 ranks: the ranks' final
    slices and backpointer slices joined are viterbi_forward_grouped_plain's
    final alpha and backpointers, read by read."""
    args = _port_args(5, 9, 21)
    model = hmm.make_scaled_model_arrays(args[5], args[6], args[7])
    ev = basecall.pooled_ev_batch(*args[:5], args[9])
    gt = hmm.make_grouped_trans_device(args[8][:, 0], args[8][:, 1], 6)
    alpha, bps = hmm.viterbi_forward_grouped_plain(gt, model, ev)
    ranks = [statepar._wave_rank(p, True)
             for p in statepar.split_states(gt, model, ev, [CPU] * 2)]
    for lo, hi in ((0, 3), (3, 5)):
        hmm.viterbi_forward_wave_plain(ranks, lo, hi)
    assert torch.equal(_bits(hmm.gather_column([r.col[0] for r in ranks])),
                       _bits(alpha))
    assert torch.equal(torch.cat([r.bps for r in ranks], dim=2), bps)
    assert all(not r.flags.any() for r in ranks)
