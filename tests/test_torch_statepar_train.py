"""The EM round on the mesh's state axis, on the CPU: the port's
shard_train_inputs and statepar.train_one_round_placed (the plain K4m and
K5m) against nanocall_tpu.parallel.mesh.shard_train_inputs on the
8-device CPU mesh, against the port's own unplaced round
(train.train_one_round: the plain K4 + K5) and against JAX's
train_one_round on JAX's placed inputs.

Tolerances: against the port's unplaced round, fit, new_pm_params, done
and new_st_params bit-equal (NaN bits included: every rank takes K4's max
and K5's max over the whole column, and the ranks' partial sums combine in
the pairwise order of the whole row's tree); against JAX's placed round
(tests/test_sharding.py:55 on the state axis), test_torch_train.py's
tolerances: fit rtol 1e-5, new_pm_params rtol 2e-3 / atol 1e-3,
new_st_params rtol 5e-3 / atol 1e-4 (XLA reorders the jitted sums).
"""

import functools

import numpy as np
import pytest
import torch

from nanocall_tpu import train as jtrain
from nanocall_tpu.parallel import mesh as jmesh
from nanocall_tpu_torch import convert, roofline, train
from nanocall_tpu_torch import transitions as ttrans
from nanocall_tpu_torch.models import load_builtin_models
from nanocall_tpu_torch.ops import em, hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from test_train import make_models
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
#: the (data, model) meshes every round runs on
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 2)]
#: (train_scaling, train_transitions)
FLAGS = {"both": (True, True), "scaling": (True, False),
         "transitions": (False, True), "neither": (False, False)}
G, S = 4, 4
#: events a row, by K
T_OF = {3: 12, 6: 6}
MODEL_FIELDS = ("level_mean", "level_stdv", "sd_mean", "sd_lambda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _cpu_mesh(D: int, M: int) -> mesh.Mesh:
    return mesh.make_mesh(D * M, model_axis=M, devices=[CPU] * (D * M))


@functools.lru_cache(maxsize=None)
def _batch(K: int, nan: bool, g: int = G):
    """A numpy training batch of g groups of S rows at width K: both
    strands' models (the r73 pair at K = 6, test_train's random pair at
    K = 3), events drawn from random states of the scaled models, rows of
    length 0, 1, T - 1 and T in group 0, an invalid row in group 1, varied
    scaling and transition parameters; with `nan`, a NaN event in a row of
    group 2, a NaN level mean at one state of its template model and a
    +inf event in another of its rows."""
    rng = np.random.default_rng(100 + K)
    T, n = T_OF[K], 4 ** K
    if K == 6:
        ms = load_builtin_models("r73")
        pair = [ms["r73.t.006"], ms["r73.c.p1.006"]]
    else:
        m3 = make_models(rng)
        pair = [m3[0], m3[1]]
    mdl = {f: np.stack([np.stack([getattr(p, f) for p in pair])] * g)
           .astype(np.float32) for f in MODEL_FIELDS}
    pm = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (g, 1))
    pm[:, 0] = rng.uniform(0.95, 1.05, g)
    pm[:, 1] = rng.uniform(-1.0, 1.0, g)
    pm[:, 2] = rng.uniform(-0.01, 0.01, g)
    st = np.stack([rng.uniform(0.05, 0.2, (g, 2)),
                   rng.uniform(0.2, 0.4, (g, 2))], -1).astype(np.float32)
    strand = np.tile(np.array([0, 0, 1, 1], np.int32), (g, 1))
    states = rng.integers(0, n, (g, S, T))
    lm = mdl["level_mean"][np.arange(g)[:, None, None],
                           strand[:, :, None], states]
    mean = (lm * pm[:, 0, None, None] + pm[:, 1, None, None]
            + rng.normal(0.0, 1.0, (g, S, T))).astype(np.float32)
    stdv = rng.uniform(0.6, 1.8, (g, S, T)).astype(np.float32)
    ev = {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
          "start": np.cumsum(rng.uniform(0.01, 0.03, (g, S, T)), -1)
          .astype(np.float32),
          "length": rng.integers(T // 2, T + 1, (g, S)).astype(np.int32),
          "strand": strand, "valid": np.ones((g, S), bool)}
    ev["length"][0] = [0, 1, T - 1, T]
    ev["valid"][1, 2] = False
    if nan:
        ev["length"][2] = T
        ev["mean"][2, 1, T // 2] = np.nan
        mdl["level_mean"][2, 0, n // 3] = np.nan
        ev["mean"][2, 3, 1] = np.inf
    return ev, mdl, pm, st


def _torch_batch(K: int, nan: bool, g: int = G):
    return convert.train_batch(*_batch(K, nan, g), CPU)


@functools.lru_cache(maxsize=None)
def _unplaced(K: int, nan: bool, flags: str) -> dict:
    ts, tt = FLAGS[flags]
    return train.train_one_round(*_torch_batch(K, nan), K=K,
                                 train_scaling=ts, train_transitions=tt)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("inputs", ["clean", "nan"])
@pytest.mark.parametrize("K", [3, 6])
@pytest.mark.parametrize("D,M", MESHES)
def test_placed_round_bit_equal_to_unplaced(D, M, K, inputs, flags):
    """statepar.train_one_round_placed on shard_train_inputs' parts of a
    (D, M) CPU mesh, joined over the data rows: fit, new_pm_params, done
    and new_st_params bit-equal to the unplaced round's, with both train
    flags, each alone and neither, on NaN / +inf inputs too."""
    ts, tt = FLAGS[flags]
    placed = mesh.shard_train_inputs(_cpu_mesh(D, M),
                                     *_torch_batch(K, inputs == "nan"))
    got = statepar.train_one_round_placed(*placed, K=K, train_scaling=ts,
                                          train_transitions=tt)
    assert isinstance(got, list) and len(got) == D
    got = mesh.join(got)
    want = _unplaced(K, inputs == "nan", flags)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(_bits(got[k]), _bits(v)), k
    if inputs == "nan":
        assert torch.isnan(want["fit"][2])
    else:
        assert torch.isfinite(want["fit"]).all()


def test_placement_matches_jax_addressable_shards():
    """Each part of shard_train_inputs on mesh cell (d, m) has the shape
    and values of JAX's shard on the device at the same cell of
    make_mesh(8, model_axis=2): the events and parameters over 'data', each
    model table (G, 2, n) over ('data', None, 'model')."""
    ev, mdl, pm, st = _batch(6, False, 8)
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        placed_j = jmesh.shard_train_inputs(jm, ev, mdl, pm, st)
    placed = mesh.shard_train_inputs(_cpu_mesh(4, 2),
                                     *convert.train_batch(ev, mdl, pm, st,
                                                          CPU))
    cell = {dev.id: (d, m) for d, row in enumerate(jm.devices)
            for m, dev in enumerate(row)}

    def check(arr_j, got, what):
        assert len(arr_j.addressable_shards) == 8, what
        for shard in arr_j.addressable_shards:
            d, m = cell[shard.device.id]
            part = got.shards[d][m].numpy()
            assert part.shape == shard.data.shape, (what, d, m)
            assert np.array_equal(part, np.asarray(shard.data)), (what, d, m)

    for k in ev:
        assert placed[0][k].spec == ("data",)
        check(placed_j[0][k], placed[0][k], f"ev[{k}]")
    for k in mdl:
        assert placed[1][k].spec == ("data", None, "model")
        check(placed_j[1][k], placed[1][k], f"models[{k}]")
        assert placed[1][k].shards[1][1].shape == (2, 2, 2048)
    for i, what in ((2, "pm_params"), (3, "st_params")):
        assert placed[i].spec == ("data",)
        check(placed_j[i], placed[i], what)


def test_placed_round_matches_jax_placed_round():
    """tests/test_sharding.py:55 on the state axis: JAX's train_one_round
    on its shard_train_inputs' placement of make_mesh(8, model_axis=2), and
    the port's train_one_round_placed on a 4 x 2 CPU mesh, at K = 3: within
    test_torch_train.py's tolerances."""
    ev, mdl, pm, st = _batch(3, False, 8)
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        want = jtrain.train_one_round(
            *jmesh.shard_train_inputs(jm, ev, mdl, pm, st), K=3)
    got = mesh.join(statepar.train_one_round_placed(
        *mesh.shard_train_inputs(_cpu_mesh(4, 2), *convert.train_batch(
            ev, mdl, pm, st, CPU)), K=3))
    np.testing.assert_allclose(got["fit"].numpy(), np.asarray(want["fit"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["new_pm_params"].numpy(),
                               np.asarray(want["new_pm_params"]), rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["new_st_params"].numpy(),
                               np.asarray(want["new_st_params"]), rtol=5e-3,
                               atol=1e-4)
    assert np.array_equal(got["done"].numpy(), np.asarray(want["done"]))


@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 32, 64])
def test_rank_partials_combine_to_tree_sum(M):
    """A contiguous power-of-two slice of a row is a whole subtree of
    tree_sum's pairwise tree: the M ranks' tree sums of their slices,
    combined pairwise in rank order (hmm.combine_rank_sums), are the row's
    tree_sum bit for bit, with infinities and a NaN among the values."""
    rng = np.random.default_rng(M)
    x = torch.from_numpy(np.exp(rng.normal(0.0, 6.0, (5, 3, 4096)))
                         .astype(np.float32))
    x[1, 0, 7] = float("inf")
    x[2, 2, 4000] = float("nan")
    W = 4096 // M
    parts = [hmm.tree_sum(x[..., m * W:(m + 1) * W]) for m in range(M)]
    got = hmm.combine_rank_sums(parts)
    assert torch.equal(_bits(got), _bits(hmm.tree_sum(x)))
    if M > 2:  # a sequential fold of the partials would not be
        seq = parts[0]
        for p in parts[1:]:
            seq = seq + p
        assert not torch.equal(_bits(seq), _bits(got))


def _ranks(K: int, nan: bool, M: int, train_scaling: bool = True):
    """One data row (the whole batch) as M ranks' cuts of round_inputs,
    and the unplaced round's inputs."""
    ev, mdl, pm, st = _torch_batch(K, nan)
    return (statepar.split_round_states(ev, mdl, pm, st, [CPU] * M, K,
                                        train_scaling),
            train.round_inputs(ev, mdl, pm, st, K, train_scaling))


@pytest.mark.parametrize("stored", [True, False])
@pytest.mark.parametrize("M", [2, 4, 16])
def test_forward_wave_plain_equals_k4(M, stored):
    """The plain K4m over M ranks, in waves of 5 reads and the rest: every
    rank's slices of the alphas (or, storing none, of the final column and
    the one before) joined are the plain K4's, and every rank's
    log Pr[data] is K4's, on the NaN inputs at K = 6; the counters are
    left at 0."""
    ranks, inp = _ranks(6, True, M)
    alphas, lpd = hmm.fwbw_grouped_forward_plain(inp["gtf"], inp["model"],
                                                 inp["ev"])
    fwd = [statepar._fwd_wave_rank(r, stored) for r in ranks]
    B, T = inp["x_unc"].shape
    for lo, hi in ((0, 5), (5, B)):
        hmm.fwbw_forward_wave_plain(fwd, lo, hi)
    for r in fwd:
        assert torch.equal(_bits(r.lpd), _bits(lpd))
        assert not r.flags.any()
    for t in ((range(T)) if stored else (T - 1, T - 2)):
        got = hmm.gather_column([hmm._column_of(r, t) for r in fwd])
        assert torch.equal(_bits(got), _bits(alphas[t])), t
    assert torch.isnan(lpd).any()


def test_forward_slice_step_equals_the_k4_step():
    """One plain K4m step per rank of 4 from the gathered column: the
    ranks' slices joined are the plain K4's alpha after two events."""
    ranks, inp = _ranks(6, False, 4)
    ev = dict(inp["ev"], length=torch.full_like(inp["ev"]["length"], 2))
    alphas, _ = hmm.fwbw_grouped_forward_plain(inp["gtf"], inp["model"], ev)
    B = ev["mean"].shape[0]
    col = torch.empty((2, 4, B, 1024))
    for t in (0, 1):
        for m, r in enumerate(ranks):
            hmm.fwbw_forward_slice_plain(r["gtf"], r["model"], ev,
                                         list(col[1 - t]), t, m * 1024,
                                         col[t, m])
    for t in (0, 1):
        assert torch.equal(_bits(hmm.gather_column(col[t])),
                           _bits(alphas[t]))


@pytest.mark.parametrize("flags", ["both", "scaling", "transitions"])
@pytest.mark.parametrize("M", [2, 4, 8])
def test_backward_wave_plain_equals_k5(M, flags):
    """The plain K5m over M ranks, in waves of 6 reads and the rest, on the
    plain K4's alphas: the first rank's scal and st3 are the plain K5's
    bit for bit, on the NaN inputs at K = 6."""
    ts, tt = FLAGS[flags]
    ranks, inp = _ranks(6, True, M)
    if not ts:
        inp = {**inp, "W": None}
    alphas, lpd = hmm.fwbw_grouped_forward_plain(inp["gtf"], inp["model"],
                                                 inp["ev"])
    want = em.fused_bwd_mstats_plain(*train.em_backward_args(
        inp, lpd, alphas, ts, tt))
    W = 4096 // M
    fwd = [statepar._fwd_wave_rank(r, True) for r in ranks]
    for m, f in enumerate(fwd):
        f.alphas.copy_(alphas[..., m * W:(m + 1) * W])
        f.lpd.copy_(lpd)
    bwd = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
    B = inp["x_unc"].shape[0]
    for lo, hi in ((0, 6), (6, B)):
        em.em_backward_wave_plain(bwd, lo, hi, ts, tt)
    assert torch.equal(_bits(bwd[0].scal), _bits(want[0]))
    assert torch.equal(_bits(bwd[0].st3), _bits(want[1]))
    assert all(not r.flags.any() for r in bwd)


def test_em_round_statepar_without_train_flags_stores_no_alphas():
    """With neither train flag the row runs K4m's fit-only form (no alphas,
    a column buffer) and no K5m: log Pr[data] only."""
    ranks, inp = _ranks(3, False, 2)
    (lpd, scal, st3), = statepar.em_round_statepar([ranks], False, False)
    _, want = hmm.fwbw_grouped_forward_plain(inp["gtf"], inp["model"],
                                             inp["ev"], with_alphas=False)
    assert scal is None and st3 is None
    assert torch.equal(_bits(lpd), _bits(want))


@pytest.mark.parametrize("M", [1, 128])
def test_wave_wrappers_refuse_rank_counts(M):
    """K4m and K5m take 2 to 64 ranks: a row of one rank runs K4 + K5 and
    128 ranks would cut slices of 32 states; both raise before any launch
    and count nothing."""
    ranks, _ = _ranks(6, False, M)
    fwd = [statepar._fwd_wave_rank(r, True) for r in ranks]
    bwd = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
    n0 = (hmm.fwbw_forward_wave_kernel.launches,
          em.em_backward_wave_kernel.launches)
    with pytest.raises(ValueError, match="2 to 64 ranks"):
        hmm.fwbw_forward_wave_kernel(fwd, [0], 0, 4)
    with pytest.raises(ValueError, match="2 to 64 ranks"):
        em.em_backward_wave_kernel(bwd, [0], 0, 4, True, True)
    assert (hmm.fwbw_forward_wave_kernel.launches,
            em.em_backward_wave_kernel.launches) == n0


def test_wave_wrappers_refuse_cpu_tensors():
    """K4m and K5m launch on CUDA tensors only: on CPU tensors they raise
    (the plain versions are reached through em_round_statepar, never
    through a kernel wrapper), and K5m without a train flag raises."""
    ranks, _ = _ranks(6, False, 2)
    fwd = [statepar._fwd_wave_rank(r, True) for r in ranks]
    bwd = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
    n0 = (hmm.fwbw_forward_wave_kernel.launches,
          em.em_backward_wave_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        hmm.fwbw_forward_wave_kernel(fwd, [0, 1], 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        em.em_backward_wave_kernel(bwd, [0, 1], 0, 4, True, False)
    with pytest.raises(ValueError, match="train flag"):
        em.em_backward_wave_kernel(bwd, [0, 1], 0, 4, False, False)
    assert (hmm.fwbw_forward_wave_kernel.launches,
            em.em_backward_wave_kernel.launches) == n0


def test_placed_round_refuses_default_ops_and_a_bank():
    """The legacy round under a loaded table is not placed (it raises,
    naming ROADMAP.md, where it is queued), and neither is a model bank:
    shard_train_inputs and train_one_round_placed raise on model_idx."""
    ev, mdl, pm, st = _torch_batch(3, False)
    grid = _cpu_mesh(2, 2)
    placed = mesh.shard_train_inputs(grid, ev, mdl, pm, st)
    ops = convert.trans_ops(ttrans.build_structured(K=3), CPU)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        statepar.train_one_round_placed(*placed, K=3, default_ops=ops,
                                        default_priors=(0.1, 0.3))
    bank = {k: v[:2] for k, v in mdl.items()}
    bank["model_idx"] = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="model bank"):
        mesh.shard_train_inputs(grid, ev, bank, pm, st)
    with pytest.raises(ValueError, match="model bank"):
        statepar.train_one_round_placed(
            placed[0], {**placed[1], "model_idx": bank["model_idx"]},
            *placed[2:], K=3)


def test_shard_train_inputs_validation():
    """Groups that do not split over the data rows and states that do not
    split over the ranks raise ValueError."""
    batch = _torch_batch(3, False)
    with pytest.raises(ValueError, match="groups"):
        mesh.shard_train_inputs(_cpu_mesh(3, 1), *batch)
    with pytest.raises(ValueError, match="states"):
        mesh.shard_train_inputs(_cpu_mesh(1, 3), *batch)
    with pytest.raises(ValueError, match="states"):
        statepar.split_round_states(*batch, [CPU] * 3, 3)


def test_em_slice_kernel_counts():
    """roofline's counts of K4m and K5m are those of the function a data
    row's round computes, whatever its ranks: K4's (alphas stored) and
    K5's; at the EM chunk, 512 x 128, their bounds are K4's 0.343 ms and
    K5's 0.352 ms.  What the ranks read from each other is counted apart:
    the alpha columns (every event's, the final one for log Pr[data]),
    the g columns (T - 1 steps), the partial maxima and the first rank's
    reads of the per-step records."""
    for T in (1, 128):
        assert roofline.kernel_counts("fwbw_forward_wave", 512, T) == \
            roofline.kernel_counts("fwbw_forward", 512, T)
        assert roofline.kernel_counts("em_backward_wave", 512, T) == \
            roofline.kernel_counts("em_backward", 512, T)
    assert roofline.kernel_bound("fwbw_forward_wave", 512, 128)[
        "bound_ms"] == pytest.approx(0.343, abs=5e-4)
    assert roofline.kernel_bound("em_backward_wave", 512, 128)[
        "bound_ms"] == pytest.approx(0.352, abs=5e-4)
    ex = roofline.statepar_exchange_bytes(512, 128, 2)
    assert ex["alpha_column"] == 128 * 2 * 4 * 512 * 2048
    assert ex["g_column"] == 127 * 2 * 4 * 512 * 2048
    assert ex["maxima"] == 127 * 2 * 12 * 512
    assert ex["partials"] == 36 * 512 * 128
