"""The legacy EM round (under a loaded table, `--trans`) on the mesh's
state axis, on the CPU: statepar.train_one_round_placed(default_ops=...)
(the plain K6cm for the rows at the CLI priors, the plain K4m + K6dm for
the others, each rank's part of the legacy statistics) against the port's
own unplaced legacy round (train.train_one_round(default_ops=...)) and
against JAX's train_one_round(default_ops=...) on JAX's placed inputs; the
plain K6cm and K6dm against K6c's and K6d's plain versions; the wrappers'
refusals and the kernels' counts.

Tolerances: against the port's unplaced round, fit, new_pm_params, done
and new_st_params bit-equal (NaN bits included: every rank steps its own
states from the whole column, the maxima are exact and every state sum is
a tree whose subtrees are the ranks' slices, combined in rank order);
against JAX's placed round, test_torch_trans.py's legacy-round
tolerances: fit rtol 1e-5, new_pm_params rtol 2e-3 / atol 1e-3,
new_st_params rtol 5e-3 / atol 1e-4, done equal.
"""

import functools

import numpy as np
import pytest
import torch

from nanocall_tpu import train as jtrain, transitions as jtransitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu.parallel import mesh as jmesh
from nanocall_tpu_torch import convert, roofline, train
from nanocall_tpu_torch import transitions as ttrans
from nanocall_tpu_torch.ops import em, hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from test_torch_statepar_train import MESHES, _batch, _bits, _cpu_mesh
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
#: the CLI priors (p_stay, p_skip), and the loaded table's kinetics
PRIORS = (0.1, 0.3)
P_STAY, P_SKIP = 0.14, 0.21
#: test_torch_trans.py's flag sets of the legacy round
ROUND_FLAGS = {
    "drift": dict(train_drift=True),
    "no_drift": dict(train_drift=False),
    "no_train_transitions": dict(train_drift=True, train_transitions=False),
    "no_train_scaling": dict(train_drift=True, train_scaling=False),
    "fit_only": dict(train_drift=True, train_scaling=False,
                     train_transitions=False),
}


@functools.lru_cache(maxsize=None)
def _tables(K: int, tmp: str) -> tuple:
    """The loaded table of (0.14, 0.21) at K, for JAX and for the port,
    each read back from a TSV by its own loader."""
    path = f"{tmp}/trans{K}.tsv"
    jtransitions.save_tsv(jtransitions.build_structured(
        jtransitions.TransitionParams(P_STAY, P_SKIP), K), path)
    return (jhmm.make_trans_ops(jtransitions.load_tsv(path, K)),
            convert.trans_ops(ttrans.load_tsv(path, K), CPU))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("legacy"))


def _at_priors(st: np.ndarray) -> np.ndarray:
    """st with the strand 0 of groups 0 and 3 and the strand 1 of group 2
    at the CLI priors: those rows take K6cm, the rest K4m + K6d in every
    data row of every mesh."""
    st = st.copy()
    st[0, 0] = st[3, 0] = st[2, 1] = PRIORS
    return st


@functools.lru_cache(maxsize=None)
def _legacy_batch(K: int, nan: bool) -> tuple:
    ev, mdl, pm, st = _batch(K, nan)
    return convert.train_batch(ev, mdl, pm, _at_priors(st), CPU)


@functools.lru_cache(maxsize=None)
def _unplaced(K: int, nan: bool, flags: str, tmp: str) -> dict:
    return train.train_one_round(
        *_legacy_batch(K, nan), K=K, default_ops=_tables(K, tmp)[1],
        default_priors=PRIORS, **ROUND_FLAGS[flags])


@pytest.mark.parametrize("flags", sorted(ROUND_FLAGS))
@pytest.mark.parametrize("inputs", ["clean", "nan"])
@pytest.mark.parametrize("K", [3, 6])
@pytest.mark.parametrize("D,M", MESHES)
def test_placed_legacy_round_bit_equal_to_unplaced(D, M, K, inputs, flags,
                                                   tmp):
    """statepar.train_one_round_placed under the loaded table on
    shard_train_inputs' parts of a (D, M) CPU mesh, joined over the data
    rows, with rows at the priors and rows off them in every data row:
    fit, new_pm_params, done and new_st_params bit-equal to the unplaced
    legacy round's, with each of the legacy round's flag sets, on NaN /
    +inf inputs too."""
    nan = inputs == "nan"
    placed = mesh.shard_train_inputs(_cpu_mesh(D, M), *_legacy_batch(K, nan))
    got = statepar.train_one_round_placed(
        *placed, K=K, default_ops=_tables(K, tmp)[1], default_priors=PRIORS,
        **ROUND_FLAGS[flags])
    assert isinstance(got, list) and len(got) == D
    got = mesh.join(got)
    want = _unplaced(K, nan, flags, tmp)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(_bits(got[k]), _bits(v)), k
    assert torch.isnan(want["fit"][2]) == nan
    # the loaded table moved the round away from the fused one
    fused = train.train_one_round(*_legacy_batch(K, nan), K=K,
                                  **ROUND_FLAGS[flags])
    assert not torch.equal(_bits(fused["fit"]), _bits(want["fit"]))


def test_placed_legacy_round_matches_jax_placed_round(tmp):
    """JAX's train_one_round under the loaded table on its
    shard_train_inputs' placement of make_mesh(8, model_axis=2), and the
    port's train_one_round_placed on a 4 x 2 CPU mesh, at K = 3: within
    test_torch_trans.py's legacy-round tolerances."""
    ev, mdl, pm, st = _batch(3, False, 8)
    st = _at_priors(st)
    ops_j, ops_t = _tables(3, tmp)
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        want = jtrain.train_one_round(
            *jmesh.shard_train_inputs(jm, ev, mdl, pm, st), K=3,
            default_ops=ops_j, default_priors=np.float32(PRIORS))
    got = mesh.join(statepar.train_one_round_placed(
        *mesh.shard_train_inputs(_cpu_mesh(4, 2), *convert.train_batch(
            ev, mdl, pm, st, CPU)), K=3, default_ops=ops_t,
        default_priors=PRIORS))
    np.testing.assert_allclose(got["fit"].numpy(), np.asarray(want["fit"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["new_pm_params"].numpy(),
                               np.asarray(want["new_pm_params"]), rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["new_st_params"].numpy(),
                               np.asarray(want["new_st_params"]), rtol=5e-3,
                               atol=1e-4)
    assert np.array_equal(got["done"].numpy(), np.asarray(want["done"]))


def _rows(nan: bool) -> tuple:
    """The K = 6 batch's whole rows (round_inputs) and its cuts over M
    ranks, by M."""
    batch = _legacy_batch(6, nan)
    return train.round_inputs(*batch, K=6), batch


def _fwbw_ranks(ops, inp: dict, M: int) -> list:
    B, T = inp["x_unc"].shape
    W = 4096 // M

    def buf(*shape):
        return torch.full(shape, 7.0)

    return [hmm.FwbwWaveRank(
        hmm.cut_fwbw_table(ops, slice(m * W, (m + 1) * W), CPU),
        hmm.ModelArrays(*(x[:, m * W:(m + 1) * W].contiguous()
                          for x in inp["model"])), inp["ev"],
        buf(B, T, W), buf(B, T, W), buf(B, T, W), buf(B), buf(2, B, W),
        buf(2, B), torch.zeros(B, dtype=torch.int32)) for m in range(M)]


@pytest.mark.parametrize("M", [2, 4, 8, 64])
def test_generic_wave_plain_equals_k6c(M, tmp):
    """The plain K6cm over M ranks, in waves of 5 reads and the rest (each
    rank stepping its states from the whole column of the ranks' slices,
    log Pr[data] from their partial maxima and tree sums): the ranks'
    alpha, beta and em joined are the plain K6c's, and every rank's log
    Pr[data] is K6c's, on the NaN inputs at K = 6 (a NaN event, a NaN
    model entry, a +inf event, rows of length 0, 1, T - 1 and T); the
    counters are left at 0."""
    inp, _ = _rows(True)
    ops = _tables(6, tmp)[1]
    want = hmm.fwbw_plain(ops, inp["model"], inp["ev"])
    ranks = _fwbw_ranks(ops, inp, M)
    B = inp["x_unc"].shape[0]
    for lo, hi in ((0, 5), (5, B)):
        hmm.fwbw_generic_wave_plain(ranks, lo, hi)
    for k in ("alpha", "beta", "em"):
        got = torch.cat([getattr(r, k) for r in ranks], dim=-1)
        assert torch.equal(_bits(got), _bits(want[k])), k
    for r in ranks:
        assert torch.equal(_bits(r.lpd), _bits(want["log_pr_data"]))
        assert not r.flags.any()
    assert torch.isnan(want["log_pr_data"]).any()


@pytest.mark.parametrize("M", [2, 4, 8, 64])
def test_backward_wave_plain_equals_k6d(M):
    """The plain K6dm over M ranks, in waves of 6 reads and the rest (each
    step every rank publishing its partial max of g, then its block sums):
    the ranks' betas joined are the plain K6d's bit for bit, on the NaN
    inputs at K = 6; the counters are left at 0."""
    inp, batch = _rows(True)
    want = hmm.fwbw_grouped_backward_plain(inp["gtf"], inp["model"],
                                           inp["ev"])
    ranks = statepar.split_round_states(*batch, [CPU] * M)
    B, T = inp["x_unc"].shape
    W = 4096 // M
    bwd = [em.BetaWaveRank(
        r["gtf"], r["books"], r["model"], r["ev"], torch.full((B, T, W), 7.),
        torch.zeros((2, B, em.NMAX_WAVE)),
        torch.zeros((2, B, em.block_sums_width(W))),
        torch.zeros(B, dtype=torch.int32)) for r in ranks]
    for lo, hi in ((0, 6), (6, B)):
        em.fwbw_backward_wave_plain(bwd, lo, hi)
    got = torch.cat([r.betas for r in bwd], dim=-1)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(want).any()
    assert all(not r.flags.any() for r in bwd)


def test_legacy_estep_statepar_slices_the_unplaced_estep(tmp):
    """legacy_estep_statepar over 4 ranks gives each rank its slices of
    train._legacy_estep's alpha, beta and em, and its log Pr[data], bit
    for bit, the rows at the priors under the table and the others by the
    grouped tables."""
    inp, batch = _rows(True)
    ops = _tables(6, tmp)[1]
    want = train._legacy_estep(inp, ops, PRIORS)
    ranks = statepar.split_round_states(*batch, [CPU] * 4)
    got = statepar.legacy_estep_statepar(ranks, ops, PRIORS)
    for m, fb in enumerate(got):
        cols = slice(m * 1024, (m + 1) * 1024)
        for k in ("alpha", "beta", "em"):
            assert torch.equal(_bits(fb[k]), _bits(want[k][..., cols])), k
        assert torch.equal(_bits(fb["log_pr_data"]),
                           _bits(want["log_pr_data"]))


@pytest.mark.parametrize("M", [1, 128])
def test_legacy_wave_wrappers_refuse_rank_counts(M, tmp):
    """K6cm and K6dm take 2 to 64 ranks: a row of one rank runs K6c, K4 and
    K6d, and 128 ranks would cut slices of 32 states; both raise before any
    launch and count nothing."""
    inp, batch = _rows(False)
    ranks = _fwbw_ranks(_tables(6, tmp)[1], inp, M)
    cuts = statepar.split_round_states(*batch, [CPU] * M)
    B, T = inp["x_unc"].shape
    bwd = [em.BetaWaveRank(r["gtf"], r["books"], r["model"], r["ev"],
                           torch.zeros((B, T, 4096 // M)),
                           torch.zeros((2, B, em.NMAX_WAVE)),
                           torch.zeros((2, B, 64)),
                           torch.zeros(B, dtype=torch.int32)) for r in cuts]
    n0 = (hmm.fwbw_wave_resident_kernel.launches,
          em.fwbw_backward_wave_kernel.launches)
    with pytest.raises(ValueError, match="2 to 64 ranks"):
        hmm.fwbw_generic_wave_kernel(ranks, [0], 0, 4)
    with pytest.raises(ValueError, match="2 to 64 ranks"):
        em.fwbw_backward_wave_kernel(bwd, [0], 0, 4)
    assert (hmm.fwbw_wave_resident_kernel.launches,
            em.fwbw_backward_wave_kernel.launches) == n0


def test_legacy_wave_wrappers_refuse_cpu_tensors(tmp):
    """K6cm (both forms) and K6dm launch on CUDA tensors only: on CPU
    tensors they raise (the plain versions are reached through
    legacy_estep_statepar, never through a kernel wrapper), and K6cm
    refuses per-read tables."""
    inp, batch = _rows(False)
    ops = _tables(6, tmp)[1]
    resident = _fwbw_ranks(ops, inp, 2)
    streaming = _fwbw_ranks(ops._replace(fwbw_packed=None), inp, 2)
    assert hmm.fwbw_route(resident[0].ops) == "resident"
    assert hmm.fwbw_route(streaming[0].ops) == "streaming"
    B, T = inp["x_unc"].shape
    bwd = [em.BetaWaveRank(r["gtf"], r["books"], r["model"], r["ev"],
                           torch.zeros((B, T, 2048)),
                           torch.zeros((2, B, em.NMAX_WAVE)),
                           torch.zeros((2, B, em.block_sums_width(2048))),
                           torch.zeros(B, dtype=torch.int32))
           for r in statepar.split_round_states(*batch, [CPU] * 2)]
    counts = (hmm.fwbw_wave_resident_kernel, hmm.fwbw_wave_streaming_kernel,
              em.fwbw_backward_wave_kernel)
    n0 = [k.launches for k in counts]
    for ranks in (resident, streaming):
        with pytest.raises(ValueError, match="CUDA"):
            hmm.fwbw_generic_wave_kernel(ranks, [0, 1], 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        em.fwbw_backward_wave_kernel(bwd, [0, 1], 0, 4)
    per_read = convert.trans_ops_batch(*ttrans.build_structured_batch(
        np.full((2, 2), [P_STAY, P_SKIP]), 6), 6, CPU)
    with pytest.raises(ValueError, match="per-read"):
        hmm.cut_fwbw_table(per_read, slice(0, 2048), CPU)
    assert [k.launches for k in counts] == n0


def test_legacy_wave_kernel_counts():
    """roofline's counts of K6cm and K6dm are those of the function a data
    row's legacy E-step computes, whatever its ranks: K6c's (the resident
    and the streaming kernel's) and K6d's; at the EM chunk, 512 x 128,
    their bounds are 0.977 ms and 0.336 ms, bytes.  What the ranks read
    from each other is counted apart: K6cm's whole columns, both
    directions (T - 1 steps each, every rank reading the M - 1 other
    slices), and K6dm's peers' sum4 and sum16 where a state's block lies in
    another rank, with its partial maxima."""
    for name, of in (("fwbw_generic_wave_resident", "fwbw_resident"),
                     ("fwbw_generic_wave_streaming", "fwbw_generic"),
                     ("fwbw_grouped_backward_wave",
                      "fwbw_grouped_backward")):
        for T in (1, 128):
            assert roofline.kernel_counts(name, 512, T) == \
                roofline.kernel_counts(of, 512, T)
    for name, ms in (("fwbw_generic_wave_resident", 0.977),
                     ("fwbw_generic_wave_streaming", 0.977),
                     ("fwbw_grouped_backward_wave", 0.336)):
        b = roofline.kernel_bound(name, 512, 128)
        assert b["bound_ms"] == pytest.approx(ms, abs=5e-4), name
        assert b["bound_by"] == "bytes"
    ex = roofline.statepar_exchange_bytes(512, 128, 2)
    assert ex["fwbw_columns"] == 2 * 127 * 2 * 4 * 512 * 2048
    assert ex["beta_sums"] == 127 * 4 * 512 * 2 * 2048
    assert ex["beta_maxima"] == 127 * 2 * 4 * 512
    ex = roofline.statepar_exchange_bytes(512, 128, 4)
    assert ex["fwbw_columns"] == 2 * 127 * 12 * 4 * 512 * 1024
    assert ex["beta_sums"] == 127 * 4 * 512 * 2 * 3072


#: fwbw_wave_reads' cases, worked by hand: (W, deg, resident, cluster, R).
#: A resident cut of 2048 states and 21 slots takes 91,392 bytes (21 x
#: (256 + 4096)); a block of one read beside it 33,024 of column (2 x
#: 4128 floats on the cluster path), 256 of vote words and 16,384 of em
#: buffers: 141,056, with the static 6,144 and the runtime's 1,024 more
#: than half an SM's 233,472, so the cluster path takes 2 reads (190,464
#: bytes).  At 1024 states one read takes 89,856 bytes and two blocks
#: share an SM: 1 read.  The cooperative path takes the most that fit:
#: 4 reads at 1024 states (146,816 bytes), 8 at 512 (190,848), 2 at 2048
#: (157,056; n / W = 2).  64 states: a block of a warp is 2 reads.  A cut
#: of 50 slots (217,600 bytes) fits no block.
FWBW_WAVE_READS_CASES = (
    (2048, 21, True, True, 2), (1024, 21, True, True, 1),
    (512, 21, True, True, 1), (64, 21, True, True, 2),
    (2048, 21, False, True, 1), (1024, 21, False, True, 1),
    (2048, 21, True, False, 2), (1024, 21, True, False, 4),
    (512, 21, True, False, 8), (64, 21, True, False, 8),
    (2048, 21, False, False, 2), (512, 21, False, False, 8),
    (2048, 50, True, True, 0), (2048, 50, True, False, 0),
)


@pytest.mark.parametrize("W,deg,resident,cluster,R", FWBW_WAVE_READS_CASES)
def test_fwbw_wave_reads_hand_computed(W, deg, resident, cluster, R):
    """K6cm's reads a block (hmm.fwbw_wave_reads) from the slice's width,
    the cut's slots, its form and the exchange path, against the cases
    worked by hand above, and the shared memory it counts
    (hmm.fwbw_wave_smem) at the hand-computed sizes."""
    assert hmm.fwbw_wave_reads(W, deg, resident, cluster) == R
    if R:
        assert R * W // 4 >= 32
        assert hmm.fwbw_wave_smem(R, W, deg, resident, cluster) <= \
            hmm.FWBW_WAVE_SMEM


def test_fwbw_wave_smem_hand_computed():
    """hmm.fwbw_wave_smem at the byte counts of the comment above: the
    columns (a bank shift of 32 / R floats a read), the vote words, the em
    buffers and the cut; against a block's budget (hmm.FWBW_WAVE_SMEM,
    226,304 bytes) and half an SM, the boundaries fwbw_wave_reads
    draws."""
    assert hmm.FWBW_WAVE_SMEM == 232448 - 6144
    assert hmm.fwbw_wave_smem(1, 2048, 21, True, True) == 141056
    assert hmm.fwbw_wave_smem(2, 2048, 21, True, True) == 190464
    assert hmm.fwbw_wave_smem(1, 1024, 21, True, True) == 89856
    assert hmm.fwbw_wave_smem(4, 1024, 21, True, False) == 146816
    assert hmm.fwbw_wave_smem(8, 512, 21, True, False) == 190848
    assert hmm.fwbw_wave_smem(2, 2048, 21, False, False) == 65664
    assert hmm.fwbw_wave_smem(1, 2048, 50, True, False) == 217600 + 16384 \
        + 16512 > hmm.FWBW_WAVE_SMEM
    # a block of one read at 2048 states: more than half an SM (2 reads)
    assert 2 * (141056 + 6144 + 1024) > hmm.SMEM_PER_SM
    assert 2 * (89856 + 6144 + 1024) <= hmm.SMEM_PER_SM
    # the cooperative path's next count past the most that fit
    assert hmm.fwbw_wave_smem(8, 1024, 21, True, False) > hmm.FWBW_WAVE_SMEM


@pytest.mark.parametrize("n_reads,M,R,cluster,n_local,grid,block", [
    (13, 2, 2, True, None, (2, 7), 1024),
    (512, 2, 2, True, None, (2, 256), 1024),
    (512, 4, 1, True, None, (4, 512), 256),
    (13, 4, 4, False, 4, (4, 4), 1024),
    (13, 64, 8, False, 32, (2, 32), 128),
    (8, 8, 8, False, None, (1, 8), 1024),
])
def test_fwbw_wave_grid_hand_computed(n_reads, M, R, cluster, n_local, grid,
                                      block):
    """K6cm's launch shape (hmm.fwbw_wave_grid): on the cluster path a grid
    (M, read groups) of clusters of M blocks, else a cooperative grid (read
    groups, the launch's ranks); R W / 4 threads a block; a last group of
    fewer reads than R still takes a block."""
    got = hmm.fwbw_wave_grid(n_reads, M, R, cluster, n_local)
    assert got == {"grid": grid, "block": block,
                   "cluster": M if cluster else None}


def test_plan_waves_blocks_of_reads():
    """statepar.plan_waves with `reads` reads a block: a wave holds (the
    card's resident blocks // its ranks) x reads reads, so its grid of
    read groups fits the card, and every wave but the last whole blocks;
    one card of 4 ranks holding 10 blocks at 4 reads a block: waves of 8
    reads; two cards (2 ranks each) holding 5 and 9 blocks at 2 reads a
    block: waves of 4."""
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    assert statepar.plan_waves(13, [a] * 4, {a: 10}, 4) == {
        a: [(0, 8), (8, 13)]}
    assert statepar.plan_waves(13, [a, a, b, b], {a: 5, b: 9}, 2) == {
        a: [(0, 4), (4, 8), (8, 12), (12, 13)],
        b: [(0, 4), (4, 8), (8, 12), (12, 13)]}
    assert statepar.plan_waves(13, [a] * 4, {a: 10}) == {
        a: [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 13)]}
    assert statepar.row_waves(13, [a] * 4, lambda d, sys: 10, False, 4) \
        == {a: [(0, 8), (8, 13)]}


@pytest.mark.parametrize("cluster", [True, False])
def test_legacy_wave_wrapper_refuses_a_cut_that_fits_no_block(cluster):
    """A resident cut whose slots fit no block's shared memory (50 slots a
    side at 2048 states: 217,600 bytes of cut alone) is refused with
    ValueError by K6cm's wave wrapper (hmm.fwbw_wave_resident, which plans
    every launch's waves) before it asks the card, on either path, and by
    the launch's fit check (hmm._fwbw_wave_fit); a cut of 21 slots fits."""
    with pytest.raises(ValueError, match="does not fit"):
        hmm.fwbw_wave_resident(torch.device("cpu"), False, True, 50, 2048,
                               cluster=cluster)
    with pytest.raises(ValueError, match="does not fit"):
        hmm._fwbw_wave_fit(2048, 50, True, cluster)
    assert hmm._fwbw_wave_fit(2048, 21, True, cluster) == 2
