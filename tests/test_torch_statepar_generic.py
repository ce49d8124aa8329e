"""The generic decode on the mesh's state axis, on the CPU: the port's
shard_decode_inputs and statepar.viterbi_decode_placed (the plain K6am and
K6bm) against nanocall_tpu.parallel.mesh.shard_decode_inputs on the
8-device CPU mesh and against the port's own unplaced decode
(hmm.viterbi_decode: the plain K6a + K6b), under one table for every read
and under per-read tables.

Tolerances: against the port's unplaced decode, path and logp bit-equal
(NaN bits included: every rank runs K6a's slot loop on the whole column);
against JAX's viterbi_decode under shard_decode_inputs on make_mesh(8,
model_axis=2), paths equal and logp within rtol 1e-5 (tests/
test_torch_trans.py's tolerance: XLA reorders the jitted emission).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nanocall_tpu import transitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu.parallel import mesh as jmesh
from nanocall_tpu_torch import convert, roofline, transitions as ttrans
from nanocall_tpu_torch.ops import hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
#: the (data, model) meshes every decode runs on, test_torch_statepar.py's
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (4, 2)]
#: the tables: the structured (21, n) table of (0.14, 0.21) (resident
#: layout), it loaded from a TSV (resident), the CLI priors' loaded table
#: (17 log-probs in some slots: resident at 4 codebooks a slot, each rank
#: cut to its blocks' codebooks), a random table of 25 slots
#: (streaming; no from-state table for K6bm's ring) and per-read
#: structured tables
TABLES = ("structured", "loaded", "priors", "random25", "per-read")
B, T = 8, 10
LENGTHS = [T, 0, 1, T - 1, 6, T, 3, T]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _cpu_mesh(D: int, M: int) -> mesh.Mesh:
    return mesh.make_mesh(D * M, model_axis=M, devices=[CPU] * (D * M))


@functools.lru_cache(maxsize=None)
def _table(name: str, tmp: str) -> hmm.TransOps:
    st = ttrans.build_structured(ttrans.TransitionParams(0.14, 0.21), 6)
    if name == "structured":
        return convert.trans_ops(st, CPU)
    if name in ("loaded", "priors"):
        if name == "priors":
            st = ttrans.build_structured(ttrans.TransitionParams(0.1, 0.3),
                                         6)
        path = f"{tmp}/{name}.tsv"
        ttrans.save_tsv(st, path)
        return convert.trans_ops(ttrans.load_tsv(path, 6), CPU)
    if name == "random25":
        rng = np.random.default_rng(25)
        idx = rng.integers(0, 4096, (25, 4096)).astype(np.int32)
        lp = np.log(rng.uniform(0.01, 1.0, (25, 4096))).astype(np.float32)
        return convert.trans_ops(ttrans.SparseTransitions(
            from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), CPU)
    params = np.stack([np.linspace(0.06, 0.16, B),
                       np.linspace(0.35, 0.2, B)], 1)
    return convert.trans_ops_batch(
        *ttrans.build_structured_batch(params, 6), 6, CPU)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("generic"))


@functools.lru_cache(maxsize=None)
def _inputs(nan: bool):
    """B reads of T events at n = 4096 (both r73 models, varied scaling,
    lengths 0, 1, T-1 and T); with `nan`, a NaN event in read 0, a NaN
    level mean at state 3000 of read 2 and a +inf event in read 5."""
    _, (_, model, ev), _ = _rows(6, np.random.default_rng(90), B, T, LENGTHS)
    if nan:
        ev["mean"][0, T // 2] = float("nan")
        model.level_mean[2, 3000] = float("nan")
        ev["mean"][5, 2] = float("inf")
    return model, ev


def test_table_routes():
    """The tables take the K6am forms they are meant to: the structured,
    loaded and per-read tables the resident one (and K6bm's from-state
    table), the priors' and the 25 slots the streaming one (the 25 slots
    without the from-state table)."""
    routes = {}
    for name in ("structured", "per-read", "random25"):
        ops = _table(name, "")
        routes[name] = (hmm.generic_forward_route(ops),
                        ops.from_states is not None)
    assert routes == {"structured": ("resident", True),
                      "per-read": ("resident", True),
                      "random25": ("streaming", False)}


def test_loaded_table_routes(tmp):
    assert hmm.generic_forward_route(_table("loaded", tmp)) == "resident"
    assert hmm.generic_forward_route(_table("priors", tmp)) == "resident"
    assert hmm.resident_groups(_table("loaded", tmp)) == 1
    assert hmm.resident_groups(_table("priors", tmp)) == hmm.FWBW_GROUPS
    assert _table("priors", tmp).from_states is not None


@pytest.mark.parametrize("inputs", ["clean", "nan"])
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("D,M", MESHES)
def test_placed_decode_bit_equal_to_unplaced(tmp, D, M, table, inputs):
    """statepar.viterbi_decode_placed on shard_decode_inputs' parts of a
    (D, M) CPU mesh, joined over the data rows: path and logp bit-equal to
    the unplaced hmm.viterbi_decode's, and score-only the same logp, under
    NaN inputs too."""
    ops = _table(table, tmp)
    model, ev = _inputs(inputs == "nan")
    placed = mesh.shard_decode_inputs(_cpu_mesh(D, M), ops, model, ev)
    for with_path in (True, False):
        want = hmm.viterbi_decode(ops, model, ev, with_path=with_path)
        got = statepar.viterbi_decode_placed(*placed, with_path=with_path)
        assert isinstance(got, list) and len(got) == D
        got = mesh.join(got)
        assert sorted(got) == sorted(want)
        for key in want:
            assert torch.equal(_bits(got[key]), _bits(want[key])), \
                (with_path, key)
    if inputs == "nan":
        assert torch.isnan(want["logp"]).any()


def _jax_case(per_read: bool, one_row: bool):
    """tests/test_sharding.py:_decode_batch's inputs at K = 3 (B = 8, T =
    32, seed 2) as numpy arrays, the model (B, n) or one (n,) row, and the
    structured table of the priors or per-read tables."""
    K, n = 3, 64
    rng = np.random.default_rng(2)
    lm = rng.uniform(40, 90, n).astype(np.float32)
    rows = [lm, rng.uniform(0.8, 2.0, n).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.uniform(2.0, 9.0, n).astype(np.float32)]
    if not one_row:
        rows = [np.tile(r, (8, 1)) for r in rows]
    stdv = rng.uniform(0.5, 1.5, (8, 32)).astype(np.float32)
    ev = {"mean": rng.uniform(40, 90, (8, 32)).astype(np.float32),
          "stdv": stdv, "log_stdv": np.log(stdv),
          "length": rng.integers(16, 33, 8).astype(np.int32)}
    if per_read:
        params = np.stack([np.linspace(0.06, 0.16, 8),
                           np.linspace(0.35, 0.2, 8)], 1)
        tables = transitions.build_structured_batch(params, K)
        ops_j = jhmm.make_trans_ops_batch(*tables, K)
        ops = convert.trans_ops_batch(*tables, K, CPU)
    else:
        ops_j = jhmm.make_trans_ops(transitions.build_structured(K=K))
        ops = convert.trans_ops(ttrans.build_structured(K=K), CPU)
    model_j = jhmm.make_model_arrays(*rows)
    # the port's model holds JAX's values (jnp.log and torch.log differ
    # in the last bit on some inputs), a one-row model as a (1, n) row
    model = hmm.ModelArrays(*(x.reshape(-1, n) for x in
                              convert.model_arrays(model_j, CPU)))
    ev_t = {k: torch.from_numpy(v) for k, v in ev.items()}
    return (ops_j, model_j, ev), (ops, model, ev_t)


@pytest.mark.parametrize("one_row", [False, True])
@pytest.mark.parametrize("per_read", [False, True])
def test_placement_matches_jax_addressable_shards(per_read, one_row):
    """Each part of shard_decode_inputs on mesh cell (d, m) has the shape
    and values of JAX's shard on the device at the same cell of
    make_mesh(8, model_axis=2): the events, the model ((B, n) over
    ('data', 'model'); a one-row model over 'model', the port's (1, W)
    part against JAX's (W,) shard), from_logp and to_logp ((21, n) over
    'model', per-read (B, 21, n) over ('data', None, 'model'))."""
    (ops_j, model_j, ev), (ops, model, ev_t) = _jax_case(per_read, one_row)
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        ops_js, model_js, ev_js = jmesh.shard_decode_inputs(jm, ops_j,
                                                            model_j, ev)
    table, model_s, ev_s = mesh.shard_decode_inputs(_cpu_mesh(4, 2), ops,
                                                    model, ev_t)
    cell = {dev.id: (d, m) for d, row in enumerate(jm.devices)
            for m, dev in enumerate(row)}

    def check(arr_j, got, what):
        assert len(arr_j.addressable_shards) == 8, what
        for shard in arr_j.addressable_shards:
            d, m = cell[shard.device.id]
            part = got.shards[d][m].numpy()
            if one_row and what.startswith("model"):
                assert part.shape[0] == 1, what
                part = part[0]
            assert part.shape == shard.data.shape, (what, d, m)
            assert np.array_equal(part, np.asarray(shard.data)), (what, d, m)

    for k in ev:
        assert ev_s[k].spec == ("data",)
        check(ev_js[k], ev_s[k], f"ev[{k}]")
    for f in hmm.ModelArrays._fields:
        assert getattr(model_s, f).spec == (
            (None, "model") if one_row else ("data", "model"))
        check(getattr(model_js, f), getattr(model_s, f), f"model.{f}")
    spec = ("data", None, "model") if per_read else (None, "model")
    for f in ("from_logp", "to_logp"):
        assert getattr(table.cut, f).spec == spec
        check(getattr(ops_js, f), getattr(table.cut, f), f)
    for d, row in enumerate(table.cut.from_idx.shards):
        assert torch.equal(table.walk[d].from_idx, ops.from_idx)
        for m, part in enumerate(row):
            assert torch.equal(part, ops.from_idx[:, m * 32:(m + 1) * 32])


@pytest.mark.parametrize("per_read", [False, True])
def test_2d_mesh_decode_matches_jax(per_read):
    """tests/test_sharding.py:90 test_2d_mesh_decode mirrored: JAX's
    viterbi_decode on shard_decode_inputs' placement of make_mesh(8,
    model_axis=2), and the port's viterbi_decode_placed on a 4 x 2 CPU
    mesh: paths equal, logp within rtol 1e-5; under per-read tables
    (shard_decode_inputs' 3-D branch) too."""
    (ops_j, model_j, ev), (ops, model, ev_t) = _jax_case(per_read, False)
    ref = jhmm.viterbi_decode(ops_j, model_j, ev)
    jm = jmesh.make_mesh(8, model_axis=2)
    with jm:
        out_j = jax.device_get(jhmm.viterbi_decode(
            *jmesh.shard_decode_inputs(jm, ops_j, model_j, ev)))
    got = mesh.join(statepar.viterbi_decode_placed(
        *mesh.shard_decode_inputs(_cpu_mesh(4, 2), ops, model, ev_t)))
    for want in (ref, out_j):
        np.testing.assert_array_equal(
            got["path"].numpy().astype(np.int64),
            np.asarray(want["path"]).astype(np.int64))
        np.testing.assert_allclose(got["logp"].numpy(),
                                   np.asarray(want["logp"]), rtol=1e-5)


def test_generic_slice_step_equals_the_k6a_step(tmp):
    """One plain K6am step per rank of 4 from the gathered column, under
    the loaded table and under per-read tables: the ranks' alpha and
    backpointer slices joined are the one-device plain K6a's over two
    events."""
    model, ev = _inputs(False)
    ev = dict(ev, length=torch.full((B,), 2, dtype=torch.int32))
    for name in ("loaded", "per-read"):
        ops = _table(name, tmp)
        alpha, bps = hmm.viterbi_forward_plain(ops, model, ev)
        row = statepar.split_table_states(ops, model, ev, [CPU] * 4)
        col = torch.empty((2, 4, B, 1024))
        bp = torch.empty((4, B, 1024), dtype=torch.uint8)
        for t in (0, 1):
            for m, p in enumerate(row.parts):
                hmm.viterbi_forward_generic_slice_plain(
                    p.ops, p.model, p.ev, col[1 - t], t, m * 1024,
                    col[t, m], bp[m] if t else None)
        assert torch.equal(_bits(hmm.gather_column(col[1])), _bits(alpha))
        assert torch.equal(hmm.gather_column(bp), bps[0])


@pytest.mark.parametrize("M", [2, 4, 8, 16, 64])
def test_generic_wave_plain_keeps_both_parities(tmp, M):
    """The plain K6am's double buffer, which the kernel's exchange reads in
    place: after waves of 5 and 3 reads, every rank's col[(T - 1) % 2]
    holds its slice of the final column and col[(T - 2) % 2] its slice of
    the column before, on the NaN inputs; the counters are left at 0."""
    model, ev = _inputs(True)
    ops = _table("priors", tmp)
    last, _ = hmm.viterbi_forward_plain(ops, model, ev)
    before, _ = hmm.viterbi_forward_plain(ops, model, {
        k: v if k == "length" else v[:, :T - 1] for k, v in ev.items()})
    ranks = [statepar._generic_wave_rank(p, False) for p in
             statepar.split_table_states(ops, model, ev, [CPU] * M).parts]
    for lo, hi in ((0, 5), (5, B)):
        hmm.viterbi_forward_generic_wave_plain(ranks, lo, hi)
    for t, want in ((T - 1, last), (T - 2, before)):
        got = hmm.gather_column([r.col[t % 2] for r in ranks])
        assert torch.equal(_bits(got), _bits(want)), (M, t)
    assert torch.isnan(last).any()
    assert all(not r.flags.any() for r in ranks)


@pytest.mark.parametrize("M", [1, 128])
def test_generic_wave_wrappers_refuse_rank_counts(tmp, M):
    """K6am takes 2 to 64 ranks: a row of one rank decodes by K6a + K6b
    and 128 ranks would cut slices of 32 states; both forms raise before
    any launch and count nothing."""
    model, ev = _inputs(False)
    for name in ("loaded", "priors"):
        ranks = [statepar._generic_wave_rank(p, True) for p in
                 statepar.split_table_states(_table(name, tmp), model, ev,
                                             [CPU] * M).parts]
        n0 = (hmm.generic_wave_resident_kernel.launches,
              hmm.generic_wave_streaming_kernel.launches)
        for wrapper in (hmm.generic_wave_resident_kernel,
                        hmm.generic_wave_streaming_kernel):
            with pytest.raises(ValueError, match="2 to 64 ranks"):
                wrapper(ranks, [0], 0, B)
        assert (hmm.generic_wave_resident_kernel.launches,
                hmm.generic_wave_streaming_kernel.launches) == n0


@pytest.mark.parametrize("M", [2, 4, 8, 16, 64])
def test_generic_wave_route_takes_the_cluster_path(M):
    """K6am's launches of a data row (statepar.row_waves with clusters, as
    _forward_kernels takes them by default): one launch of all the reads,
    a cluster a read, exactly where hmm.wave_cluster says (every rank on
    one card, at most hmm.MAX_CLUSTER ranks), never asking the resident
    blocks; else plan_waves' cut on K6am's resident blocks, as with
    clusters off (the cooperative path forced).  The wrappers' default
    (hmm.cluster_path, cluster None) agrees: the cluster path for a launch
    of every rank where wave_cluster says, never for a partial launch."""
    cards = [torch.device("cuda", i) for i in range(2)]
    asked = []

    def resident(d, sys):
        asked.append((d, sys))
        return 96
    for devices in ([cards[0]] * M, [cards[m % 2] for m in range(M)]):
        sys = len(set(devices)) > 1
        plan = statepar.plan_waves(B, devices, {d: 96 for d in devices})
        asked.clear()
        got = statepar.row_waves(B, devices, resident, clusters=True)
        if hmm.wave_cluster(M, sys):
            assert got == {cards[0]: [(0, B)]} and not asked, (M, sys)
        else:
            assert got == plan and asked, (M, sys)
        assert statepar.row_waves(B, devices, resident) == plan
        assert hmm.cluster_path(M, sys, M, None) == hmm.wave_cluster(M, sys)
        assert hmm.cluster_path(M, sys, M, False) is False
        assert hmm.cluster_path(M, sys, 1, None) is False
    assert hmm.wave_cluster(M, False) == (M <= hmm.MAX_CLUSTER)


@pytest.mark.parametrize("M", [2, 8, 16, 64])
def test_generic_wave_wrappers_refuse_the_cluster_path(tmp, M):
    """cluster=True is refused where K6am's cluster path cannot run: a
    launch of some of a row's ranks, a row of more than 8 ranks; both
    forms raise ValueError before any launch (before the CUDA check) and
    count nothing, and hmm.cluster_path raises across cards too."""
    model, ev = _inputs(False)
    for name in ("loaded", "priors"):
        ranks = [statepar._generic_wave_rank(p, True) for p in
                 statepar.split_table_states(_table(name, tmp), model, ev,
                                             [CPU] * M).parts]
        n0 = (hmm.generic_wave_resident_kernel.launches,
              hmm.generic_wave_streaming_kernel.launches)
        for wrapper in (hmm.generic_wave_resident_kernel,
                        hmm.generic_wave_streaming_kernel,
                        hmm.forward_generic_wave_kernel):
            locals_ = [[0]] + ([list(range(M))] if M > 8 else [])
            for local in locals_:
                with pytest.raises(ValueError, match="cluster path"):
                    wrapper(ranks, local, 0, B, cluster=True)
        assert (hmm.generic_wave_resident_kernel.launches,
                hmm.generic_wave_streaming_kernel.launches) == n0
    with pytest.raises(ValueError, match="across cards"):
        hmm.cluster_path(2, True, 2, True)


def test_generic_wave_wrappers_refuse_cpu_tensors(tmp):
    """K6am's two forms and K6bm launch on CUDA tensors only: on CPU
    tensors they raise (the plain versions are reached through
    viterbi_decode_generic_statepar, never through a kernel wrapper); a
    form the ranks' cuts do not take raises too."""
    model, ev = _inputs(False)
    row = statepar.split_table_states(_table("loaded", tmp), model, ev,
                                      [CPU] * 2)
    ranks = [statepar._generic_wave_rank(p, True) for p in row.parts]
    n0 = [k.launches for k in (hmm.generic_wave_resident_kernel,
                               hmm.generic_wave_streaming_kernel,
                               hmm.generic_traceback_slices_kernel)]
    with pytest.raises(ValueError, match="CUDA"):
        hmm.generic_wave_resident_kernel(ranks, [0, 1], 0, B)
    with pytest.raises(ValueError, match="CUDA"):
        hmm.forward_generic_wave_kernel(ranks, [0, 1], 0, B)
    col = [torch.zeros((B, 2048))] * 2
    bps = [torch.zeros((T - 1, B, 2048), dtype=torch.uint8)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        hmm.generic_traceback_slices_kernel(row.walk, col, bps,
                                            ev["length"])
    assert [k.launches for k in (hmm.generic_wave_resident_kernel,
                                 hmm.generic_wave_streaming_kernel,
                                 hmm.generic_traceback_slices_kernel)] == n0


def test_shard_decode_inputs_validation(tmp):
    """Reads that do not split over the data rows, states that do not
    split over the ranks and a model of neither B rows nor one raise
    ValueError."""
    model, ev = _inputs(False)
    ops = _table("loaded", tmp)
    with pytest.raises(ValueError):
        mesh.shard_decode_inputs(_cpu_mesh(3, 1), ops, model, ev)
    with pytest.raises(ValueError):
        mesh.shard_decode_inputs(_cpu_mesh(1, 3), ops, model, ev)
    with pytest.raises(ValueError):
        mesh.shard_decode_inputs(_cpu_mesh(2, 1), ops, hmm.ModelArrays(
            *(x[:3] for x in model)), ev)
    with pytest.raises(ValueError):
        statepar.split_table_states(ops, model, ev, [CPU] * 3)


def test_generic_slice_kernel_counts():
    """roofline's counts of K6am and K6bm are those of the function a data
    row's decode computes, whatever its ranks: the resident and streaming
    K6a's with backpointers, and K6b's; the column exchange and the walk's
    copies from the peers' slices apart (statepar_exchange_bytes, as
    K1m's and K2m's)."""
    for T_ in (1, 8192):
        for deg in (21, 25):
            assert roofline.kernel_counts(
                "viterbi_generic_wave_resident", 128, T_, deg) == \
                roofline.kernel_counts("viterbi_resident_forward_path", 128,
                                       T_, deg)
            assert roofline.kernel_counts(
                "viterbi_generic_wave_streaming", 128, T_, deg) == \
                roofline.kernel_counts("viterbi_generic_forward_path", 128,
                                       T_, deg)
        assert roofline.kernel_counts("viterbi_generic_traceback_slices",
                                      128, T_) == \
            roofline.kernel_counts("viterbi_generic_traceback", 128, T_)
    b = roofline.kernel_bound("viterbi_generic_wave_resident", 128, 8192)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(
        1e3 * 82.0 * 128 * 8192 * 4096 / roofline.H100_F32_OPS_PER_S)
