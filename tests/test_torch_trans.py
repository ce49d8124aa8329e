"""The port under a loaded transition table (`--trans`) against
nanocall_tpu, on the CPU: convert.trans_ops, the generic kernels K6a-K6c
and the grouped backward K6d (nanocall_tpu_torch.ops.hmm), and the legacy
EM round of nanocall_tpu_torch.train.

Inputs are tests/test_torch_train.py's per-row fixtures, made from numpy
seeds: short rows at K = 3 (n = 64) and at the builtin models' width
(K = 6, n = 4096), with lengths 0, 1, T-1 and T.  Three tables, all of
p_stay 0.14 and p_skip 0.21: the structured 21-slot table
(StructuredTransitions), the same table written as a transitions TSV and
loaded back (`-s`: a SparseTransitions of in-degree 21), and the exact
table at the default cutoff 1e-3 (compute_transitions_dense).  On the CPU
the port runs the plain versions; chip_smoke.py holds the CUDA kernels to
them bit for bit on the card.

Tolerances, and why (PR 1 and PR 2 state the same): XLA's jitted scan
bodies reorder the emission (up to 5e-4 absolute,
test_torch_hmm.py::test_log_emission_matches_jax) and their sums, so
Viterbi paths and backpointers are equal (the seeded fixtures hold no
near-ties), logp and final alphas agree to rtol 1e-5; forward-backward
alphas and betas to rtol 1e-5 where a state's weight is above e^-80 of its
row's maximum (XLA on the CPU flushes denormals, torch does not), ems to
rtol 1e-5 or atol 5e-4, log Pr[data] to rtol 1e-6.  One legacy round's
scaling parameters agree to rtol 2e-3 / atol 1e-3 and its transition
parameters to rtol 5e-3 / atol 1e-4 (the 3x3 solve amplifies the moments'
float32 differences); run_em takes the same rounds and frozen flags.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import oracle
from nanocall_tpu import pore_model, train as jtrain, transitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, train, transitions as ttransitions
from nanocall_tpu_torch.ops import hmm, kernels
from test_torch_train import _assert_alphas_close, _rows
from test_train import K, build_train_batch, make_models, sample_events
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_STAY, P_SKIP = 0.14, 0.21
CASES = {  # K: (B, T, lengths), lengths 0, 1, T-1 and T among them
    3: (6, 40, [40, 0, 1, 39, 25, 33]),
    6: (5, 12, [12, 0, 1, 11, 7]),
}
KINDS = ("structured", "loaded", "dense")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(K, kind) -> (the JAX package's table, the port's), built once per
    module; the port loads a TSV with its own loader."""
    d = tmp_path_factory.mktemp("trans")

    @functools.lru_cache(maxsize=None)
    def get(K_, kind):
        st = transitions.build_structured(
            transitions.TransitionParams(P_STAY, P_SKIP), K_)
        if kind == "structured":
            return st, ttransitions.build_structured(
                ttransitions.TransitionParams(P_STAY, P_SKIP), K_)
        if kind == "loaded":
            path = str(d / f"trans{K_}.tsv")
            transitions.save_tsv(st, path)
            return (transitions.load_tsv(path, K_),
                    ttransitions.load_tsv(path, K_))
        dense = transitions.compute_transitions_dense(P_SKIP, P_STAY, 1e-3,
                                                      K_)
        return dense, ttransitions.SparseTransitions(
            dense.from_idx, dense.from_logp, dense.to_idx, dense.to_logp, K_)

    return get


def _both_ops(tables):
    return jhmm.make_trans_ops(tables[0]), convert.trans_ops(tables[1], CPU)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K_", sorted(CASES))
def test_trans_ops_match_jax(tables, K_, kind):
    """The port's slot tables are the JAX package's; a structured table
    gets the fixed slot layout's index maps (slot_from_state)."""
    table = tables(K_, kind)
    ops_j, ops_t = _both_ops(table)
    assert ops_t.from_idx.dtype == ops_t.to_idx.dtype == torch.int32
    assert ops_t.from_logp.dtype == ops_t.to_logp.dtype == torch.float32
    assert ops_t.K == K_
    if kind == "structured":
        idx = (transitions.slot_from_state(K_),
               transitions._slot_maps(K_)[1])
    else:
        idx = (np.asarray(ops_j.from_idx), np.asarray(ops_j.to_idx))
    np.testing.assert_array_equal(ops_t.from_idx.numpy(), idx[0])
    np.testing.assert_array_equal(ops_t.to_idx.numpy(), idx[1])
    np.testing.assert_array_equal(ops_t.from_logp.numpy(),
                                  np.asarray(ops_j.from_logp))
    np.testing.assert_array_equal(ops_t.to_logp.numpy(),
                                  np.asarray(ops_j.to_logp))
    if K_ == 6:  # the r73 width: in-degree 21 for all three
        assert ops_t.from_idx.shape == (21, 4096)


@pytest.mark.parametrize("deg", [256, 257])
def test_trans_ops_refuses_more_than_256_slots(deg):
    """A uint8 backpointer names at most 256 slots: a table whose in-degree
    exceeds that is refused where it is converted."""
    n = 64
    idx = np.tile(np.arange(deg, dtype=np.int32)[:, None] % n, (1, n))
    lp = np.full((deg, n), -5.0, np.float32)
    table = ttransitions.SparseTransitions(
        from_idx=idx, from_logp=lp, to_idx=idx[:1], to_logp=lp[:1], K=3)
    if deg > 256:
        with pytest.raises(ValueError, match="in-degree 257"):
            convert.trans_ops(table, CPU)
    else:
        assert convert.trans_ops(table, CPU).from_idx.shape == (256, n)


def _case(K_, seed):
    B, T, lengths = CASES[K_]
    return _rows(K_, np.random.default_rng(seed), B, T, lengths)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K_", sorted(CASES))
def test_viterbi_matches_jax(tables, K_, kind):
    """K6a (path and score-only) and K6b against viterbi_forward /
    viterbi_traceback: equal backpointers and paths, logp and final alpha
    within rtol 1e-5."""
    ops_j, ops_t = _both_ops(tables(K_, kind))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _case(K_, 20 + K_)
    fa_j, bps_j = jhmm.viterbi_forward(ops_j, m_j, ev_j)
    fa_t, bps_t = hmm.viterbi_forward(ops_t, m_t, ev_t)
    assert bps_t.dtype == torch.uint8
    np.testing.assert_array_equal(bps_t.numpy(), np.asarray(bps_j))
    np.testing.assert_allclose(fa_t.numpy(), np.asarray(fa_j), rtol=1e-5)
    path_j, lp_j = jhmm.viterbi_traceback(ops_j, fa_j, bps_j, ev_j["length"])
    path_t, lp_t = hmm.viterbi_traceback(ops_t, fa_t, bps_t, ev_t["length"])
    assert path_t.dtype == torch.uint16 and path_t.shape == fa_t.shape[:1] \
        + (CASES[K_][1],)
    np.testing.assert_array_equal(path_t.numpy().astype(np.int64),
                                  np.asarray(path_j).astype(np.int64))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    score = hmm.viterbi_decode(ops_t, m_t, ev_t, with_path=False)
    assert list(score) == ["logp"] and torch.equal(score["logp"], lp_t)
    fa_s, none = hmm.viterbi_forward(ops_t, m_t, ev_t, with_path=False)
    assert none is None and torch.equal(fa_s, fa_t)
    dec = hmm.viterbi_decode(ops_t, m_t, ev_t)
    assert torch.equal(dec["path"], path_t) and torch.equal(dec["logp"], lp_t)


def _emissions64(m_t, ev_t, b: int, L: int) -> np.ndarray:
    """(L, n) float64 emissions of row b's first L events."""
    rows = hmm.ModelArrays(*(x[b].double() for x in m_t))
    return hmm.log_emission(rows, *(ev_t[k][b, :L].double() for k in (
        "mean", "stdv", "log_stdv"))).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_generic_kernels_match_the_oracle(tables, kind):
    """At K = 3, the port's paths, logp and log Pr[data] against the dense
    float64 oracle of tests/oracle.py (Viterbi.hpp's and
    Forward_Backward.hpp's loops): equal paths over each read's events,
    logp and log Pr[data] within rtol 1e-5."""
    table = tables(3, kind)
    M = oracle.dense_logp(table[0], 3)
    _, ops_t = _both_ops(table)
    (_, _, _), (_, m_t, ev_t), _ = _case(3, 23)
    dec = hmm.viterbi_decode(ops_t, m_t, ev_t)
    fb = hmm.fwbw(ops_t, m_t, ev_t)
    for b, L in enumerate(CASES[3][2]):
        if L == 0:
            continue
        em = _emissions64(m_t, ev_t, b, L)
        path, logp = oracle.viterbi(M, em)
        np.testing.assert_array_equal(dec["path"][b, :L].numpy(), path)
        np.testing.assert_allclose(float(dec["logp"][b]), logp, rtol=1e-5)
        _, _, lpd = oracle.fwbw(M, em)
        np.testing.assert_allclose(float(fb["log_pr_data"][b]), lpd,
                                   rtol=1e-5)


def _assert_fwbw_close(got: dict, want: dict) -> None:
    for k in ("alpha", "beta"):
        assert got[k].shape == np.shape(want[k]), k
        _assert_alphas_close(got[k].numpy(), want[k])
    np.testing.assert_allclose(got["em"].numpy(), np.asarray(want["em"]),
                               rtol=1e-5, atol=5e-4)
    np.testing.assert_allclose(got["log_pr_data"].numpy(),
                               np.asarray(want["log_pr_data"]), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K_", sorted(CASES))
def test_fwbw_matches_jax(tables, K_, kind):
    """K6c against hmm.fwbw: alpha and beta rtol 1e-5 above e^-80, em rtol
    1e-5 or atol 5e-4, log Pr[data] rtol 1e-6; beta is 0 from t = length-1
    on, and alpha repeats its last row past a read's length."""
    ops_j, ops_t = _both_ops(tables(K_, kind))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _case(K_, 30 + K_)
    want = jhmm.fwbw(ops_j, m_j, ev_j, keep_emissions=True)
    got = hmm.fwbw(ops_t, m_t, ev_t)
    _assert_fwbw_close(got, want)
    for b, L in enumerate(CASES[K_][2]):
        assert (got["beta"][b, max(L - 1, 0):] == 0).all()
        if L:
            assert torch.equal(got["alpha"][b, L:],
                               got["alpha"][b, L - 1].expand_as(
                                   got["alpha"][b, L:]))


@pytest.mark.parametrize("K_", sorted(CASES))
def test_fwbw_grouped_matches_jax(K_):
    """fwbw_grouped (K4's alphas, K6d's betas, the emissions) against
    hmm.fwbw_grouped at the same tolerances; K6d's betas alone through
    fwbw_grouped_backward."""
    (g_j, m_j, ev_j), (g_t, m_t, ev_t), _ = _case(K_, 40 + K_)
    want = jhmm.fwbw_grouped(g_j, m_j, ev_j, keep_emissions=True)
    got = hmm.fwbw_grouped(g_t, m_t, ev_t)
    _assert_fwbw_close(got, want)
    beta = hmm.fwbw_grouped_backward(g_t, m_t, ev_t)
    assert torch.equal(beta, got["beta"])


@pytest.mark.parametrize("K_", sorted(CASES))
def test_fwbw_grouped_equals_generic_under_the_structured_table(tables, K_):
    """The grouped decomposition is exact: under the structured table of
    the same (p_stay, p_skip), the generic forward-backward gives the same
    log Pr[data] (rtol 1e-5) and posteriors."""
    B = CASES[K_][0]
    (_, _, _), (g_t, m_t, ev_t), _ = _case(K_, 50 + K_)
    p = torch.full((B,), P_STAY), torch.full((B,), P_SKIP)
    gtf = hmm.make_grouped_full_device(*p, K=K_)
    _, ops_t = _both_ops(tables(K_, "structured"))
    a = hmm.fwbw_grouped(gtf, m_t, ev_t)
    b = hmm.fwbw(ops_t, m_t, ev_t)
    np.testing.assert_allclose(a["log_pr_data"].numpy(),
                               b["log_pr_data"].numpy(), rtol=1e-5)
    for fb in (a, b):
        fb["post"] = torch.exp(fb["alpha"] + fb["beta"]
                               - fb["log_pr_data"][:, None, None])
    np.testing.assert_allclose(a["post"].numpy(), b["post"].numpy(),
                               atol=1e-4)


@pytest.fixture(scope="module")
def loaded3(tables):
    """The K = 3 loaded table, for both packages, and the CLI priors."""
    return (*_both_ops(tables(3, "loaded")), np.float32([0.1, 0.3]))


@pytest.fixture(scope="module")
def mixed_batch():
    """test_torch_train.py's two K = 3 groups (mixed strands, a padding
    row, a length-1 row), with group 0's strand 1 at the CLI priors and the
    other strands trained: the round's rows take both E-steps."""
    rng = np.random.default_rng(42)
    models = make_models(rng)
    g0 = [(sample_events(models[0], 25, rng), 0),
          (sample_events(models[0], 18, rng), 0),
          (sample_events(models[1], 22, rng), 1),
          (sample_events(models[1], 27, rng), 1)]
    g1 = [(sample_events(models[0], 30, rng), 0),
          (sample_events(models[0], 1, rng), 0)]
    pm = [pore_model.PoreModelParams(scale=1.05, shift=-1.0, drift=0.002),
          pore_model.PoreModelParams(scale=0.97, shift=0.5, drift=-0.001)]
    st = [[[0.11, 0.29], [0.1, 0.3]], [[0.09, 0.31], [0.12, 0.28]]]
    return build_train_batch([g0, g1], models, pm, st)


ROUND_FLAGS = {
    "drift": dict(train_drift=True),
    "no_drift": dict(train_drift=False),
    "no_train_transitions": dict(train_drift=True, train_transitions=False),
    "no_train_scaling": dict(train_drift=True, train_scaling=False),
    "fit_only": dict(train_drift=True, train_scaling=False,
                     train_transitions=False),
}


@pytest.mark.parametrize("name", sorted(ROUND_FLAGS))
def test_legacy_round_matches_jax(mixed_batch, loaded3, name):
    """train_one_round under a loaded table (the legacy round) against
    JAX's: fit rtol 1e-5, scaling params rtol 2e-3 / atol 1e-3, transition
    params rtol 5e-3 / atol 1e-4, equal singular flags."""
    kw = ROUND_FLAGS[name]
    ops_j, ops_t, pri = loaded3
    ev, mdl, pm, st = mixed_batch
    want = jtrain.train_one_round(ev, mdl, pm, st, K=K, default_ops=ops_j,
                                  default_priors=pri, **kw)
    got = train.train_one_round(*convert.train_batch(ev, mdl, pm, st, CPU),
                                K=K, default_ops=ops_t, default_priors=pri,
                                **kw)
    np.testing.assert_allclose(got["fit"].numpy(), np.asarray(want["fit"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["new_pm_params"].numpy(),
                               np.asarray(want["new_pm_params"]), rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["new_st_params"].numpy(),
                               np.asarray(want["new_st_params"]), rtol=5e-3,
                               atol=1e-4)
    assert np.array_equal(got["done"].numpy(), np.asarray(want["done"]))
    # the loaded table moves the fit away from the grouped round's
    plain = train.train_one_round(*convert.train_batch(ev, mdl, pm, st, CPU),
                                  K=K, **kw)
    assert not torch.equal(plain["fit"], got["fit"])


def test_legacy_estep_selects_rows_by_strand_params(mixed_batch, loaded3):
    """A row whose strand is at the priors takes the generic E-step under
    the loaded table, every other row the grouped one, value for value."""
    _, ops_t, pri = loaded3
    ev, mdl, pm, st = convert.train_batch(*mixed_batch, CPU)
    inp = train.round_inputs(ev, mdl, pm, st, K=K)
    fb = train._legacy_estep(inp, ops_t, pri)
    gen = hmm.fwbw(ops_t, inp["model"], inp["ev"])
    grp = hmm.fwbw_grouped(inp["gtf"], inp["model"], inp["ev"])
    at_priors = [False, False, True, True, False, False, False, False]
    for b, generic in enumerate(at_priors):
        want = gen if generic else grp
        for k in ("alpha", "beta", "em", "log_pr_data"):
            assert torch.equal(fb[k][b], want[k][b]), (b, k)


@pytest.fixture(scope="module")
def em_groups():
    """tests/test_torch_train.py's EM groups: three joint groups and one
    single-strand group, all starting at the priors."""
    rng = np.random.default_rng(17)
    models = make_models(rng)
    groups = [[(sample_events(models[0], 30, rng, scale=1.1, shift=2.0), 0),
               (sample_events(models[1], 25, rng, scale=1.1, shift=2.0), 1)]
              for _ in range(3)]
    groups.append([(sample_events(models[0], 28, rng, scale=1.1, shift=2.0),
                    0)])
    pm0 = [pore_model.PoreModelParams(scale=1.0, shift=1.0)] * 4
    st0 = [[[0.1, 0.3], [0.1, 0.3]]] * 4
    return build_train_batch(groups, models, pm0, st0), [True] * 3 + [False]


@pytest.mark.parametrize("train_transitions", [True, False])
def test_run_em_under_a_loaded_table_matches_jax(em_groups, loaded3,
                                                 train_transitions):
    """run_em with a loaded table: round 1 E-steps every row under it; with
    transitions trained the later rounds take the grouped tables, without
    every round stays under the table.  Same rounds and frozen flags as
    the JAX run_em; parameters within the one-round tolerances, except
    the scaling parameters' atol of 5e-3: each round's solve amplifies the
    moments' float32 differences again, and over these rounds a shift near
    0 pA moves 2.8e-3 (measured)."""
    batch, joint = em_groups
    ops_j, ops_t, pri = loaded3
    cfg = train.EMConfig(K=K, train_drift=False, max_rounds=3,
                         train_transitions=train_transitions)
    caps = cfg.caps(joint)
    want = jtrain.run_em(*batch, jtrain.EMConfig(**dataclasses.asdict(cfg)),
                         caps=caps, default_ops=ops_j, default_priors=pri)
    got = train.run_em(*convert.train_batch(*batch, CPU), cfg, caps=caps,
                       default_ops=ops_t, default_priors=pri)
    pm, st, fit, rounds, frozen = (x.numpy() for x in got)
    assert np.array_equal(rounds, want[3]), (rounds, want[3])
    assert np.array_equal(frozen, want[4])
    assert rounds.max() >= 2
    np.testing.assert_allclose(pm, want[0], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(st, want[1], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(fit, want[2], rtol=1e-4)
    if not train_transitions:
        assert (st == pri).all()


@pytest.fixture(scope="module")
def k6_rows(tables):
    (_, _, _), (g_t, m_t, ev_t), _ = _case(6, 3)
    return g_t, m_t, ev_t, _both_ops(tables(6, "loaded"))[1]


def test_generic_kernel_wrappers_refuse_cpu_and_bad_inputs(k6_rows):
    """The CUDA wrappers check their inputs and take CUDA tensors only: a
    CPU tensor never reaches a plain version through them."""
    g_t, m_t, ev_t, ops = k6_rows
    fa, bps = hmm.viterbi_forward_plain(ops, m_t, ev_t)
    calls = {
        "generic forward": lambda o, e: hmm.generic_forward_path_kernel(
            o, m_t, e),
        "generic score": lambda o, e: hmm.generic_forward_score_kernel(
            o, m_t, e),
        "generic fwbw": lambda o, e: hmm.fwbw_generic_kernel(o, m_t, e),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(ops, ev_t)
        with pytest.raises(ValueError, match="K=6"):
            call(ops._replace(K=3), ev_t)
        with pytest.raises(ValueError, match="float32"):
            call(ops, {**ev_t, "mean": ev_t["mean"].double()})
        with pytest.raises(ValueError, match="int32"):
            call(ops._replace(from_idx=ops.from_idx.long()), ev_t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hmm.generic_traceback_kernel(ops, fa, bps, ev_t["length"])
    with pytest.raises(ValueError, match="uint8"):
        hmm.generic_traceback_kernel(ops, fa, bps.int(), ev_t["length"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        hmm.fwbw_backward_kernel(g_t, m_t, ev_t)
    with pytest.raises(ValueError, match="K=6"):
        hmm.fwbw_backward_kernel(g_t._replace(K=3), m_t, ev_t)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name


def test_generic_dispatchers_refuse_other_devices(k6_rows):
    g_t, m_t, ev_t, ops = k6_rows
    meta = torch.device("meta")
    ev_m = {k: v.to(meta) for k, v in ev_t.items()}
    for call in (lambda: hmm.viterbi_forward(ops, m_t, ev_m),
                 lambda: hmm.fwbw(ops, m_t, ev_m),
                 lambda: hmm.fwbw_grouped_backward(g_t, m_t, ev_m),
                 lambda: hmm.viterbi_traceback(
                     ops, ev_m["mean"], ev_m["mean"], ev_m["length"])):
        with pytest.raises(ValueError, match="device"):
            call()


def test_kernel_registry_names_each_source_and_jax_function():
    """ops/kernels.py lists every kernel once, with its source in the
    repository and the file:line of the JAX function it replaces."""
    names = [k.name for k in kernels.KERNELS]
    assert len(set(names)) == len(names)
    assert {"viterbi_generic_forward_path", "viterbi_generic_forward_score",
            "viterbi_generic_traceback", "fwbw_generic",
            "fwbw_grouped_backward"} <= set(names)
    for k in kernels.KERNELS:
        assert os.path.isfile(os.path.join(ROOT, k.source)), k.source
        path, line = k.replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as fh:
            lines = fh.read().splitlines()
        assert 0 < int(line) <= len(lines) and lines[int(line) - 1].strip()
    # the generic kernels replace these JAX functions
    by_name = {k.name: k.replaces for k in kernels.KERNELS}
    for name, fn in (("viterbi_generic_forward_path", "viterbi_forward"),
                     ("viterbi_generic_forward_score", "viterbi_decode"),
                     ("viterbi_generic_traceback", "viterbi_traceback"),
                     ("fwbw_generic", "fwbw"),
                     ("fwbw_grouped_backward", "bwd_step")):
        path, line = by_name[name].rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as fh:
            text = fh.read().splitlines()[int(line) - 1]
        assert f"def {fn}(" in text, (name, text)
