"""The port's EM training (nanocall_tpu_torch.train, K4 in ops.hmm, K5 in
ops.em) against nanocall_tpu, on the CPU.

Both packages get the same inputs, made from numpy seeds: the K = 3 groups
of tests/test_train.py (n = 64), and a few short rows at the builtin
models' width (K = 6, n = 4096).  On the CPU the port runs the plain
PyTorch versions of K4 and K5; chip_smoke.py holds the CUDA kernels to
them bit for bit on the card.

Tolerances, and why: the port sums in a fixed pairwise order where XLA's
jitted program accumulates in its own order (against float64 sums on the
r73 fixture, the JAX moments are off by ~2e-6 relative and the port's by
~2e-7: test_torch_pipeline_trained.py::
test_moment_sums_closer_to_float64_than_jax), so values agree to float32
reassociation: alphas rtol 1e-5, log Pr[data] rtol 1e-6, moments rtol 1e-4,
log totals atol 1e-4.  The 3x3 weighted-least-squares solve amplifies the
moments' differences through its conditioning
(tests/test_reference_pipeline_golden.py:587-598), so one round's scaling
parameters agree to rtol 2e-3 / atol 1e-3, the transition parameters to
rtol 5e-3 / atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from nanocall_tpu import pore_model, train as jtrain, transitions
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, train
from nanocall_tpu_torch.ops import em, hmm
from test_train import K, build_train_batch, make_models, sample_events
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _t(x, dtype=torch.float32):
    return convert.tensor(x, CPU, dtype)


def _assert_alphas_close(got, want) -> None:
    """Alphas within rtol 1e-5 wherever a state's weight exp(alpha - max)
    is above e^-80.  Below that, denormals decide: XLA on the CPU flushes
    them to zero and torch does not, so such a state may be -inf in one
    package and finite in the other, or differ in a low digit; it must
    still be more than 80 below its row's maximum on both sides."""
    want = np.asarray(want)
    far = [x <= np.max(x, -1, keepdims=True) - 80.0 for x in (got, want)]
    near = ~far[0] | ~far[1]
    np.testing.assert_allclose(got[near], want[near], rtol=1e-5)
    assert (far[0] == far[1]).all()


@pytest.fixture(scope="module")
def batch3():
    """Two K=3 groups (test_train.py::test_fused_round_matches_legacy):
    mixed strands, a padding row, and a length-1 row."""
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


def _rows(K_, rng, B, T, lengths):
    """Per-row E-step inputs for both packages at width K_: (jax gtf,
    model, ev; torch gtf, model, ev; K5's extra inputs as numpy)."""
    n = 4 ** K_
    if K_ == 6:
        ms = load_builtin_models("r73")
        names = ("r73.t.006", "r73.c.p1.006")
        bank = {f: np.stack([getattr(ms[m], f) for m in names])
                for f in convert.BANK_FIELDS}
    else:
        m3 = make_models(rng)
        bank = {f: np.stack([getattr(m3[st], f) for st in (0, 1)])
                for f in convert.BANK_FIELDS}
    idx = np.arange(B) % 2
    pm = np.zeros((B, 6), np.float32)
    pm[:, 0] = rng.uniform(0.95, 1.05, B)
    pm[:, 1] = rng.uniform(-1.0, 1.0, B)
    pm[:, 3:] = rng.uniform(0.9, 1.1, (B, 3))
    ps = rng.uniform(0.05, 0.2, B).astype(np.float32)
    pk = rng.uniform(0.2, 0.4, B).astype(np.float32)
    states = rng.integers(0, n, (B, T))
    lm = bank["level_mean"][idx][np.arange(B)[:, None], states]
    mean = (lm * pm[:, :1] + pm[:, 1:2]
            + rng.normal(0.0, 1.0, (B, T))).astype(np.float32)
    stdv = rng.uniform(0.6, 1.8, (B, T)).astype(np.float32)
    start = np.cumsum(rng.uniform(0.01, 0.03, (B, T)), 1).astype(np.float32)
    for b, L in enumerate(lengths):
        mean[b, L:], stdv[b, L:], start[b, L:] = 1.0, 1.0, 0.0
    ev = {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
          "length": np.asarray(lengths, np.int32)}
    m_j = jhmm.make_model_arrays(
        bank["level_mean"][idx] * pm[:, :1] + pm[:, 1:2],
        bank["level_stdv"][idx] * pm[:, 3:4],
        bank["sd_mean"][idx] * pm[:, 4:5],
        bank["sd_lambda"][idx] * pm[:, 5:6])
    g_j = jhmm.make_grouped_full_device(ps, pk, K=K_)
    ls_u, lm_u = bank["level_stdv"][idx], bank["level_mean"][idx]
    sm_u, sl_u = bank["sd_mean"][idx], bank["sd_lambda"][idx]
    w0 = 1.0 / (ls_u * ls_u)
    W = np.stack([w0, w0 * lm_u, w0 * lm_u * lm_u, sl_u, sl_u / sm_u,
                  sl_u / sm_u / sm_u], -1).astype(np.float32)  # (B, n, 6)
    extra = {"W": W, "x_unc": mean + 0.5, "t_start": start,
             "valid": np.arange(B) != B - 1, "p_stay": ps, "p_skip": pk}
    ev_j = {k: jnp.asarray(v) for k, v in ev.items()}
    g_t = hmm.GroupedTransFull(*(_t(getattr(g_j, f)) for f in (
        "stay_lp", "step_lp", "skip_lp", "step_to_lp", "skip_to_lp")), K=K_)
    m_t = hmm.ModelArrays(*(_t(x) for x in m_j))
    ev_t = {k: _t(v, torch.int32 if k == "length" else torch.float32)
            for k, v in ev.items()}
    return (g_j, m_j, ev_j), (g_t, m_t, ev_t), extra


CASES = {  # K: (B, T, lengths)
    3: (6, 40, [40, 33, 1, 0, 39, 25]),
    6: (4, 12, [12, 1, 11, 7]),
}


@pytest.mark.parametrize("ps,pk", [(0.1, 0.3), (0.05, 0.4), (0.4, 0.05),
                                   (0.09, 0.28)])
@pytest.mark.parametrize("K_", [3, 6])
def test_grouped_full_tables_match_jax_to_one_ulp(K_, ps, pk):
    want = jhmm.make_grouped_full_device(np.float32([ps, ps]),
                                         np.float32([pk, pk]), K=K_)
    got = hmm.make_grouped_full_device(torch.tensor([ps, ps]),
                                       torch.tensor([pk, pk]), K_)
    assert got.K == K_
    for f in ("stay_lp", "step_lp", "skip_lp", "step_to_lp", "skip_to_lp"):
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.shape == (2, 4 ** K_)
        assert _ulps(getattr(want, f), g.numpy()) <= 1, f


@pytest.mark.parametrize("K_", [3, 6])
def test_correction_masks_and_flags(K_):
    masks = hmm.correction_masks(K_, CPU)
    want = transitions.grouped_correction_masks(K_)
    assert set(masks) == set(want)
    for k, v in want.items():
        assert np.array_equal(masks[k].numpy(), v), k
    fl = hmm.mask_flags({**masks, "subset": torch.from_numpy(
        train.st_train_mask(K_) > 0)}, em.BWD_FLAG_BITS).numpy()
    assert fl.dtype == np.uint8 and fl.shape == (4 ** K_,)
    for name, bit in em.BWD_FLAG_BITS.items():
        ref = want[name] if name in want else train.st_train_mask(K_)
        assert np.array_equal((fl >> bit) & 1, ref > 0), name
    assert np.array_equal(train.st_train_kmers(K_),
                          jtrain.st_train_kmers(K_))


@pytest.mark.parametrize("K_", sorted(CASES))
def test_fwbw_forward_matches_jax(K_):
    B, T, lengths = CASES[K_]
    (g_j, m_j, ev_j), (g_t, m_t, ev_t), _ = _rows(
        K_, np.random.default_rng(K_), B, T, lengths)
    a_j, _, lpd_j = jax.jit(jhmm.fwbw_grouped_forward)(g_j, m_j, ev_j)
    a_t, lpd_t = hmm.fwbw_grouped_forward(g_t, m_t, ev_t)
    assert a_t.shape == (T, B, 4 ** K_) and lpd_t.shape == (B,)
    _assert_alphas_close(a_t.numpy(), a_j)
    np.testing.assert_allclose(lpd_t.numpy(), np.asarray(lpd_j), rtol=1e-6)
    # the fit-only form stores no alphas and gives the same log Pr[data]
    none, lpd2 = hmm.fwbw_grouped_forward(g_t, m_t, ev_t, with_alphas=False)
    assert none is None and torch.equal(lpd2, lpd_t)


@pytest.mark.parametrize("flags", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("K_", sorted(CASES))
def test_fused_bwd_mstats_matches_jax(K_, flags):
    B, T, lengths = CASES[K_]
    (g_j, m_j, ev_j), (g_t, m_t, ev_t), x = _rows(
        K_, np.random.default_rng(10 + K_), B, T, lengths)
    alphas, _, lpd = jax.jit(jhmm.fwbw_grouped_forward)(g_j, m_j, ev_j)
    subset = train.st_train_mask(K_) > 0
    ts, tt = flags
    scal_j, st_j = jtrain._fused_bwd_mstats(
        g_j, m_j, ev_j, lpd, alphas, jnp.asarray(x["W"]),
        jnp.asarray(x["x_unc"]), jnp.asarray(x["t_start"]),
        jnp.asarray(x["valid"]), jnp.asarray(subset),
        jnp.asarray(x["p_stay"]), jnp.asarray(x["p_skip"]), ts, tt)
    scal_t, st_t = em.fused_bwd_mstats(
        g_t, m_t, ev_t, _t(lpd), _t(alphas),
        _t(x["W"]).permute(0, 2, 1).contiguous() if ts else None,
        _t(x["x_unc"]), _t(x["t_start"]), _t(x["valid"], torch.bool),
        torch.from_numpy(subset), _t(x["p_stay"]), _t(x["p_skip"]), ts, tt)
    assert scal_t.shape == (B, 14) and st_t.shape == (B, 3)
    for i, k in enumerate(em.SCAL_NAMES):
        np.testing.assert_allclose(scal_t[:, i].numpy(),
                                   np.asarray(scal_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for i, k in enumerate(em.ST_NAMES):
        want = np.asarray(st_j[k])
        np.testing.assert_allclose(st_t[:, i].numpy(), want, rtol=0,
                                   atol=1e-4, err_msg=k)
        if tt:
            # rows with a transition window give finite totals; the
            # invalid row and rows of length < 2 give -inf
            L = np.asarray(lengths)
            assert np.isfinite(want[(L > 1) & x["valid"]]).all()
            assert np.isneginf(want[(L < 2) | ~x["valid"]]).all()
        else:
            assert np.isneginf(st_t[:, i].numpy()).all()


ROUND_FLAGS = {
    "drift": dict(train_drift=True),
    "no_drift": dict(train_drift=False),
    "no_train_transitions": dict(train_drift=True, train_transitions=False),
    "no_train_scaling": dict(train_drift=True, train_scaling=False),
    "fit_only": dict(train_drift=True, train_scaling=False,
                     train_transitions=False),
}


@pytest.mark.parametrize("name", sorted(ROUND_FLAGS))
def test_train_one_round_matches_jax(batch3, name):
    kw = ROUND_FLAGS[name]
    ev, mdl, pm, st = batch3
    want = jtrain.train_one_round(ev, mdl, pm, st, K=K, **kw)
    got = train.train_one_round(*convert.train_batch(ev, mdl, pm, st, CPU),
                                K=K, **kw)
    np.testing.assert_allclose(got["fit"].numpy(), np.asarray(want["fit"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["new_pm_params"].numpy(),
                               np.asarray(want["new_pm_params"]), rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["new_st_params"].numpy(),
                               np.asarray(want["new_st_params"]), rtol=5e-3,
                               atol=1e-4)
    assert np.array_equal(got["done"].numpy(), np.asarray(want["done"]))
    if not kw.get("train_scaling", True):
        assert torch.equal(got["new_pm_params"], _t(pm))
    if not kw.get("train_transitions", True):
        assert torch.equal(got["new_st_params"], _t(st))


def test_train_one_round_takes_a_model_bank(batch3):
    """A (M, 2, n) bank plus model_idx gives the same round as per-group
    tables."""
    ev, mdl, pm, st = batch3
    bank = {k: np.stack([v[1], v[0]]) for k, v in mdl.items()}
    bank["model_idx"] = np.array([1, 0], np.int32)
    a = train.train_one_round(*convert.train_batch(ev, mdl, pm, st, CPU), K=K)
    b = train.train_one_round(*convert.train_batch(ev, bank, pm, st, CPU),
                              K=K)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("train_drift", [True, False])
def test_one_round_matches_oracle(train_drift):
    """The port's round against the numpy oracle, at
    tests/test_train.py::test_one_round_matches_oracle's tolerances."""
    rng = np.random.default_rng(7)
    models = make_models(rng)
    seqs = [(sample_events(models[0], 25, rng), 0),
            (sample_events(models[0], 20, rng), 0),
            (sample_events(models[1], 22, rng), 1)]
    pm_params = pore_model.PoreModelParams(scale=1.05, shift=-1.0,
                                           drift=0.002)
    st_params = [[[0.11, 0.29], [0.1, 0.3]]]
    batch = build_train_batch([seqs], models, [pm_params], st_params)
    out = train.train_one_round(*convert.train_batch(*batch, CPU), K=K,
                                train_drift=train_drift)
    scaled = {st: models[st].scaled(pm_params) for st in (0, 1)}
    fwbw_res, ems, fit_ref = [], [], 0.0
    for e, st in seqs:
        tp = transitions.TransitionParams(*st_params[0][st])
        M = oracle.dense_logp(transitions.build_structured(tp, K), K)
        em = oracle.emissions(
            (scaled[st].level_mean, scaled[st].level_stdv,
             scaled[st].sd_mean, scaled[st].sd_lambda), e,
            drift=pm_params.drift)
        a, b, lpd = oracle.fwbw(M, em)
        fwbw_res.append((a, b, lpd))
        ems.append(em)
        fit_ref += lpd
    assert np.isclose(float(out["fit"][0]), fit_ref, rtol=1e-4, atol=1e-2)
    mdl_arrays = {st: (models[st].level_mean, models[st].level_stdv,
                       models[st].sd_mean, models[st].sd_lambda)
                  for st in (0, 1)}
    params_ref, done_ref = oracle.train_pm_params(seqs, mdl_arrays, fwbw_res,
                                                  train_drift)
    assert not done_ref and not bool(out["done"][0])
    assert np.allclose(out["new_pm_params"][0].double().numpy(), params_ref,
                       rtol=2e-3, atol=2e-3)
    st_ref = oracle.train_st_params(
        seqs, scaled, fwbw_res, ems, {0: st_params[0][0], 1: st_params[0][1]},
        K)
    for st in (0, 1):
        assert np.allclose(out["new_st_params"][0, st].numpy(), st_ref[st],
                           rtol=5e-3, atol=5e-4), st


@pytest.fixture(scope="module")
def em_groups():
    """Three joint groups and one single-strand group (mixed caps)."""
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


@pytest.mark.parametrize("min_progress", [1.0, -1e9])
def test_run_em_matches_jax(em_groups, min_progress):
    """Same stopping decisions (rounds, frozen) as the JAX run_em, and
    parameters within the one-round tolerances."""
    batch, joint = em_groups
    cfg = dataclasses.replace(train.EMConfig(K=K, train_drift=False,
                                             max_rounds=4),
                              min_progress=min_progress)
    jcfg = jtrain.EMConfig(**dataclasses.asdict(cfg))
    caps = cfg.caps(joint)
    assert caps.tolist() == [8, 8, 8, 4]
    want = jtrain.run_em(*batch, jcfg, caps=caps)
    got = train.run_em(*convert.train_batch(*batch, CPU), cfg, caps=caps)
    pm, st, fit, rounds, frozen = (x.numpy() for x in got)
    assert fit.dtype == np.float32 and rounds.dtype == np.int32
    assert np.array_equal(rounds, want[3]), (rounds, want[3])
    assert np.array_equal(frozen, want[4])
    np.testing.assert_allclose(pm, want[0], rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(st, want[1], rtol=5e-3, atol=1e-4)
    # the final fits are taken under parameters that differ as above
    np.testing.assert_allclose(fit, want[2], rtol=1e-4)


@pytest.mark.parametrize("split", [1, 2, 3])
def test_two_phase_split_equals_uninterrupted(em_groups, split):
    """round_limit + state0 resume the exact trajectory; resuming only the
    unfrozen groups (the phase-2 repack) gives their rows exactly too."""
    batch, joint = em_groups
    cfg = train.EMConfig(K=K, train_drift=False, max_rounds=4,
                         min_progress=-1e9)
    caps = cfg.caps(joint)
    ev, mdl, pm0, st0 = convert.train_batch(*batch, CPU)
    full = train.run_em(ev, mdl, pm0, st0, cfg, caps=caps)
    p1 = train.run_em(ev, mdl, pm0, st0, cfg, caps=caps, round_limit=split)
    pm1, st1, fit1, rounds1, frozen1 = p1
    p2 = train.run_em(ev, mdl, pm1, st1, cfg, caps=caps,
                      state0=(fit1, frozen1, rounds1))
    for a, b in zip(full, p2):
        assert torch.equal(a, b)
    keep = torch.nonzero(~frozen1)[:, 0]
    assert len(keep)
    sub = ({k: v[keep] for k, v in ev.items()},
           {k: v[keep] for k, v in mdl.items()}, pm1[keep], st1[keep])
    p2s = train.run_em(*sub, cfg, caps=caps[keep.numpy()],
                       state0=(fit1[keep].numpy(), frozen1[keep].numpy(),
                               rounds1[keep].numpy()))
    for a, b in zip(full, p2s):
        assert torch.equal(a[keep], b)


def test_solve3_pivoted_matches_jax():
    rng = np.random.default_rng(5)
    G = 8
    X = rng.normal(size=(G, 5, 3))
    A = np.einsum("gki,gkj->gij", X, X).astype(np.float32) + 0.1
    Bv = rng.normal(size=(G, 3)).astype(np.float32)
    A[1, 0] = 0.0  # a zero row: NaN pivot ratio, flagged singular
    A[2] = 0.0  # all zero
    A[3, :, 1] = 0.0  # a zero column below the first pivot
    A[4, 2] = A[4, 1]  # rank deficient
    A[5, 0, 0] = np.nan  # a NaN entry
    for drift in (True, False):
        xj, dj = jtrain._solve3_pivoted(jnp.asarray(A), jnp.asarray(Bv),
                                        drift)
        xt, dt = train._solve3_pivoted(_t(A), _t(Bv), drift)
        assert np.array_equal(dt.numpy(), np.asarray(dj))
        assert dt[[1, 2, 3]].all() and not dt[[0, 6, 7]].any()
        ok = ~np.asarray(dj)
        np.testing.assert_allclose(xt.numpy()[ok], np.asarray(xj)[ok],
                                   rtol=1e-5, atol=1e-6)
        if not drift:
            assert (xt[:, 2] == 0).all()


def test_masked_lse_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, 4)).astype(np.float32) * 30
    mask = rng.random((5, 4)) < 0.6
    mask[0] = False
    x[1, 2] = -np.inf
    want = np.asarray(jtrain._masked_lse(jnp.asarray(x), jnp.asarray(mask),
                                         (1,)))
    got = train._masked_lse(_t(x), torch.from_numpy(mask), 1).numpy()
    assert np.isneginf(got[0]) and np.isneginf(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)


@pytest.fixture(scope="module")
def k6_round():
    """K=6 rows and round inputs for the kernel-wrapper checks."""
    B, T, lengths = CASES[6]
    _, (g_t, m_t, ev_t), x = _rows(6, np.random.default_rng(3), B, T,
                                   lengths)
    alphas, lpd = hmm.fwbw_grouped_forward(g_t, m_t, ev_t)
    args = [g_t, m_t, ev_t, lpd, alphas,
            _t(x["W"]).permute(0, 2, 1).contiguous(), _t(x["x_unc"]),
            _t(x["t_start"]), _t(x["valid"], torch.bool),
            torch.from_numpy(train.st_train_mask(6) > 0), _t(x["p_stay"]),
            _t(x["p_skip"]), True, True]
    return (g_t, m_t, ev_t), args


def test_kernel_wrappers_refuse_cpu_and_bad_inputs(k6_round):
    """The CUDA wrappers check their inputs and take CUDA tensors only: a
    CPU tensor never reaches a plain version through them."""
    (g_t, m_t, ev_t), args = k6_round
    with pytest.raises(ValueError, match="CUDA tensors"):
        hmm.fwbw_forward_kernel(g_t, m_t, ev_t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        em.em_backward_kernel(*args)
    bad_ev = {**ev_t, "mean": ev_t["mean"].double()}
    with pytest.raises(ValueError, match="float32"):
        hmm.fwbw_forward_kernel(g_t, m_t, bad_ev)
    with pytest.raises(ValueError, match="float32"):
        em.em_backward_kernel(*args[:2], bad_ev, *args[3:])
    short = [*args]
    short[4] = args[4][:-1]  # alphas of T-1 events
    with pytest.raises(ValueError, match="alphas"):
        em.em_backward_kernel(*short)
    g3 = g_t._replace(K=3)
    with pytest.raises(ValueError, match="K=6"):
        hmm.fwbw_forward_kernel(g3, m_t, ev_t)
    with pytest.raises(ValueError, match="K=6"):
        em.em_backward_kernel(g3, *args[1:])
    assert hmm.fwbw_forward_kernel.launches == 0
    assert em.em_backward_kernel.launches == 0


def test_dispatchers_refuse_other_devices(k6_round):
    (g_t, m_t, ev_t), args = k6_round
    meta = torch.device("meta")
    ev_m = {k: v.to(meta) for k, v in ev_t.items()}
    with pytest.raises(ValueError, match="device"):
        hmm.fwbw_grouped_forward(g_t, m_t, ev_m)
    with pytest.raises(ValueError, match="device"):
        em.fused_bwd_mstats(*args[:2], ev_m, *args[3:])
