"""The port's device ops (nanocall_tpu_torch.ops.hmm) against nanocall_tpu.

Both packages get the same inputs, made from a numpy seed at the builtin
models' width (n = 4096) with short reads.  On the CPU the port runs the
plain PyTorch versions of its kernels; the CUDA kernels themselves are held
to those plain versions bit for bit by chip_smoke.py on the card.

Tolerances: the jitted JAX programs let XLA fuse and reorder float32
expressions (measured up to 2.4e-4 absolute on the emission), and jnp.log
and torch.log differ in the last bit on some inputs, so values are compared
to a stated tolerance; paths and packed codes, on these seeded fixtures
where no near-tie decides, must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanocall_tpu import native
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert
from nanocall_tpu_torch.ops import hmm
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NAMES = ("r73.t.006", "r73.c.p1.006")


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.fixture(scope="module")
def inputs():
    """Per-task rows and events for B=6 reads of up to 400 events, lengths
    including 0, 1 and T, two models, varied scaling and transitions."""
    models = load_builtin_models("r73")
    bank = {f: np.stack([getattr(models[m], f) for m in NAMES])
            for f in convert.BANK_FIELDS}
    rng = np.random.default_rng(7)
    B, T = 6, 400
    model_idx = np.array([0, 1, 0, 1, 0, 1], np.int32)
    pm = np.zeros((B, 6), np.float32)
    pm[:, 0] = rng.uniform(0.9, 1.1, B)
    pm[:, 1] = rng.uniform(-3, 3, B)
    pm[:, 3] = rng.uniform(0.9, 1.2, B)
    pm[:, 4] = rng.uniform(0.9, 1.1, B)
    pm[:, 5] = rng.uniform(0.9, 1.1, B)
    stp = np.stack([rng.uniform(0.05, 0.2, B), rng.uniform(0.2, 0.4, B)],
                   1).astype(np.float32)
    lengths = np.array([T, 350, 210, 1, 0, T - 1], np.int32)
    states = rng.integers(0, 4096, (B, T))
    lm = bank["level_mean"][model_idx][np.arange(B)[:, None], states]
    lm = lm * pm[:, :1] + pm[:, 1:2]
    mean = (lm + rng.normal(0.0, 0.8, (B, T))).astype(np.float32)
    stdv = rng.uniform(0.6, 1.8, (B, T)).astype(np.float32)
    for b, L in enumerate(lengths):  # pool padding past each length
        mean[b, L:] = 1.0
        stdv[b, L:] = 1.0
    ev = {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
          "length": lengths}
    gt_j = jhmm.make_grouped_trans_device(stp[:, 0], stp[:, 1], K=6)
    m_j = jhmm.make_scaled_model_arrays(
        {k: jnp.asarray(v) for k, v in bank.items()}, model_idx, pm)
    return {
        "bank": bank, "model_idx": model_idx, "pm": pm, "stp": stp, "ev": ev,
        "gt_j": gt_j, "m_j": m_j,
        "ev_j": {k: jnp.asarray(v) for k, v in ev.items()},
        # identical device inputs for the decode comparisons
        "gt_t": convert.grouped_trans(gt_j, CPU),
        "m_t": convert.model_arrays(m_j, CPU),
        "ev_t": {k: convert.tensor(v, CPU, torch.int32 if k == "length"
                                   else torch.float32) for k, v in ev.items()},
    }


@pytest.mark.parametrize("ps,pk", [(0.1, 0.3), (0.05, 0.4), (0.4, 0.05),
                                   (0.09, 0.28)])
def test_grouped_tables_match_jax_to_one_ulp(ps, pk):
    gt_j = jhmm.make_grouped_trans_device(np.float32([ps, ps]),
                                          np.float32([pk, pk]), K=6)
    gt_t = hmm.make_grouped_trans_device(torch.tensor([ps, ps]),
                                         torch.tensor([pk, pk]), 6)
    for a, b in zip((gt_j.stay_lp, gt_j.step_lp, gt_j.skip_lp), gt_t[:3]):
        assert b.dtype == torch.float32 and b.shape == (2, 4096)
        assert _ulps(a, b.numpy()) <= 1


def test_scaled_model_arrays_match_jax(inputs):
    """Linear fields exact against the eager JAX function (the jitted one
    may contract scale*x+shift into one rounding: 1 ulp); the logs within
    1 ulp (jnp.log vs torch.log)."""
    bank_t = {k: convert.tensor(v, CPU) for k, v in inputs["bank"].items()}
    m_t = hmm.make_scaled_model_arrays(
        bank_t, convert.tensor(inputs["model_idx"], CPU, torch.int32),
        convert.tensor(inputs["pm"], CPU))
    m_eager = jhmm.make_scaled_model_arrays.__wrapped__(
        {k: jnp.asarray(v) for k, v in inputs["bank"].items()},
        jnp.asarray(inputs["model_idx"]), jnp.asarray(inputs["pm"]))
    for f in hmm.ModelArrays._fields:
        got = getattr(m_t, f).numpy()
        if f.startswith("log_"):
            assert _ulps(getattr(m_eager, f), got) <= 1, f
        else:
            assert np.array_equal(np.asarray(getattr(m_eager, f)), got), f
        assert _ulps(getattr(inputs["m_j"], f), got) <= 1, f


@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_log_emission_matches_jax(inputs, mode):
    ev, ev_t = inputs["ev"], inputs["ev_t"]
    fn = jax.jit(jhmm.log_emission) if mode == "jit" else jhmm.log_emission
    for t in (0, 57, 399):
        want = np.asarray(fn(inputs["m_j"], ev["mean"][:, t], ev["stdv"][:, t],
                             ev["log_stdv"][:, t]))
        got = hmm.log_emission(inputs["m_t"], ev_t["mean"][:, t],
                               ev_t["stdv"][:, t], ev_t["log_stdv"][:, t])
        if mode == "eager":
            assert np.array_equal(want, got.numpy())
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)


def test_forward_matches_jax(inputs):
    fa_j, bps_j = jhmm.viterbi_forward_grouped(inputs["gt_j"], inputs["m_j"],
                                               inputs["ev_j"])
    fa_t, bps_t = hmm.viterbi_forward_grouped(inputs["gt_t"], inputs["m_t"],
                                              inputs["ev_t"])
    assert fa_t.shape == (6, 4096) and bps_t.shape == (399, 6, 4096)
    np.testing.assert_allclose(fa_t.numpy(), np.asarray(fa_j), rtol=1e-5)
    # a backpointer off the decoded paths may flip where two candidates
    # agree to float32 rounding (3 of 9.8M here); the paths are compared
    # exactly below
    assert np.mean(bps_t.numpy() != np.asarray(bps_j)) < 1e-5


def test_score_only_matches_jax(inputs):
    want = jhmm.viterbi_decode_grouped(inputs["gt_j"], inputs["m_j"],
                                       inputs["ev_j"], with_path=False)
    got = hmm.viterbi_decode_grouped(inputs["gt_t"], inputs["m_t"],
                                     inputs["ev_t"], with_path=False)
    assert set(got) == {"logp"}
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)
    _, bps = hmm.viterbi_forward_grouped(inputs["gt_t"], inputs["m_t"],
                                         inputs["ev_t"], with_path=False)
    assert bps is None


def test_decode_matches_jax(inputs):
    want = jhmm.viterbi_decode_grouped(inputs["gt_j"], inputs["m_j"],
                                       inputs["ev_j"], compact_path=True)
    got = hmm.viterbi_decode_grouped(inputs["gt_t"], inputs["m_t"],
                                     inputs["ev_t"])
    assert got["path0"].dtype == torch.int32
    assert got["codes"].dtype == torch.uint8
    assert got["codes"].shape == (6, 3 * 100)
    assert np.array_equal(got["path0"].numpy(), np.asarray(want["path0"]))
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)


def test_packed_codes_rebuild_the_jax_state_path(inputs):
    """The port's bytes, read by native.path_from_packed_codes, give the
    full state path of the JAX uncompacted traceback."""
    full = jhmm.viterbi_decode_grouped(inputs["gt_j"], inputs["m_j"],
                                       inputs["ev_j"])
    got = hmm.viterbi_decode_grouped(inputs["gt_t"], inputs["m_t"],
                                     inputs["ev_t"])
    paths = np.asarray(full["path"])
    for b, L in enumerate(inputs["ev"]["length"]):
        if L == 0:
            continue
        path = native.path_from_packed_codes(
            int(got["path0"][b]), got["codes"][b].numpy(), int(L), 6)
        assert np.array_equal(path, paths[b, :L].astype(np.int32)), b


@pytest.mark.parametrize("Tm", [1, 4, 5, 7, 12])
def test_pack_codes_matches_jax(Tm):
    codes = np.random.default_rng(Tm).integers(0, 64, (Tm, 3)).astype(np.uint8)
    want = np.asarray(jhmm._pack_codes(jnp.asarray(codes)))
    got = hmm.pack_codes(torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), want)


def test_convert_round_trip(inputs):
    m = inputs["m_t"]
    back = convert.model_arrays_numpy(m)
    for f in hmm.ModelArrays._fields:
        assert np.array_equal(back[f], np.asarray(getattr(inputs["m_j"], f)))
    g = convert.grouped_trans_numpy(inputs["gt_t"])
    assert g["K"] == 6
    for f in ("stay_lp", "step_lp", "skip_lp"):
        assert np.array_equal(g[f], np.asarray(getattr(inputs["gt_j"], f)))
    models = load_builtin_models("r73")
    bank = convert.model_bank(models, NAMES, CPU)
    for f in convert.BANK_FIELDS:
        assert bank[f].dtype == torch.float32
        assert np.array_equal(bank[f].numpy(), inputs["bank"][f])
    from nanocall_tpu.pore_model import PoreModelParams
    from nanocall_tpu.transitions import TransitionParams

    ps = [PoreModelParams(scale=1.1, shift=-2.0, var=0.9),
          PoreModelParams(drift=0.01)]
    assert np.array_equal(convert.pm_rows(ps, CPU).numpy(),
                          np.stack([p.as_array() for p in ps]))
    st = convert.st_rows([TransitionParams(0.1, 0.3), (0.2, 0.25)], CPU)
    assert np.array_equal(st.numpy(), np.float32([[0.1, 0.3], [0.2, 0.25]]))


def test_decode_refuses_other_devices(inputs):
    """No silent fallback: a device with no kernel raises."""
    meta = torch.device("meta")
    gt = hmm.GroupedTrans(*(x.to(meta) for x in inputs["gt_t"][:3]), K=6)
    m = hmm.ModelArrays(*(x.to(meta) for x in inputs["m_t"]))
    ev = {k: v.to(meta) for k, v in inputs["ev_t"].items()}
    with pytest.raises(ValueError, match="device"):
        hmm.viterbi_decode_grouped(gt, m, ev)
