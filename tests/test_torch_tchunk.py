"""K3, the grouped Viterbi decode chunk by chunk in time (long reads), on
the CPU: the port's plain chunk functions and its chunked decode against
nanocall_tpu.ops.hmm's, against the port's own full scan, and the chunked
route through both CLIs.

Inputs are made from a numpy seed at the builtin models' width (n = 4096).
Tolerances: logp and alpha within rtol 1e-5, the jit-rounding tolerance of
tests/test_torch_hmm.py (XLA reorders the emission, jnp.log differs from
torch.log in the last bit); paths, packed codes and path0 equal.  The
port's chunked decode against its full scan: every output bit-equal
(tolerance 0), since both run one step body.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanocall_tpu import batching as jbatching, simulate
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import batching, convert, native
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.ops import hmm
from test_torch_pipeline_trained import FIXED, _assert_stats_close, \
    reads_dir  # noqa: F401
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NAMES = ("r73.t.006", "r73.c.p1.006")
B = 6
CASES = [(T, Tc) for T in (257, 300) for Tc in (64, 100, T)]


@functools.lru_cache(maxsize=None)
def _inputs(T: int, Tc: int):
    """Both packages' inputs for B = 6 reads of up to T events, with lengths
    0, 1, Tc-1, Tc, Tc+1 and T, two models, varied scaling and
    transitions."""
    models = load_builtin_models("r73")
    bank = {f: np.stack([getattr(models[m], f) for m in NAMES])
            for f in convert.BANK_FIELDS}
    rng = np.random.default_rng(T * 1000 + Tc)
    model_idx = np.arange(B, dtype=np.int32) % 2
    pm = np.zeros((B, 6), np.float32)
    pm[:, 0] = rng.uniform(0.9, 1.1, B)
    pm[:, 1] = rng.uniform(-3, 3, B)
    pm[:, 3] = rng.uniform(0.9, 1.2, B)
    pm[:, 4] = rng.uniform(0.9, 1.1, B)
    pm[:, 5] = rng.uniform(0.9, 1.1, B)
    stp = np.stack([rng.uniform(0.05, 0.2, B), rng.uniform(0.2, 0.4, B)],
                   1).astype(np.float32)
    lengths = np.minimum([0, 1, Tc - 1, Tc, Tc + 1, T], T).astype(np.int32)
    states = rng.integers(0, 4096, (B, T))
    lm = bank["level_mean"][model_idx][np.arange(B)[:, None], states]
    mean = (lm * pm[:, :1] + pm[:, 1:2]
            + rng.normal(0.0, 0.8, (B, T))).astype(np.float32)
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
        "gt_j": gt_j, "m_j": m_j,
        "ev_j": {k: jnp.asarray(v) for k, v in ev.items()},
        "gt_t": convert.grouped_trans(gt_j, CPU),
        "m_t": convert.model_arrays(m_j, CPU),
        "ev_t": {k: convert.tensor(v, CPU, torch.int32 if k == "length"
                                   else torch.float32) for k, v in ev.items()},
    }


@pytest.mark.parametrize("T,Tc", CASES)
def test_chunk_functions_match_jax(T, Tc):
    """Chunk by chunk: the plain forward's carried alpha within rtol 1e-5
    of the JAX chunk's and its backpointers equal but for float32 ties off
    the paths; the plain traceback, fed the same backpointers and carries,
    gives the JAX chunk's states and codes exactly."""
    inp = _inputs(T, Tc)
    ev_j, ev_t = inp["ev_j"], inp["ev_t"]
    lengths_j = ev_j["length"]
    a_j = jnp.zeros((B, 4096), jnp.float32)
    a_t = torch.zeros((B, 4096))
    chunks = []
    for t0 in range(0, T, Tc):
        sl = slice(t0, t0 + Tc)
        evc_j = {k: ev_j[k][:, sl] for k in ("mean", "stdv", "log_stdv")}
        evc_j["length"] = lengths_j
        evc_t = {k: ev_t[k][:, sl] for k in ("mean", "stdv", "log_stdv")}
        evc_t["length"] = ev_t["length"]
        a_j, bps_j = jhmm.viterbi_forward_grouped_chunk(
            inp["gt_j"], inp["m_j"], evc_j, a_j, t0)
        a_t, bps_t = hmm.viterbi_forward_grouped_chunk_plain(
            inp["gt_t"], inp["m_t"], evc_t, a_t, t0)
        assert bps_t.shape == (min(Tc, T - t0), B, 4096)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5)
        assert np.mean(bps_t.numpy() != np.asarray(bps_j)) < 1e-5
        if t0 == 0:
            assert not bps_t[0].any()
        chunks.append((t0, bps_t))
    end = torch.argmax(a_t, dim=-1).to(torch.int32)
    end_j = jnp.asarray(end.numpy())
    s_t, s_j = end, end_j
    for t0, bps in reversed(chunks):
        s_j, ys_j = jhmm.viterbi_traceback_grouped_chunk(
            inp["gt_j"], end_j, s_j, jnp.asarray(bps.numpy()), t0, lengths_j,
            compact=True)
        s_t, ys_t = hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, s_t, bps, t0, ev_t["length"])
        assert np.array_equal(s_t.numpy(), np.asarray(s_j)), t0
        assert np.array_equal(ys_t.numpy(), np.asarray(ys_j)), t0


@pytest.mark.parametrize("T,Tc", CASES)
def test_tchunk_decode_matches_jax(T, Tc):
    """The port's chunked decode against the JAX package's
    viterbi_decode_grouped_tchunk: path0 and codes equal, logp within rtol
    1e-5, and the state paths rebuilt from the codes equal JAX's."""
    inp = _inputs(T, Tc)
    want = jhmm.viterbi_decode_grouped_tchunk(
        inp["gt_j"], inp["m_j"], inp["ev_j"], Tc=Tc, compact_path=True)
    got = hmm.viterbi_decode_grouped_tchunk(inp["gt_t"], inp["m_t"],
                                            inp["ev_t"], Tc)
    assert got["codes"].shape == (B, 3 * (-(-(T - 1) // 4)))
    assert np.array_equal(got["path0"].numpy(), np.asarray(want["path0"]))
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)
    paths = np.asarray(jhmm.viterbi_decode_grouped_tchunk(
        inp["gt_j"], inp["m_j"], inp["ev_j"], Tc=Tc)["path"])
    for b, L in enumerate(np.asarray(inp["ev_j"]["length"])):
        path = native.path_from_packed_codes(
            int(got["path0"][b]), got["codes"][b].numpy(), int(L), 6)
        assert np.array_equal(path, paths[b, :L].astype(np.int32)), b


@pytest.mark.parametrize("T,Tc", CASES)
def test_tchunk_decode_bit_equal_to_full_scan(T, Tc):
    """The port's chunked decode equals its full-scan decode bit for bit,
    and its score-only form the full scan's logp."""
    inp = _inputs(T, Tc)
    full = hmm.viterbi_decode_grouped(inp["gt_t"], inp["m_t"], inp["ev_t"])
    got = hmm.viterbi_decode_grouped_tchunk(inp["gt_t"], inp["m_t"],
                                            inp["ev_t"], Tc)
    assert sorted(got) == sorted(full)
    for k in full:
        assert torch.equal(got[k], full[k]), k
    score = hmm.viterbi_decode_grouped_tchunk(inp["gt_t"], inp["m_t"],
                                              inp["ev_t"], Tc,
                                              with_path=False)
    assert torch.equal(score["logp"], full["logp"])


def test_or_packed_codes_places_codes_globally():
    """A chunk's codes land at their global places, next to the codes a
    neighbouring chunk ORed into the same three-byte group."""
    rng = np.random.default_rng(4)
    T = 23
    codes = torch.from_numpy(rng.integers(0, 64, (T, 2)).astype(np.uint8))
    codes[0] = 0  # event 0 has no code
    want = hmm.pack_codes(codes[1:])
    got = torch.zeros_like(want)
    for t0 in (18, 9, 0):  # right to left, chunks of 9 events
        hmm.or_packed_codes(got, codes[t0:t0 + 9], t0)
    assert torch.equal(got, want)


def test_chunk_wrappers_refuse_other_devices():
    """No silent fallback: a device with no kernel raises."""
    inp = _inputs(257, 64)
    meta = torch.device("meta")
    gt = hmm.GroupedTrans(*(x.to(meta) for x in inp["gt_t"][:3]), K=6)
    m = hmm.ModelArrays(*(x.to(meta) for x in inp["m_t"]))
    ev = {k: v.to(meta) for k, v in inp["ev_t"].items()}
    with pytest.raises(ValueError, match="device"):
        hmm.viterbi_decode_grouped_tchunk(gt, m, ev, 64)
    with pytest.raises(ValueError, match="device"):
        hmm.viterbi_traceback_grouped_chunk(
            6, ev["length"], ev["length"], torch.empty((1, B, 4096),
                                                       dtype=torch.uint8,
                                                       device=meta),
            0, ev["length"], torch.empty((B, 3), dtype=torch.uint8,
                                         device=meta))


def test_traceback_chunk_kernel_checks_codes_size():
    """The traceback chunk kernel's wrapper refuses a packed-codes buffer
    too short for the chunk's last event before it reaches the card, and a
    CPU tensor after that."""
    B_, Tc, t0 = 3, 9, 18
    ints = torch.zeros(B_, dtype=torch.int32)
    bps = torch.zeros((Tc, B_, 4096), dtype=torch.uint8)
    need = 3 * -(-(t0 + Tc - 1) // 4)  # events 1..26 -> 7 groups
    with pytest.raises(ValueError, match="cannot hold"):
        hmm.traceback_chunk_kernel(6, ints, ints.clone(), bps, t0, ints,
                                   torch.zeros((B_, need - 1),
                                               dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        hmm.traceback_chunk_kernel(6, ints, ints.clone(), bps, t0, ints,
                                   torch.zeros((B_, need), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the chunked route through both CLIs
# ---------------------------------------------------------------------------


@pytest.fixture()
def chunk_counter(monkeypatch):
    """Counts the port's plain chunk calls (forward, traceback)."""
    counts = {"forward": 0, "traceback": 0}
    for what, name in (("forward", "viterbi_forward_grouped_chunk_plain"),
                       ("traceback", "viterbi_traceback_grouped_chunk_plain")):
        fn = getattr(hmm, name)

        def counted(*args, _fn=fn, _what=what):
            counts[_what] += 1
            return _fn(*args)

        monkeypatch.setattr(hmm, name, counted)
    return counts


@pytest.fixture()
def lowered_thresholds(monkeypatch):
    """Both packages take the chunked decode from buckets of 256 events on,
    in chunks of 128 (patched at test time in both batching modules)."""
    for mod in (batching, jbatching):
        monkeypatch.setattr(mod, "TCHUNK_MIN_T", 256)
        monkeypatch.setattr(mod, "TCHUNK_LEN", 128)


@pytest.fixture(scope="module")
def chunk_reads_dir(tmp_path_factory):
    """Two 1D reads and one hairpin read of several 128-event chunks."""
    d = tmp_path_factory.mktemp("fast5")
    models = load_builtin_models("r73")
    rng = np.random.default_rng(41)
    for name, comp, n in (("c0", None, 420), ("c1", None, 700),
                          ("c2", "r73.c.p1.006", 450)):
        simulate.write_sim_fast5(str(d / f"{name}.fast5"), models,
                                 "r73.t.006", comp, n, rng, read_id=name,
                                 noise_scale=0.5)
    return d


def _run_both(d, out, flags):
    texts = []
    for tag, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        fa, st = out / f"{tag}.fa", out / f"{tag}.tsv"
        assert main([str(d), "--pore", "r73", "-t", "1", "-o", str(fa),
                     "--stats", str(st), *flags, *extra]) == 0
        texts.append((fa.read_text(), st.read_text()))
    return texts


@pytest.mark.parametrize("flags", [("--no-train",),
                                   ("--no-train", "--1d")])
def test_untrained_cli_chunked_route_byte_equal(chunk_reads_dir, tmp_path,
                                                lowered_thresholds,
                                                chunk_counter, flags):
    """Untrained: FASTA and stats byte-equal to the JAX CLI's when every
    path chunk takes the chunked decode."""
    (j_fa, j_st), (t_fa, t_st) = _run_both(chunk_reads_dir, tmp_path, flags)
    assert t_fa.count(">") >= 3
    assert t_fa == j_fa and t_st == j_st
    assert chunk_counter["forward"] >= 4 and chunk_counter["traceback"] >= 4


def test_trained_cli_chunked_route_equal(reads_dir, tmp_path,
                                         lowered_thresholds, chunk_counter):
    """The default trained run at fixed rounds on `--1d`, on the fixture of
    tests/test_torch_pipeline_trained.py (where that run's FASTA is
    byte-equal): FASTA byte-equal and stats within its rtol 2e-3 when the
    path chunks (buckets of 512 events, 4 chunks) take the chunked
    decode."""
    (j_fa, j_st), (t_fa, t_st) = _run_both(reads_dir, tmp_path,
                                           ("--1d", *FIXED))
    assert t_fa.count(">") == 3 and t_fa == j_fa
    _assert_stats_close(j_st, t_st, rtol=2e-3)
    assert chunk_counter["forward"] >= 12 and chunk_counter["traceback"] >= 12


def test_one_long_read_at_the_real_threshold(tmp_path, chunk_counter):
    """One 1D read of about 33,000 events (bucket 34,816: 5 chunks of the
    real 8,192) decoded untrained by both CLIs: FASTA byte-equal."""
    d = tmp_path / "reads"
    d.mkdir()
    simulate.write_sim_fast5(str(d / "long.fast5"),
                             load_builtin_models("r73"), "r73.t.006", None,
                             33000, np.random.default_rng(8), read_id="long",
                             noise_scale=0.5)
    (j_fa, _), (t_fa, _) = _run_both(d, tmp_path, ("--no-train", "--1d"))
    assert t_fa.count(">") == 1 and t_fa == j_fa
    assert chunk_counter == {"forward": 5, "traceback": 5}
