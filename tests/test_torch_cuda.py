"""Checks of the port's CUDA kernels that need the card (marker `cuda`).

Each test skips without a CUDA device.  The file imports neither JAX nor
nanocall_tpu, so it also runs on a machine that has only the port's
dependencies (tests/conftest.py imports JAX: pass --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same checks at the main path's full shapes; these
are small and quick.
"""

import pathlib

import numpy as np
import pytest
import torch

from nanocall_tpu_torch import convert, events, kmer, pore_model, tools, \
    transitions
from nanocall_tpu_torch.models import load_builtin_models
from nanocall_tpu_torch.ops import hmm
from torch_helpers import random_block_table

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k6_inputs(dev, B: int, T: int, lengths, seed: int):
    """The 21-neighbour table of (0.14, 0.21) as sparse pairs in memory
    (17 distinct log-probs in some slots: no packed layout), per-read
    scaled r73 models and noisy events of random states, on `dev`."""
    rng = np.random.default_rng(seed)
    ops = convert.trans_ops(transitions.sparse_from_pairs(
        transitions.structured_to_pairs(transitions.build_structured(
            transitions.TransitionParams(0.14, 0.21), 6)), 6), dev)
    models = load_builtin_models("r73")
    bank = convert.model_bank(models, ("r73.t.006", "r73.c.p1.006"), dev)
    params = np.zeros((B, 6), np.float32)
    params[:, 0] = rng.uniform(0.95, 1.05, B)
    params[:, 1] = rng.uniform(-1.0, 1.0, B)
    params[:, 3:] = rng.uniform(0.9, 1.1, (B, 3))
    model = hmm.make_scaled_model_arrays(
        bank, convert.tensor(np.arange(B) % 2, dev, torch.int32),
        convert.tensor(params, dev))
    lm = models["r73.t.006"].level_mean
    seqs = [events.EventSequence(
        lm[rng.integers(0, 4096, L)] + rng.normal(0.0, 1.0, L),
        rng.uniform(0.6, 1.8, L), np.arange(L) / 4000.0, np.full(L, 0.002))
        for L in lengths]
    return ops, model, convert.event_batch(events.pad_batch(seqs, T), dev)


#: lengths that put the short reads where a stray row of the one before
#: or after would show: 0 at b = 0, 0 right after 1 and after 2, 1 last
K6E_EDGE_LENGTHS = (0, 1, 0, "T", 2, 0, "T-1", 1)


def _edge_lengths(T: int, extra=()) -> list:
    return [{"T": T, "T-1": T - 1}.get(L, L) for L in K6E_EDGE_LENGTHS] \
        + list(extra)


def _guarded_call(monkeypatch, wrapper, ops, model, ev, what) -> dict:
    """`wrapper`'s outputs written into rows 1 .. B of (B + 2, T, n)
    buffers filled with a NaN of a payload no kernel makes (through
    hmm._custom_outputs); fails if the kernel wrote row 0 or B + 1."""
    B, T = ev["mean"].shape
    bufs = {k: torch.full((B + 2, T, 4096), 0x7FBADBAD, dtype=torch.int32,
                          device=ev["mean"].device).view(torch.float32)
            for k in ("alpha", "beta", "gamma")}
    out = {k: v[1:B + 1] for k, v in bufs.items()}
    with monkeypatch.context() as m:
        m.setattr(hmm, "_custom_outputs", lambda *_: out)
        got = wrapper(ops, model, ev)
    torch.cuda.synchronize()
    assert got is out, what
    for k, v in bufs.items():
        for row in (0, B + 1):
            assert bool((v[row].view(torch.int32) == 0x7FBADBAD).all()), \
                (what, k, f"guard row {row} written")
    return out


@pytest.mark.cuda
def test_fwbw_custom_kernel_bit_equal_on_the_card(card, monkeypatch):
    """K6e bit-equal to its plain version on the same card (tolerance 0),
    lengths 0, 1, 2, T-1 and T among the reads, 0 at b = 0 and right after
    a read of 1 and of 2 (K6E_EDGE_LENGTHS): through hmm.fwbw_custom, which
    takes the resident kernel for the in-memory table (it has K6c's
    layout), one launch counted; and the streaming kernel on the same
    inputs, one launch counted.  Both again into outputs between guard
    rows, which neither writes."""
    T = 40
    lengths = _edge_lengths(T)
    ops, model, ev = _k6_inputs(card, len(lengths), T, lengths, 3)
    assert hmm.fwbw_route(ops) == "resident"
    want = hmm.fwbw_custom_plain(ops, model, ev)
    for wrapper, call in ((hmm.fwbw_custom_resident_kernel, hmm.fwbw_custom),
                          (hmm.fwbw_custom_kernel, hmm.fwbw_custom_kernel)):
        n0 = wrapper.launches
        got = call(ops, model, ev)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        out = _guarded_call(monkeypatch, wrapper, ops, model, ev,
                            wrapper.__name__)
        for k in ("alpha", "beta", "gamma"):
            assert torch.equal(got[k], want[k]), (wrapper.__name__, k)
            assert torch.equal(_bits(out[k]), _bits(want[k])), \
                (wrapper.__name__, k, "guarded")


@pytest.mark.cuda
def test_tools_refuse_k3_on_the_card(card, tmp_path):
    """On the card the tools run the K = 6 kernels: `-K 3` raises their
    ValueError instead of falling back to the plain versions."""
    n = kmer.n_states(3)
    pore_model.save_tsv(pore_model.PoreModel(*(
        np.full(n, v, np.float32) for v in (80.0, 1.5, 1.0, 0.3)), K=3),
        tmp_path / "m.tsv")
    transitions.save_tsv(transitions.build_structured(K=3),
                         tmp_path / "s.tsv")
    events.save_tsv(events.EventSequence(*(np.full(9, v) for v in (
        80.0, 1.0, 0.0, 0.002))), tmp_path / "e.tsv")
    args = ["-p", str(tmp_path / "m.tsv"), "-s", str(tmp_path / "s.tsv"),
            "-e", str(tmp_path / "e.tsv"), "-K", "3", "--device", "cuda"]
    for tool in (["run-viterbi"], ["run-fwbw"], ["run-fwbw", "--custom-fwbw"]):
        with pytest.raises(ValueError, match="K=6"):
            tools.main([*tool, *args])


@pytest.mark.cuda
def test_fma_chain_kernel_bit_equal_on_the_card(card):
    """K8 bit-equal to its plain version (both round once per FMA:
    ops/fma.py) on measure_fma_peak's inputs at every lane count the
    kernel takes, and a counting run (x = 0, c = 1, d = 2^-10, exact in
    float32) equal to T k d in every lane; one launch each."""
    from nanocall_tpu_torch.ops import fma

    rng = np.random.default_rng(0)
    c, d = np.float32(0.9999), np.float32(1e-4)
    T, k = 8, 24
    for n in (1024, 2048, 4096, 8192):
        x = torch.from_numpy(rng.uniform(0.9, 1.1, (3, n)).astype(
            np.float32)).to(card)
        want = fma.fma_chain_plain(x, c, d, T, k)
        n0 = fma.fma_chain_kernel.launches
        got = fma.fma_chain(x, c, d, T, k)
        count = fma.fma_chain(torch.zeros_like(x), 1.0, 2.0**-10, T, k)
        torch.cuda.synchronize()
        assert fma.fma_chain_kernel.launches == n0 + 2
        assert torch.equal(got, want), n
        assert torch.all(count == T * k * 2.0**-10), n
    with pytest.raises(ValueError, match="lanes"):
        fma.fma_chain(torch.ones((2, 512), device=card), c, d, 1, 1)


@pytest.mark.cuda
def test_resident_forward_bit_equal_on_the_card(card, tmp_path):
    """K6a's resident kernel, path and score-only, bit-equal to its plain
    version (final alpha and backpointers, tolerance 0) at 16 x 2048 under
    the 21-neighbour table of (0.14, 0.21) written as a TSV and loaded back
    (`-s`), lengths 0, 1, T-1 and T among the reads; viterbi_forward takes
    it for that table, one launch each; the streaming kernel gives the same
    bits."""
    lengths = [2048, 0, 1, 2047] + list(
        np.random.default_rng(4).integers(2, 2048, 12))
    _, model, ev = _k6_inputs(card, 16, 2048, lengths, 4)
    transitions.save_tsv(transitions.build_structured(
        transitions.TransitionParams(0.14, 0.21), 6), tmp_path / "s.tsv")
    ops = convert.trans_ops(transitions.load_tsv(str(tmp_path / "s.tsv"), 6),
                            card)
    assert hmm.generic_forward_route(ops) == "resident"
    fa_p, bps_p = hmm.viterbi_forward_plain(ops, model, ev, True)
    n0 = (hmm.resident_forward_path_kernel.launches,
          hmm.resident_forward_score_kernel.launches)
    fa_k, bps_k = hmm.viterbi_forward(ops, model, ev)
    fa_s, none = hmm.viterbi_forward(ops, model, ev, with_path=False)
    fa_g, bps_g = hmm.generic_forward_path_kernel(ops, model, ev)
    torch.cuda.synchronize()
    assert none is None
    assert (hmm.resident_forward_path_kernel.launches,
            hmm.resident_forward_score_kernel.launches) == (n0[0] + 1,
                                                            n0[1] + 1)
    for got in (fa_k, fa_s, fa_g):
        assert torch.equal(got, fa_p)
    assert torch.equal(bps_k, bps_p) and torch.equal(bps_g, bps_p)
    # the in-memory table of the same kinetics has 17 values in a slot:
    # viterbi_forward takes the streaming kernel there
    ops17, _, _ = _k6_inputs(card, 1, 1, [1], 4)
    assert hmm.generic_forward_route(ops17) == "streaming"
    fa_p, bps_p = hmm.viterbi_forward_plain(ops17, model, ev, True)
    n0 = hmm.generic_forward_path_kernel.launches
    fa_g, bps_g = hmm.viterbi_forward(ops17, model, ev)
    torch.cuda.synchronize()
    assert hmm.generic_forward_path_kernel.launches == n0 + 1
    assert torch.equal(fa_g, fa_p) and torch.equal(bps_g, bps_p)
    # a NaN event in one read (the resident kernel tracks NaN from there)
    # and a +inf one starting another (alphas of -inf: every slot ties)
    ev["mean"][0, 100] = float("nan")
    ev["mean"][5, 0] = float("inf")
    fa_p, bps_p = hmm.viterbi_forward_plain(ops, model, ev, True)
    fa_k, bps_k = hmm.viterbi_forward(ops, model, ev)
    fa_s, _ = hmm.viterbi_forward(ops, model, ev, with_path=False)
    torch.cuda.synchronize()
    assert torch.isnan(fa_p).any()
    for got in (fa_k, fa_s):
        assert torch.equal(got.view(torch.int32), fa_p.view(torch.int32))
    assert torch.equal(bps_k, bps_p)


@pytest.mark.cuda
def test_reshape_copy_kernel_bit_equal_on_the_card(card):
    """K10 bit-equal to its plain version, x.reshape(R, M * L).clone(), at
    the repro's shape, a ragged one and a view that is not 16-byte
    aligned; one launch each."""
    from nanocall_tpu_torch.ops import repro

    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.normal(0.0, 1.0, 1 + 2 * 3 * 8).astype(
        np.float32)).to(card)
    xs = [torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(
        np.float32)).to(card) for shape in ((8, 128, 4), (3, 5, 7))]
    for x in (*xs, base[1:].view(2, 3, 8)):
        n0 = repro.reshape_copy_kernel.launches
        got = repro.reshape_copy(x)
        torch.cuda.synchronize()
        assert repro.reshape_copy_kernel.launches == n0 + 1
        assert torch.equal(got, repro.reshape_copy_plain(x)), x.shape


@pytest.mark.cuda
def test_seqpar_kernels_bit_equal_on_the_card(card):
    """K9 over 2 and 4 ranks on one card (a stream each) against its plain
    version: path and logp bit-equal, logp bit-equal to K1's; D * M
    launches of each half."""
    from nanocall_tpu_torch.ops import hmm as khmm
    from nanocall_tpu_torch.parallel import seqpar

    _, model, ev = _k6_inputs(card, 4, 40, [40, 0, 1, 39], 5)
    gt = khmm.make_grouped_trans_device(
        torch.full((4,), 0.12, device=card),
        torch.full((4,), 0.28, device=card), 6)
    full = khmm.viterbi_decode_grouped(gt, model, ev)
    for D, M in ((2, 1), (2, 2), (4, 4)):
        want = seqpar.viterbi_decode_seqpar_plain(gt, model, ev, [card] * D,
                                                  M)
        n0 = (khmm.forward_chunk_kernel.launches,
              khmm.traceback_chunk_states_kernel.launches)
        got = seqpar.viterbi_decode_seqpar(gt, model, ev, [card] * D, M)
        torch.cuda.synchronize()
        assert khmm.forward_chunk_kernel.launches == n0[0] + D * M
        assert khmm.traceback_chunk_states_kernel.launches == n0[1] + D * M
        assert torch.equal(got["path"].int(), want["path"].int()), (D, M)
        assert torch.equal(got["logp"], want["logp"]), (D, M)
        assert torch.equal(got["logp"], full["logp"]), (D, M)


@pytest.mark.cuda
def test_kernel_launch_leaves_the_current_device(card):
    """A C entry makes its tensors' card current for the launch and hands
    the caller's device back: after launches on every visible card, the
    current device, and so where a bare "cuda" allocates, is unchanged.
    A run's pool and drivers hold their device indexed."""
    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.ops import repro

    torch.cuda.set_device(0)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        got = repro.reshape_copy(torch.ones((2, 3, 4), device=dev))
        assert got.device == dev
        _, model, ev = _k6_inputs(dev, 2, 8, [8, 5], i)
        gt = hmm.make_grouped_trans_device(torch.full((2,), 0.1, device=dev),
                                           torch.full((2,), 0.3, device=dev),
                                           6)
        hmm.viterbi_decode_grouped(gt, model, ev)
        assert torch.cuda.current_device() == 0, i
        assert torch.empty(1, device="cuda").device == card, i
    torch.cuda.synchronize()
    assert basecall.EventPool("cuda").device == card


def _grouped_inputs(dev, lengths, T: int, seed: int):
    """K1's inputs for len(lengths) reads of T events: per-read grouped
    tables, scaled models and noisy events (_k6_inputs')."""
    B = len(lengths)
    rng = np.random.default_rng(seed)
    _, model, ev = _k6_inputs(dev, B, T, lengths, seed)
    gt = hmm.make_grouped_trans_device(
        convert.tensor(rng.uniform(0.05, 0.2, B).astype(np.float32), dev),
        convert.tensor(rng.uniform(0.2, 0.4, B).astype(np.float32), dev), 6)
    return gt, model, ev


def _forward_all_ways(gt, model, ev, Tc: int):
    """K1 (path, score), K3's chunks of Tc events and the plain version:
    {what: (final alpha, bps or None)}, the chunks' bps joined as K1's."""
    out = {"plain": hmm.viterbi_forward_grouped_plain(gt, model, ev, True),
           "path": hmm.forward_path_kernel(gt, model, ev),
           "score": (hmm.forward_score_kernel(gt, model, ev), None)}
    T = ev["mean"].shape[1]
    alpha, rows = None, []
    for t0 in range(0, T, Tc):
        alpha, bps = hmm.forward_chunk_kernel(gt, model, ev, alpha, t0, Tc)
        rows.append(bps)
    out["chunk"] = (alpha, torch.cat(rows)[1:])
    torch.cuda.synchronize()
    return out


def _nan_decode_inputs(dev):
    """The decode's NaN inputs, 8 reads of T = 40 events: lengths 0, 1,
    T-1 and T among them, NaN events in read 4 from event 7 on, a NaN stay
    entry in read 5 (final alpha NaN at some states only) and a NaN model
    entry in read 6."""
    T = 40
    lengths = [T, 0, 1, T - 1, T, T, T, 23]
    gt, model, ev = _grouped_inputs(dev, lengths, T, 7)
    ev["mean"][4, 7:] = float("nan")
    gt.stay_lp[5, 1234] = float("nan")
    model.level_mean[6, 99] = float("nan")
    return gt, model, ev


@pytest.mark.cuda
def test_viterbi_forward_bit_equal_under_nan_on_the_card(card):
    """K1 (path and score-only) and K3's forward chunk bit-equal to K1's
    plain version and to each other (tolerance 0): reads of lengths 0, 1,
    T-1 and T, one with NaN events from event 7 on, one with a NaN stay
    entry (alpha NaN at some states only: the serial column order) and one
    with a NaN model entry; chunks of 11 events."""
    gt, model, ev = _nan_decode_inputs(card)
    out = _forward_all_ways(gt, model, ev, 11)
    fa_p, bps_p = out["plain"]
    assert torch.isnan(fa_p[5]).any() and not torch.isnan(fa_p[5]).all()
    for what in ("path", "score", "chunk"):
        fa, bps = out[what]
        assert torch.equal(fa.view(torch.int32), fa_p.view(torch.int32)), what
        if bps is not None:
            assert torch.equal(bps, bps_p), what


@pytest.mark.cuda
def test_em_backward_bit_equal_under_all_flags_on_the_card(card):
    """K5 bit-equal to its plain version (tolerance 0) under all three flag
    sets, on rows of lengths 0, 1, T-1 and T and an invalid row, with K4's
    alphas; one launch counted per call."""
    from nanocall_tpu_torch.ops import em

    T = 24
    lengths = [T, 0, 1, T - 1, T, 9]
    B = len(lengths)
    rng = np.random.default_rng(9)
    _, model, ev = _k6_inputs(card, B, T, lengths, 9)
    ps = convert.tensor(rng.uniform(0.05, 0.2, B).astype(np.float32), card)
    pk = convert.tensor(rng.uniform(0.2, 0.4, B).astype(np.float32), card)
    gtf = hmm.make_grouped_full_device(ps, pk, 6)
    alphas, lpd = hmm.fwbw_forward_kernel(gtf, model, ev)
    W = convert.tensor(rng.uniform(0.0, 2.0, (B, 6, 4096)).astype(np.float32),
                       card)
    x_unc = convert.tensor(rng.normal(80.0, 5.0, (B, T)).astype(np.float32),
                           card)
    t_start = convert.tensor(
        np.cumsum(rng.uniform(0.001, 0.01, (B, T)), 1).astype(np.float32),
        card)
    valid = torch.tensor([True] * (B - 1) + [False], device=card)
    subset = torch.from_numpy(rng.random(4096) < 0.5).to(card)
    for flags in ((True, True), (True, False), (False, True)):
        args = (gtf, model, ev, lpd, alphas, W if flags[0] else None, x_unc,
                t_start, valid, subset, ps, pk, *flags)
        want = em.fused_bwd_mstats_plain(*args)
        n0 = em.em_backward_kernel.launches
        got = em.em_backward_kernel(*args)
        torch.cuda.synchronize()
        assert em.em_backward_kernel.launches == n0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), flags


def _loaded_ops(dev, tmp_path, p_stay: float, p_skip: float):
    """The 21-neighbour table of (p_stay, p_skip) written as a TSV and
    loaded back (`-s`), as TransOps on `dev`."""
    path = tmp_path / f"s_{p_stay}_{p_skip}.tsv"
    transitions.save_tsv(transitions.build_structured(
        transitions.TransitionParams(p_stay, p_skip), 6), path)
    return convert.trans_ops(transitions.load_tsv(str(path), 6), dev)


def _bits(x):
    """A float32 tensor's bit patterns (NaN payloads and zero signs
    included), other tensors as they are."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
def test_fwbw_resident_bit_equal_on_the_card(card, tmp_path):
    """K6c's resident kernel bit-equal to fwbw_plain (alpha, beta, em and
    log_pr_data as bits, NaN included) under the loaded tables of
    (0.14, 0.21) and of the CLI priors (0.1, 0.3), lengths 0, 1, T-1 and T
    among the reads, a NaN event in one read and a +inf event in another;
    hmm.fwbw takes it for both tables, one launch each.  Likewise under two
    random tables that pack with other slot counts than the loaded tables'
    21 (12 from-side and 23 to-side slots, and the reverse: the kernel's
    instance for any slot count).  Under a random table that does not
    pack, hmm.fwbw takes the streaming kernel, also bit-equal."""
    T = 40
    lengths = [T, 0, 1, T - 1, T, T, 17]
    _, model, ev = _k6_inputs(card, len(lengths), T, lengths, 6)
    ev["mean"][4, 20] = float("nan")
    ev["mean"][5, 9] = float("inf")
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 4096, (21, 4096)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (21, 4096))).astype(np.float32)
    tables = {
        "(0.14, 0.21)": _loaded_ops(card, tmp_path, 0.14, 0.21),
        "(0.1, 0.3)": _loaded_ops(card, tmp_path, 0.1, 0.3),
        "random": convert.trans_ops(transitions.SparseTransitions(
            from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), card),
    }
    for d_from, d_to in ((12, 23), (23, 12)):
        f_idx, f_lp = random_block_table(rng, d_from, 16, hmm.FWBW_GROUPS)
        t_idx, t_lp = random_block_table(rng, d_to, 16, hmm.FWBW_GROUPS)
        tables[f"random packed {d_from} / {d_to}"] = convert.trans_ops(
            transitions.SparseTransitions(from_idx=f_idx, from_logp=f_lp,
                                          to_idx=t_idx, to_logp=t_lp, K=6),
            card)
    for what, ops in tables.items():
        route = "streaming" if what == "random" else "resident"
        assert hmm.fwbw_route(ops) == route, what
        wrapper = (hmm.fwbw_generic_kernel if route == "streaming"
                   else hmm.fwbw_resident_kernel)
        want = hmm.fwbw_plain(ops, model, ev)
        n0 = wrapper.launches
        got = hmm.fwbw(ops, model, ev)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1, what
        assert torch.isnan(want["alpha"][4]).any(), what
        for k in ("alpha", "beta", "em", "log_pr_data"):
            assert torch.equal(_bits(got[k]), _bits(want[k])), (what, k)


@pytest.mark.cuda
def test_em_kernels_bit_equal_under_nan_on_the_card(card):
    """K4 (with and without stored alphas) and K5 (all three flag sets)
    bit-equal to their plain versions (tolerance 0, compared as bits) with
    NaN events in one read from its middle on, a NaN model entry at one
    state of another read and a +inf event in a third; K5 on the plain
    version's alphas: a max by fmaxf alone would drop a NaN that
    torch.amax keeps."""
    from nanocall_tpu_torch.ops import em

    T = 24
    lengths = [T, 0, 1, T - 1, T, T, T, 9]
    B = len(lengths)
    rng = np.random.default_rng(10)
    _, model, ev = _k6_inputs(card, B, T, lengths, 10)
    ev["mean"][4, T // 2:] = float("nan")
    model.level_mean[5, 321] = float("nan")
    ev["mean"][6, 5] = float("inf")
    ps = convert.tensor(rng.uniform(0.05, 0.2, B).astype(np.float32), card)
    pk = convert.tensor(rng.uniform(0.2, 0.4, B).astype(np.float32), card)
    gtf = hmm.make_grouped_full_device(ps, pk, 6)
    alphas, lpd = hmm.fwbw_grouped_forward_plain(gtf, model, ev)
    assert torch.isnan(alphas[T - 1, 5]).any()
    got_a, got_lpd = hmm.fwbw_forward_kernel(gtf, model, ev)
    none, fit_lpd = hmm.fwbw_forward_kernel(gtf, model, ev,
                                            with_alphas=False)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(_bits(got_a), _bits(alphas))
    assert torch.equal(_bits(got_lpd), _bits(lpd))
    assert torch.equal(_bits(fit_lpd), _bits(lpd))
    W = convert.tensor(rng.uniform(0.0, 2.0, (B, 6, 4096)).astype(np.float32),
                       card)
    x_unc = convert.tensor(rng.normal(80.0, 5.0, (B, T)).astype(np.float32),
                           card)
    t_start = convert.tensor(
        np.cumsum(rng.uniform(0.001, 0.01, (B, T)), 1).astype(np.float32),
        card)
    valid = torch.ones(B, dtype=torch.bool, device=card)
    subset = torch.from_numpy(rng.random(4096) < 0.5).to(card)
    for flags in ((True, True), (True, False), (False, True)):
        args = (gtf, model, ev, lpd, alphas, W if flags[0] else None, x_unc,
                t_start, valid, subset, ps, pk, *flags)
        want = em.fused_bwd_mstats_plain(*args)
        got = em.em_backward_kernel(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w)), flags


@pytest.mark.cuda
def test_traceback_bit_equal_under_nan_on_the_card(card):
    """K2 (path0, packed codes, logp as bits) bit-equal to its plain
    version on K1's output for _nan_decode_inputs, whose read 5 ends with a
    final alpha that is NaN at some states: its end state is the first NaN
    (torch.argmax), its logp NaN; K3's decode (chunks of 11) bit-equal to
    K1 + K2 there, its end argmax taken in torch."""
    gt, model, ev = _nan_decode_inputs(card)
    fa, bps = hmm.forward_path_kernel(gt, model, ev)
    want = hmm.viterbi_traceback_grouped_plain(6, fa, bps, ev["length"])
    n0 = hmm.traceback_kernel.launches
    got = hmm.viterbi_traceback_grouped(6, fa, bps, ev["length"])
    torch.cuda.synchronize()
    assert hmm.traceback_kernel.launches == n0 + 1
    assert torch.isnan(fa[5]).any() and not torch.isnan(fa[5]).all()
    assert torch.isnan(want[2][5])
    for what, g, w in zip(("path0", "codes", "logp"), got, want):
        assert torch.equal(_bits(g), _bits(w)), what
    full = hmm.viterbi_decode_grouped(gt, model, ev)
    chunked = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, 11)
    torch.cuda.synchronize()
    for k in ("path0", "codes", "logp"):
        assert torch.equal(_bits(chunked[k]), _bits(full[k])), k


#: (T, lengths, chunk borders, K3's decode chunk) of the ring cases: reads
#: long enough to wrap the ring many times, and more reads than the H100's
#: 132 SMs (the CLI batches 256 reads of a short bucket)
RING_CASES = {
    "long": (600, [600, 0, 1, 2, 3, 4, 5, 599, 130, 131, 132, 262, 263, 400],
             (0, 131, 262, 600), 128),
    "wide": (64, [i % 65 for i in range(300)], (0, 21, 42, 64), 21),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_traceback_ring_bit_equal_on_the_card(card, case):
    """The row ring of the traceback walks: K2 bit-equal to its plain
    version; K3's traceback chunk and K9's states chunk bit-equal to their
    plain versions on the case's chunks from random carried states (a
    read's end inside, before and after a chunk); K3's decode in chunks
    bit-equal to K1 + K2.  Cases: 14 reads of 600 events (lengths 0 to
    T), and 300 reads of 64 events (lengths 0 to T), more blocks than
    SMs."""
    T, lengths, borders, tc = RING_CASES[case]
    gt, model, ev = _grouped_inputs(card, lengths, T, 12)
    fa, bps = hmm.forward_path_kernel(gt, model, ev)
    want = hmm.viterbi_traceback_grouped_plain(6, fa, bps, ev["length"])
    got = hmm.traceback_kernel(6, fa, bps, ev["length"])
    torch.cuda.synchronize()
    for what, g, w in zip(("path0", "codes", "logp"), got, want):
        assert torch.equal(_bits(g), _bits(w)), what
    B = len(lengths)
    rng = np.random.default_rng(12)
    end = torch.argmax(fa, dim=-1).to(torch.int32)
    filler = torch.zeros((1, B, 4096), dtype=torch.uint8, device=card)
    for t0, t1 in zip(borders[:-1], borders[1:]):
        rows = (torch.cat([filler, bps[:t1 - 1]]) if t0 == 0
                else bps[t0 - 1:t1 - 1])
        carry = torch.from_numpy(rng.integers(0, 4096, B).astype(
            np.int32)).to(card)
        s_p, codes_p = hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, carry, rows, t0, ev["length"])
        packed_p = torch.zeros_like(got[1])
        hmm.or_packed_codes(packed_p, codes_p, t0)
        s_k, packed_k = carry.clone(), torch.zeros_like(got[1])
        hmm.traceback_chunk_kernel(6, end, s_k, rows, t0, ev["length"],
                                   packed_k)
        s_sp, states_p = hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, carry, rows, t0, ev["length"], compact=False)
        s_sk = carry.clone()
        states_k = torch.empty((t1 - t0, B), dtype=torch.uint16,
                               device=card)
        hmm.traceback_chunk_states_kernel(6, end, s_sk, rows, t0,
                                          ev["length"], states_k)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p.to(torch.int32)), (t0, t1)
        assert torch.equal(packed_k, packed_p), (t0, t1)
        assert torch.equal(s_sk, s_sp.to(torch.int32)), (t0, t1)
        assert torch.equal(states_k.int(), states_p.int()), (t0, t1)
    full = hmm.viterbi_decode_grouped(gt, model, ev)
    chunked = hmm.viterbi_decode_grouped_tchunk(gt, model, ev, tc)
    torch.cuda.synchronize()
    for k in ("path0", "codes", "logp"):
        assert torch.equal(_bits(chunked[k]), _bits(full[k])), k


def _nan_fwbw_events(ev, rows):
    """NaN events in rows[0] from its middle on and a +inf event in
    rows[1], in place."""
    T = ev["mean"].shape[1]
    ev["mean"][rows[0], T // 2:] = float("nan")
    ev["mean"][rows[1], 5] = float("inf")


@pytest.mark.cuda
def test_fwbw_backward_bit_equal_under_nan_on_the_card(card):
    """K6d (K5's beta step, the betas stored) bit-equal to its plain
    version (betas as bits, tolerance 0) on rows of lengths 0, 1, T-1 and
    T, clean and with NaN events in one row from its middle on, a +inf
    event in another and a NaN model entry at one state of a third; one
    launch counted per call."""
    T = 24
    lengths = [T, 0, 1, T - 1, T, T, T, 9]
    B = len(lengths)
    rng = np.random.default_rng(11)
    _, model, ev = _k6_inputs(card, B, T, lengths, 11)
    gtf = hmm.make_grouped_full_device(
        convert.tensor(rng.uniform(0.05, 0.2, B).astype(np.float32), card),
        convert.tensor(rng.uniform(0.2, 0.4, B).astype(np.float32), card), 6)
    for what in ("clean", "NaN"):
        if what == "NaN":
            _nan_fwbw_events(ev, (4, 6))
            model.level_mean[5, 321] = float("nan")
        want = hmm.fwbw_grouped_backward_plain(gtf, model, ev)
        n0 = hmm.fwbw_backward_kernel.launches
        got = hmm.fwbw_grouped_backward(gtf, model, ev)
        torch.cuda.synchronize()
        assert hmm.fwbw_backward_kernel.launches == n0 + 1
        if what == "NaN":
            assert torch.isnan(want[4]).any() and torch.isnan(want[5]).any()
        assert torch.equal(_bits(got), _bits(want)), what


@pytest.mark.cuda
def test_fwbw_custom_kernel_bit_equal_under_nan_on_the_card(card):
    """K6e bit-equal to its plain version (alpha, beta and gamma as bits)
    with NaN events in one read from its middle on, a +inf event in
    another and a NaN model entry at one state of a third, lengths 0, 1,
    T-1 and T among the reads."""
    T = 40
    ops, model, ev = _k6_inputs(card, 7, T, [T, 0, 1, T - 1, T, T, T], 13)
    _nan_fwbw_events(ev, (4, 6))
    model.level_mean[5, 99] = float("nan")
    want = hmm.fwbw_custom_plain(ops, model, ev)
    got = hmm.fwbw_custom(ops, model, ev)
    torch.cuda.synchronize()
    assert torch.isnan(want["gamma"][4]).any()
    assert torch.isnan(want["gamma"][5]).any()
    for k in ("alpha", "beta", "gamma"):
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def _k6e_tables(dev, tmp_path, rng) -> dict:
    """The tables K6e's resident kernel is held under: the loaded tables of
    (0.14, 0.21) and of the CLI priors (21 slots a side: its <21>
    instance) and random packed tables of 12 / 23 and 23 / 12 slots (its
    <0> instance)."""
    tables = {"(0.14, 0.21)": _loaded_ops(dev, tmp_path, 0.14, 0.21),
              "(0.1, 0.3)": _loaded_ops(dev, tmp_path, 0.1, 0.3)}
    for d_from, d_to in ((12, 23), (23, 12)):
        f_idx, f_lp = random_block_table(rng, d_from, 16, hmm.FWBW_GROUPS)
        t_idx, t_lp = random_block_table(rng, d_to, 16, hmm.FWBW_GROUPS)
        tables[f"random packed {d_from} / {d_to}"] = convert.trans_ops(
            transitions.SparseTransitions(from_idx=f_idx, from_logp=f_lp,
                                          to_idx=t_idx, to_logp=t_lp, K=6),
            dev)
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_fwbw_custom_resident_bit_equal_on_the_card(card, tmp_path, inputs,
                                                   monkeypatch):
    """K6e's resident kernel bit-equal to fwbw_custom_plain (alpha, beta and
    gamma as bits, tolerance 0) under the loaded tables of (0.14, 0.21) and
    of the priors (its <21> instance) and random packed tables of 12 / 23
    and 23 / 12 slots (<0>), lengths 0, 1, 2, T-1 and T among the reads, 0
    at b = 0 and right after a read of 1 and of 2 (K6E_EDGE_LENGTHS);
    clean, and with NaN events in one read from its middle on, a +inf event
    in another and a NaN model entry at one state of a third.
    hmm.fwbw_custom takes it for every one of them, one launch each; the
    kernel again into outputs between guard rows, which it leaves as they
    were (a read of length 0 must not write the row before its own)."""
    T = 40
    # the NaN rows 8, 9 and 10 are full reads
    lengths = _edge_lengths(T, (T, T, T, 17))
    B = len(lengths)
    _, model, ev = _k6_inputs(card, B, T, lengths, 14)
    if inputs == "NaN":
        _nan_fwbw_events(ev, (8, 10))
        model.level_mean[9, 99] = float("nan")
    for what, ops in _k6e_tables(card, tmp_path,
                                 np.random.default_rng(14)).items():
        assert hmm.fwbw_route(ops) == "resident", what
        want = hmm.fwbw_custom_plain(ops, model, ev)
        n0 = hmm.fwbw_custom_resident_kernel.launches
        got = hmm.fwbw_custom(ops, model, ev)
        torch.cuda.synchronize()
        assert hmm.fwbw_custom_resident_kernel.launches == n0 + 1, what
        out = _guarded_call(monkeypatch, hmm.fwbw_custom_resident_kernel,
                            ops, model, ev, what)
        if inputs == "NaN":
            assert torch.isnan(want["gamma"][8]).any(), what
            assert torch.isnan(want["gamma"][9]).any(), what
        for k in ("alpha", "beta", "gamma"):
            assert torch.equal(_bits(got[k]), _bits(want[k])), (what, k)
            assert torch.equal(_bits(out[k]), _bits(want[k])), \
                (what, k, "guarded")


def _k6b_check(ops, fa, bps, lengths, route: str, what) -> None:
    """hmm.viterbi_traceback on the card takes `route` under `ops`, one
    launch of that kernel, and gives the plain version's path and logp
    (logp as bits)."""
    wrapper = {"ring": hmm.generic_traceback_ring_kernel,
               "streaming": hmm.generic_traceback_kernel}[route]
    assert hmm.generic_traceback_route(ops) == route, what
    want = hmm.viterbi_traceback_plain(ops, fa, bps, lengths)
    n0 = wrapper.launches
    got = hmm.viterbi_traceback(ops, fa, bps, lengths)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1, what
    assert torch.equal(got[0].int(), want[0].int()), (what, "path")
    assert torch.equal(_bits(got[1]), _bits(want[1])), (what, "logp")


@pytest.mark.cuda
def test_generic_traceback_ring_bit_equal_on_the_card(card, tmp_path):
    """K6b's ring kernel bit-equal to its plain version (path, logp) on
    K6a's output under the loaded tables of (0.14, 0.21) and of the priors
    (whose 17 log-probs a slot leave K6a on its streaming kernel; K6b takes
    the ring all the same) and a random table of 24 slots (2 ring stages),
    lengths 0, 1, 2, T-1 and T among the reads; K6b's streaming kernel, which
    a table of 25 slots takes, bit-equal too."""
    T = 300
    lengths = [T, 0, 1, T - 1, 2, 150, 299, 77]
    _, model, ev = _k6_inputs(card, len(lengths), T, lengths, 15)
    rng = np.random.default_rng(15)

    def random_ops(deg):
        idx = rng.integers(0, 4096, (deg, 4096)).astype(np.int32)
        lp = np.log(rng.uniform(0.01, 1.0, (deg, 4096))).astype(np.float32)
        return convert.trans_ops(transitions.SparseTransitions(
            from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), card)

    for what, ops, route in (
            ("(0.14, 0.21)", _loaded_ops(card, tmp_path, 0.14, 0.21), "ring"),
            ("(0.1, 0.3)", _loaded_ops(card, tmp_path, 0.1, 0.3), "ring"),
            ("random 24 slots", random_ops(24), "ring"),
            ("random 25 slots", random_ops(25), "streaming")):
        fa, bps = hmm.viterbi_forward(ops, model, ev)
        _k6b_check(ops, fa, bps, ev["length"], route, what)


def _random_walk_inputs(dev, B: int, T: int, lengths, deg: int, seed: int):
    """A traceback's inputs drawn at random: final alphas (B, 4096) and
    slot ids in [0, deg) as backpointers (T-1, B, 4096), made from a numpy
    seed; any slot names a from-state, so every walk is valid."""
    rng = np.random.default_rng(seed)
    fa = convert.tensor(rng.normal(0.0, 10.0, (B, 4096)).astype(np.float32),
                        dev)
    bps = torch.from_numpy(rng.integers(0, deg, (T - 1, B, 4096)).astype(
        np.uint8)).to(dev)
    return fa, bps, convert.tensor(np.asarray(lengths), dev, torch.int32)


@pytest.mark.cuda
def test_generic_traceback_ring_under_nan_on_the_card(card, tmp_path):
    """K6b's ring kernel on final alphas that are NaN at some states of one
    read (its end state is the first NaN, its logp NaN: torch.argmax /
    torch.amax), all NaN in another, all -inf in a third (every state
    ties: state 0) and +inf at two states of a fourth (the first): path and
    logp bit-equal to the plain version, as K6b's streaming kernel."""
    T = 64
    lengths = [T, T, T, T, 10, 1, 0, 33]
    ops = _loaded_ops(card, tmp_path, 0.14, 0.21)
    fa, bps, ln = _random_walk_inputs(card, len(lengths), T, lengths, 21, 16)
    fa[0, [77, 3000, 12]] = float("nan")
    fa[1] = float("nan")
    fa[2] = float("-inf")
    fa[3, [900, 40]] = float("inf")
    want = hmm.viterbi_traceback_plain(ops, fa, bps, ln)
    assert int(want[0][0, -1]) == 12 and torch.isnan(want[1][0])
    assert int(want[0][2, -1]) == 0 and int(want[0][3, -1]) == 40
    _k6b_check(ops, fa, bps, ln, "ring", "NaN final alphas")
    _k6b_check(ops._replace(from_states=None), fa, bps, ln, "streaming",
               "NaN final alphas, streaming")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_generic_traceback_ring_cases_on_the_card(card, tmp_path, case):
    """K6b's ring kernel on RING_CASES' shapes (14 reads of 600 events, and
    300 reads of 64 events: more blocks than SMs; lengths 0 to T), on
    random final alphas and slot ids under the loaded table of (0.14,
    0.21) (3 stages) and a random table of 24 slots (2 stages): path and
    logp bit-equal to the plain version."""
    T, lengths, _, _ = RING_CASES[case]
    rng = np.random.default_rng(17)
    idx = rng.integers(0, 4096, (24, 4096)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (24, 4096))).astype(np.float32)
    for what, ops in (
            ("(0.14, 0.21)", _loaded_ops(card, tmp_path, 0.14, 0.21)),
            ("random 24 slots", convert.trans_ops(
                transitions.SparseTransitions(from_idx=idx, from_logp=lp,
                                              to_idx=idx, to_logp=lp, K=6),
                card))):
        deg = ops.from_idx.shape[0]
        fa, bps, ln = _random_walk_inputs(card, len(lengths), T, lengths,
                                          deg, 18)
        _k6b_check(ops, fa, bps, ln, "ring", (case, what))


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_statepar_kernels_bit_equal_on_the_card(card, inputs):
    """K1m and K2m, the decode with the 4096 states split over M = 2, 4 and
    8 ranks on cuda:0 (parallel/statepar.py), against their plain versions
    over the same ranks and against K1 + K2, path and score-only, every
    output as bits: on reads of lengths 0, 1, T-1 and T (clean) and on
    _nan_decode_inputs (NaN events, a NaN stay entry, a NaN model entry);
    one data row of all reads, then two rows of half.  One launch of K1m a
    wave and row (plan_waves on the card's resident blocks: one wave here)
    and one of K2m a row; a row of one rank (M = 1) decodes by K1 + K2 and
    launches neither."""
    from nanocall_tpu_torch.parallel import statepar

    if inputs == "clean":
        gt, model, ev = _grouped_inputs(card, [40, 0, 1, 39, 17, 40], 40, 9)
    else:
        gt, model, ev = _nan_decode_inputs(card)
    B, T = ev["mean"].shape
    full = hmm.viterbi_decode_grouped(gt, model, ev)
    score = hmm.viterbi_decode_grouped(gt, model, ev, with_path=False)
    torch.cuda.synchronize()
    for M in (1, 2, 4, 8):
        for n_rows in (1, 2):
            b = B // n_rows
            rows = [statepar.split_states(
                hmm.GroupedTrans(*(x[i * b:(i + 1) * b] for x in gt[:3]),
                                 K=6),
                hmm.ModelArrays(*(x[i * b:(i + 1) * b] for x in model)),
                {k: v[i * b:(i + 1) * b] for k, v in ev.items()},
                [card] * M) for i in range(n_rows)]
            for with_path, ref in ((True, full), (False, score)):
                waves = (statepar.plan_waves(b, [card] * M, {
                    card: hmm.forward_wave_resident(card, with_path)})[card]
                    if M > 1 else [])
                want = statepar.viterbi_decode_statepar_plain(rows, with_path)
                n0 = (hmm.forward_wave_kernel.launches,
                      hmm.traceback_slices_kernel.launches)
                got = statepar.viterbi_decode_statepar(rows, with_path)
                torch.cuda.synchronize()
                assert (hmm.forward_wave_kernel.launches - n0[0],
                        hmm.traceback_slices_kernel.launches - n0[1]) == \
                    (n_rows * len(waves), n_rows if with_path and M > 1
                     else 0)
                assert len(waves) == (M > 1), waves
                for key in ref:
                    what = (inputs, M, n_rows, with_path, key)
                    g = torch.cat([o[key] for o in got])
                    w = torch.cat([o[key] for o in want])
                    assert g.device == card, what
                    assert torch.equal(_bits(g), _bits(w)), what
                    assert torch.equal(_bits(g), _bits(ref[key])), what
    if inputs == "NaN":
        assert torch.isnan(full["logp"]).any()


def _wave_ranks(card, B: int, T: int, M: int, seed: int) -> list:
    """K1m's ranks (statepar's WaveRanks, backpointers kept) of one data
    row of B reads of T events over M ranks on `card`."""
    from nanocall_tpu_torch.parallel import statepar

    gt, model, ev = _grouped_inputs(card, [T] * B, T, seed)
    return [statepar._wave_rank(p, True)
            for p in statepar.split_states(gt, model, ev, [card] * M)]


@pytest.mark.cuda
def test_statepar_wave_too_large_raises_on_the_card(card):
    """A K1m wave whose grid exceeds the blocks the card holds at once
    (one read more than forward_wave_resident // M, at M = 2) is refused
    by the cooperative launch and raises; nothing hangs and nothing is
    counted.  The largest wave that fits runs, bit-equal to the plain
    version."""
    M = 2
    per = hmm.forward_wave_resident(card, True) // M
    ranks = _wave_ranks(card, per + 1, 3, M, 23)
    want = [r._replace(col=r.col.clone(), bps=r.bps.clone()) for r in ranks]
    n0 = hmm.forward_wave_kernel.launches
    with pytest.raises(RuntimeError, match="viterbi_forward_wave"):
        hmm.forward_wave_kernel(ranks, list(range(M)), 0, per + 1)
    assert hmm.forward_wave_kernel.launches == n0
    hmm.forward_wave_kernel(ranks, list(range(M)), 0, per)
    hmm.viterbi_forward_wave_plain(want, 0, per)
    torch.cuda.synchronize()
    for r, w in zip(ranks, want):
        assert torch.equal(_bits(r.col[:, :per]), _bits(w.col[:, :per]))
        assert torch.equal(r.bps[:, :per], w.bps[:, :per])


@pytest.mark.cuda
def test_statepar_wave_timeout_on_the_card(card, tmp_path):
    """A K1m wave of one read whose peer never runs (rank 0 of 2 launched
    alone) waits out its timeout (0.5 s here), records (t, read, rank,
    peer) = (1, 3, 0, 1) in the host-mapped word and traps: the process's
    next synchronize raises; it does not hang.  In a process of its own,
    whose card context the trap ends."""
    import subprocess
    import sys

    script = tmp_path / "timeout.py"
    script.write_text(
        "import sys, torch\n"
        "sys.path[:0] = [%r, %r]\n"
        "from test_torch_cuda import _wave_ranks\n"
        "from nanocall_tpu_torch.ops import hmm\n"
        "card = torch.device('cuda', 0)\n"
        "hmm.WAVE_TIMEOUT_S = 0.5\n"
        "ranks = _wave_ranks(card, 5, 4, 2, 29)\n"
        "torch.cuda.synchronize()\n"
        "hmm.forward_wave_kernel(ranks, [0], 3, 4)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised', hmm.wave_timeout())\n"
        "    sys.exit(3)\n"
        "print('no error')\n" % (str(ROOT), str(ROOT / "tests")))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, (proc.stdout, proc.stderr[-2000:])
    assert "raised (1, 3, 0, 1)" in proc.stdout, proc.stdout


def _grouped_walk_inputs(dev, B: int, T: int, lengths, seed: int):
    """A grouped traceback's inputs drawn at random: final alphas (B,
    4096) and valid grouped backpointer bytes (stay 0, step 64 + [0, 4),
    skip 128 + [0, 16)) (T-1, B, 4096), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    fa = convert.tensor(rng.normal(0.0, 10.0, (B, 4096)).astype(np.float32),
                        dev)
    kind = rng.integers(0, 3, (T - 1, B, 4096))
    arg = rng.integers(0, 16, (T - 1, B, 4096))
    k = np.where(kind == 0, 0, np.where(kind == 1, 64 + (arg & 3), 128 + arg))
    bps = torch.from_numpy(k.astype(np.uint8)).to(dev)
    return fa, bps, convert.tensor(np.asarray(lengths), dev, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4, 64])
def test_traceback_slices_ring_bit_equal_on_the_card(card, M):
    """K2m on K2's row ring, each row assembled from M slices (64 copies of
    64 bytes a row at M = 64): path0, codes and logp bit-equal to K2's ring
    on the whole rows (the one-device walk) and to its plain version, on
    random final alphas and grouped backpointers of 300 reads at full
    lengths (more blocks than SMs) and of reads of lengths 0 to T, with a
    final alpha NaN at some states in one read."""
    W = 4096 // M
    for B, T, lengths in ((300, 64, [64] * 300),
                          (9, 200, [200, 0, 1, 2, 199, 200, 57, 200, 3])):
        fa, bps, ln = _grouped_walk_inputs(card, B, T, lengths, M + T)
        fa[4, [7, 2000]] = float("nan")
        column = [fa[:, m * W:(m + 1) * W].contiguous() for m in range(M)]
        slices = [bps[..., m * W:(m + 1) * W].contiguous() for m in range(M)]
        want = hmm.traceback_kernel(6, fa, bps, ln)
        plain = hmm.viterbi_traceback_slices_plain(6, column, slices, ln)
        n0 = hmm.traceback_slices_kernel.launches
        got = hmm.traceback_slices_kernel(6, column, slices, ln)
        torch.cuda.synchronize()
        assert hmm.traceback_slices_kernel.launches == n0 + 1
        for what, g, w, p in zip(("path0", "codes", "logp"), got, want,
                                 plain):
            assert torch.equal(_bits(g), _bits(w)), (M, B, what)
            assert torch.equal(_bits(g), _bits(p)), (M, B, what)


def _generic_tables(dev, tmp_path, B: int) -> dict:
    """The tables the generic mesh decode is held under: {name: (ops, the
    K6am form it takes)}: the loaded (0.14, 0.21) table (resident), the
    CLI priors' loaded table (streaming), per-read structured tables of
    four kinetics (resident, per read), the same without their packed
    layout (streaming, per read) and a random table of 25 slots
    (streaming; K6bm reads its from_idx from global memory)."""
    rng = np.random.default_rng(41)
    params = np.array([[0.1, 0.3], [0.14, 0.21], [0.15, 0.2],
                       [0.07, 0.35]])[np.arange(B) % 4]
    batch = convert.trans_ops_batch(
        *transitions.build_structured_batch(params, 6), 6, dev)
    idx = rng.integers(0, 4096, (25, 4096)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (25, 4096))).astype(np.float32)
    return {
        "(0.14, 0.21)": (_loaded_ops(dev, tmp_path, 0.14, 0.21), "resident"),
        "(0.1, 0.3)": (_loaded_ops(dev, tmp_path, 0.1, 0.3), "streaming"),
        "per-read": (batch, "resident"),
        "per-read streaming": (batch._replace(from_packed=None,
                                              from_codebook=None),
                               "streaming"),
        "random 25 slots": (convert.trans_ops(transitions.SparseTransitions(
            from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), dev),
            "streaming"),
    }


def _nan_generic_inputs(dev, T: int):
    """_k6_inputs of 6 reads with a NaN event in read 1, a NaN level mean
    at state 3000 of read 2 and a +inf event in read 3."""
    lengths = [T, 0, T, T, 1, T - 1]
    _, model, ev = _k6_inputs(dev, len(lengths), T, lengths, 43)
    ev["mean"][0, T // 2] = float("nan")
    model.level_mean[2, 3000] = float("nan")
    ev["mean"][3, T // 3] = float("inf")
    return model, ev


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_generic_statepar_kernels_bit_equal_on_the_card(card, tmp_path,
                                                        inputs):
    """K6am and K6bm, the generic decode with the 4096 states split over M =
    2, 4 and 8 ranks on cuda:0 (statepar.viterbi_decode_generic_statepar),
    against their plain versions over the same ranks and against K6a + K6b
    (hmm.viterbi_decode), path and score-only, every output as bits, under
    _generic_tables' five tables, on clean reads of lengths 0, 1, T-1 and T
    and on _nan_generic_inputs; one launch of K6am's form a wave and of
    K6bm a row; a row of one rank decodes by K6a + K6b."""
    from nanocall_tpu_torch.parallel import statepar

    T = 40
    if inputs == "clean":
        lengths = [T, 0, 1, T - 1, 17, T]
        _, model, ev = _k6_inputs(card, len(lengths), T, lengths, 42)
    else:
        model, ev = _nan_generic_inputs(card, T)
    B = ev["length"].shape[0]
    wrappers = {"resident": hmm.generic_wave_resident_kernel,
                "streaming": hmm.generic_wave_streaming_kernel}
    for name, (ops, form) in _generic_tables(card, tmp_path, B).items():
        for with_path in (True, False):
            ref = hmm.viterbi_decode(ops, model, ev, with_path=with_path)
            for M in (1, 2, 4, 8):
                rows = [statepar.split_table_states(ops, model, ev,
                                                    [card] * M)]
                want = statepar.viterbi_decode_generic_statepar_plain(
                    rows, with_path)
                n0 = (wrappers[form].launches,
                      hmm.generic_traceback_slices_kernel.launches)
                got = statepar.viterbi_decode_generic_statepar(rows,
                                                               with_path)
                torch.cuda.synchronize()
                assert (wrappers[form].launches - n0[0],
                        hmm.generic_traceback_slices_kernel.launches
                        - n0[1]) == (int(M > 1), int(M > 1 and with_path))
                for key in ref:
                    what = (inputs, name, M, with_path, key)
                    assert got[0][key].device == card, what
                    assert torch.equal(_bits(got[0][key]),
                                       _bits(want[0][key])), what
                    assert torch.equal(_bits(got[0][key]),
                                       _bits(ref[key])), what
            if inputs == "NaN":
                assert torch.isnan(ref["logp"]).any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_per_read_forward_bit_equal_on_the_card(card, tmp_path, inputs):
    """K6a under per-read tables (a per-read stride in both kernels): the
    resident kernel on the per-read packed layouts and the streaming one
    without them, path and score-only, bit-equal to the plain version, and
    K6b on its output; each read's path and logp equal to its decode
    alone under its own table."""
    T = 40
    if inputs == "clean":
        lengths = [T, 0, 1, T - 1, 17, T]
        _, model, ev = _k6_inputs(card, len(lengths), T, lengths, 44)
    else:
        model, ev = _nan_generic_inputs(card, T)
    tables = _generic_tables(card, tmp_path, ev["length"].shape[0])
    for name in ("per-read", "per-read streaming"):
        ops, route = tables[name]
        assert hmm.generic_forward_route(ops) == route
        for with_path in (True, False):
            want = hmm.viterbi_forward_plain(ops, model, ev, with_path)
            got = hmm.viterbi_forward(ops, model, ev, with_path)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got[0]), _bits(want[0])), name
            if with_path:
                assert torch.equal(got[1], want[1]), name
        dec = hmm.viterbi_decode(ops, model, ev)
        for b in range(ev["length"].shape[0]):
            one = hmm.viterbi_decode(
                ops._replace(from_logp=ops.from_logp[b],
                             to_logp=ops.to_logp[b],
                             from_packed=None if ops.from_packed is None
                             else ops.from_packed[b],
                             from_codebook=None if ops.from_codebook is None
                             else ops.from_codebook[b]),
                hmm.ModelArrays(*(x[b:b + 1] for x in model)),
                {k: v[b:b + 1] for k, v in ev.items()})
            assert torch.equal(dec["path"][b], one["path"][0]), (name, b)
            assert torch.equal(_bits(dec["logp"][b]),
                               _bits(one["logp"][0])), (name, b)


def _train_batch(dev, G: int, T: int, nan: bool, seed: int):
    """A training batch of G groups of 4 rows on `dev` (the r73 pair of
    models, events of random states of the scaled models, varied scaling
    and transitions): rows of length 0, 1, T - 1 and T in group 0, an
    invalid row in group 1; with `nan`, group 2 of full length with a NaN
    event in one row, a NaN level mean at one state of its template model
    and a +inf event in another row."""
    rng = np.random.default_rng(seed)
    S = 4
    ms = load_builtin_models("r73")
    pair = (ms["r73.t.006"], ms["r73.c.p1.006"])
    mdl = {f: np.stack([np.stack([getattr(p, f) for p in pair])] * G)
           .astype(np.float32)
           for f in ("level_mean", "level_stdv", "sd_mean", "sd_lambda")}
    pm = np.tile(np.array([1, 0, 0, 1, 1, 1], np.float32), (G, 1))
    pm[:, 0] = rng.uniform(0.95, 1.05, G)
    pm[:, 1] = rng.uniform(-1.0, 1.0, G)
    pm[:, 2] = rng.uniform(-0.01, 0.01, G)
    st = np.stack([rng.uniform(0.05, 0.2, (G, 2)),
                   rng.uniform(0.2, 0.4, (G, 2))], -1).astype(np.float32)
    strand = np.tile(np.array([0, 0, 1, 1], np.int32), (G, 1))
    lm = mdl["level_mean"][np.arange(G)[:, None, None], strand[:, :, None],
                           rng.integers(0, 4096, (G, S, T))]
    mean = (lm * pm[:, 0, None, None] + pm[:, 1, None, None]
            + rng.normal(0.0, 1.0, (G, S, T))).astype(np.float32)
    stdv = rng.uniform(0.6, 1.8, (G, S, T)).astype(np.float32)
    ev = {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
          "start": np.cumsum(rng.uniform(0.01, 0.03, (G, S, T)), -1)
          .astype(np.float32),
          "length": rng.integers(T // 2, T + 1, (G, S)).astype(np.int32),
          "strand": strand, "valid": np.ones((G, S), bool)}
    ev["length"][0] = [0, 1, T - 1, T]
    ev["valid"][1, 2] = False
    if nan:
        ev["length"][2] = T
        ev["mean"][2, 1, T // 2] = np.nan
        mdl["level_mean"][2, 0, 1234] = np.nan
        ev["mean"][2, 3, 3] = np.inf
    return convert.train_batch(ev, mdl, pm, st, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_train_statepar_kernels_bit_equal_on_the_card(card, inputs):
    """K4m and K5m, the EM round's kernels with the 4096 states split over
    M = 2, 4 and 8 ranks on cuda:0 (parallel/statepar.py), against their
    plain versions over the same ranks and against K4 + K5, every output as
    bits: K4m with the alphas stored and without, K5m with both train
    flags and each alone, on rows of lengths 0, 1, T-1 and T and an
    invalid row (clean) and on NaN / +inf inputs; one launch of each a
    wave (one wave here).  Then the placed round
    (statepar.train_one_round_placed on mesh.shard_train_inputs) on (1, M)
    and (2, M) meshes of cuda:0 against the unplaced round, with both
    flags, each alone and neither."""
    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em
    from nanocall_tpu_torch.parallel import mesh, statepar

    batch = _train_batch(card, 4, 24, inputs == "NaN", 17)
    inp = train.round_inputs(*batch, K=6)
    B = inp["x_unc"].shape[0]
    alphas, lpd = hmm.fwbw_grouped_forward(inp["gtf"], inp["model"],
                                           inp["ev"])
    for M in (2, 4, 8):
        W = 4096 // M
        ranks = statepar.split_round_states(*batch, [card] * M)
        for stored in (True, False):
            fk = [statepar._fwd_wave_rank(r, stored) for r in ranks]
            fp = [statepar._fwd_wave_rank(r, stored) for r in ranks]
            n0 = hmm.fwbw_forward_wave_kernel.launches
            statepar._wave_kernels(
                fk, hmm.fwbw_forward_wave_kernel,
                lambda d, sys: hmm.fwbw_forward_wave_resident(d, sys,
                                                              stored))
            hmm.fwbw_forward_wave_plain(fp, 0, B)
            torch.cuda.synchronize()
            assert hmm.fwbw_forward_wave_kernel.launches - n0 == 1
            for rk, rp in zip(fk, fp):
                what = (inputs, M, stored)
                assert torch.equal(_bits(rk.lpd), _bits(rp.lpd)), what
                assert torch.equal(_bits(rk.lpd), _bits(lpd)), what
                if stored:
                    assert torch.equal(_bits(rk.alphas), _bits(rp.alphas))
            if stored:
                got = torch.cat([r.alphas for r in fk], dim=2)
                assert torch.equal(_bits(got), _bits(alphas)), (inputs, M)
                fwd = fk
        for ts, tt in ((True, True), (True, False), (False, True)):
            want = em.em_backward_kernel(*train.em_backward_args(
                inp if ts else {**inp, "W": None}, lpd, alphas, ts, tt))
            bk = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
            bp = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
            n0 = em.em_backward_wave_kernel.launches
            statepar._wave_kernels(
                bk, lambda *a: em.em_backward_wave_kernel(*a, ts, tt),
                lambda d, sys: em.em_backward_wave_resident(d, sys, ts, W))
            em.em_backward_wave_plain(bp, 0, B, ts, tt)
            torch.cuda.synchronize()
            assert em.em_backward_wave_kernel.launches - n0 == 1
            for g, p, w in zip((bk[0].scal, bk[0].st3),
                               (bp[0].scal, bp[0].st3), want):
                what = (inputs, M, ts, tt)
                assert torch.equal(_bits(g), _bits(p)), what
                assert torch.equal(_bits(g), _bits(w)), what
        for D in (1, 2):
            grid = mesh.make_mesh(D * M, model_axis=M,
                                  devices=[card] * (D * M))
            placed = mesh.shard_train_inputs(grid, *batch)
            for ts, tt in ((True, True), (True, False), (False, True),
                           (False, False)):
                kw = dict(train_scaling=ts, train_transitions=tt)
                want = train.train_one_round(*batch, K=6, **kw)
                got = mesh.join(statepar.train_one_round_placed(*placed,
                                                                **kw))
                for k, v in want.items():
                    assert torch.equal(_bits(got[k]), _bits(v.cpu())), \
                        (inputs, M, D, ts, tt, k)
    if inputs == "NaN":
        assert torch.isnan(lpd).any()
