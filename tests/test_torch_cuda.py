"""Checks of the port's CUDA kernels that need the card (marker `cuda`).

Each test skips without a CUDA device.  The file imports neither JAX nor
nanocall_tpu, so it also runs on a machine that has only the port's
dependencies (tests/conftest.py imports JAX: pass --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same checks at the main path's full shapes; these
are small and quick.
"""

import itertools
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
    (17 distinct log-probs in some slots, at most 16 in a block of 1024
    states: K6a's layout at 4 codebooks a slot), per-read
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


#: a NaN payload that no kernel makes
POISON = 0x7FBADBAD


def _guarded_call(monkeypatch, wrapper, ops, model, ev, what) -> dict:
    """`wrapper`'s outputs written into rows 1 .. B of (B + 2, T, n)
    buffers filled with a NaN of a payload no kernel makes (through
    hmm._custom_outputs); fails if the kernel wrote row 0 or B + 1."""
    B, T = ev["mean"].shape
    bufs = {k: torch.full((B + 2, T, 4096), POISON, dtype=torch.int32,
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
            assert bool((v[row].view(torch.int32) == POISON).all()), \
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
    bits.  The in-memory table of the same kinetics (17 log-probs in a
    slot) takes the resident kernel at 4 codebooks a slot, and the
    streaming one without its K6a layout, both bit-equal to plain."""
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
    # viterbi_forward takes the resident kernel at 4 codebooks a slot
    # there, and the streaming one on it without its K6a layout
    ops17, _, _ = _k6_inputs(card, 1, 1, [1], 4)
    assert hmm.generic_forward_route(ops17) == "resident"
    assert hmm.resident_groups(ops17) == 4
    fa_p, bps_p = hmm.viterbi_forward_plain(ops17, model, ev, True)
    for o, wrapper in ((ops17, hmm.resident_forward_path_kernel),
                       (ops17._replace(from_packed=None, from_codebook=None),
                        hmm.generic_forward_path_kernel)):
        n0 = wrapper.launches
        fa_g, bps_g = hmm.viterbi_forward(o, model, ev)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
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
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_resident_forward_four_codebooks_on_the_card(card, tmp_path,
                                                     inputs):
    """K6a's resident kernel under the CLI priors' loaded table, whose
    layout takes 4 codebooks a slot (a thread's codebooks those of its
    block of 1024 states), path and score-only, bit-equal to its plain
    version (final alpha as bits, backpointers) at 16 x 2048, lengths 0,
    1, T-1 and T among the reads, one launch each through viterbi_forward;
    the streaming kernel on the table without its layout gives the same
    bits.  NaN: a NaN and a +inf event, and the table with a NaN in block
    3's codebook."""
    lengths = [2048, 0, 1, 2047] + list(
        np.random.default_rng(5).integers(2, 2048, 12))
    _, model, ev = _k6_inputs(card, 16, 2048, lengths, 5)
    tables = {"priors": _loaded_ops(card, tmp_path, 0.1, 0.3)}
    if inputs == "NaN":
        ev["mean"][0, 100] = float("nan")
        ev["mean"][5, 0] = float("inf")
        tables["NaN in block 3"] = _nan_in_block3(card, tmp_path)
    for name, ops in tables.items():
        assert hmm.generic_forward_route(ops) == "resident"
        assert hmm.resident_groups(ops) == 4
        fa_p, bps_p = hmm.viterbi_forward_plain(ops, model, ev, True)
        n0 = (hmm.resident_forward_path_kernel.launches,
              hmm.resident_forward_score_kernel.launches)
        fa_k, bps_k = hmm.viterbi_forward(ops, model, ev)
        fa_s, _ = hmm.viterbi_forward(ops, model, ev, with_path=False)
        bare = ops._replace(from_packed=None, from_codebook=None)
        fa_g, bps_g = hmm.viterbi_forward(bare, model, ev)
        torch.cuda.synchronize()
        assert (hmm.resident_forward_path_kernel.launches,
                hmm.resident_forward_score_kernel.launches) == (
                    n0[0] + 1, n0[1] + 1), name
        for got in (fa_k, fa_s, fa_g):
            assert torch.equal(_bits(got), _bits(fa_p)), name
        assert torch.equal(bps_k, bps_p) and torch.equal(bps_g, bps_p), name
        assert torch.isnan(fa_p).any() == (inputs == "NaN"), name


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
    and one of K2m for the card's rows; a row of one rank (M = 1) decodes
    by K1 + K2 and launches neither."""
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
                    (n_rows * len(waves), int(with_path and M > 1))
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


@pytest.mark.cuda
def test_em_statepar_wave_timeout_on_the_card(card, tmp_path):
    """test_statepar_wave_timeout_on_the_card's twin for K5m, at its second
    counter phase: a wave of one read whose peer never runs (rank 0 of 2
    launched alone, on K4m's alphas of both ranks), the peer's counter set
    to 1 as if it had published its first step's maxima and no more,
    passes the first phase, waits out its timeout (0.5 s here) at the
    second (the block sums), records (t, read, rank, peer) = (2, 3, 0, 1)
    and traps: the next synchronize raises; it does not hang.  In a
    process of its own, whose card context the trap ends."""
    import subprocess
    import sys

    script = tmp_path / "timeout.py"
    script.write_text(
        "import sys, torch\n"
        "sys.path[:0] = [%r, %r]\n"
        "from test_torch_cuda import _train_batch\n"
        "from nanocall_tpu_torch.ops import em, hmm\n"
        "from nanocall_tpu_torch.parallel import statepar\n"
        "card = torch.device('cuda', 0)\n"
        "hmm.WAVE_TIMEOUT_S = 0.5\n"
        "batch = _train_batch(card, 2, 6, False, 31)\n"
        "ranks = statepar.split_round_states(*batch, [card] * 2)\n"
        "fwd = [statepar._fwd_wave_rank(r, True) for r in ranks]\n"
        "hmm.fwbw_forward_wave_kernel(fwd, [0, 1], 0, 8)\n"
        "bwd = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]\n"
        "bwd[1].flags[3] = 1\n"
        "torch.cuda.synchronize()\n"
        "em.em_backward_wave_kernel(bwd, [0], 3, 4, True, True)\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised', hmm.wave_timeout())\n"
        "    sys.exit(3)\n"
        "print('no error')\n" % (str(ROOT), str(ROOT / "tests")))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, (proc.stdout, proc.stderr[-2000:])
    assert "raised (2, 3, 0, 1)" in proc.stdout, proc.stdout


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


def _slice_layouts(fa, bps, lengths, M: int, R: int) -> dict:
    """The final alphas (B, 4096) and backpointers (T - 1, B, 4096) of B
    reads cut into R data rows of B / R reads over M ranks, in each layout
    of the slices walks: {"tensor": (columns, bp_rows, lengths) with every
    rank's slice a view of one (R, M, T - 1, B / R, W) allocation,
    "copies": the same with a tensor a slice}, each argument a list a
    row."""
    Tm, B, n = bps.shape
    b, W = B // R, n // M
    columns = [[fa[r * b:(r + 1) * b, m * W:(m + 1) * W].contiguous()
                for m in range(M)] for r in range(R)]
    block = bps.view(Tm, R, b, M, W).permute(1, 3, 0, 2, 4).contiguous()
    rows_ln = [lengths[r * b:(r + 1) * b].contiguous() for r in range(R)]
    return {"tensor": (columns, [list(x) for x in block], rows_ln),
            "copies": (columns, [[x.clone() for x in row] for row in block],
                       rows_ln)}


#: the ranks the slices walks are held at on the card (64: 4 x 64 runs of
#: 64 bytes a stage), and the rows a launch walks
SLICES_RANKS = [2, 4, 8, 16, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("M", SLICES_RANKS)
def test_traceback_slices_ring_bit_equal_on_the_card(card, M):
    """K2m on K2's row ring, on both routes (one tensor copy a stage from
    the rows' one allocation; a bulk copy a row and rank), one and two data
    rows a launch: path0, codes and logp bit-equal to K2's ring on each
    row's whole rows (the one-device walk) and to its plain version, on
    random final alphas and grouped backpointers of 300 reads at full
    lengths (more blocks than SMs) and of reads of lengths 0 to T, clean
    and with a final alpha NaN at some states in one read; each launch
    counted on its route."""
    for B, T, lengths in ((300, 64, [64] * 300),
                          (10, 200, [200, 0, 1, 2, 199, 200, 57, 200, 3,
                                     5])):
        clean, bps, ln = _grouped_walk_inputs(card, B, T, lengths, M + T)
        for inputs in ("clean", "NaN"):
            fa = clean.clone()
            if inputs == "NaN":
                fa[4, [7, 2000]] = float("nan")
            for R in (1, 2):
                b = B // R
                want = [hmm.traceback_kernel(6, fa[r * b:(r + 1) * b],
                                             bps[:, r * b:(r + 1) * b]
                                             .contiguous(),
                                             ln[r * b:(r + 1) * b]
                                             .contiguous())
                        for r in range(R)]
                for route, args in _slice_layouts(fa, bps, ln, M,
                                                  R).items():
                    assert hmm.slices_walk_route(args[1]) == route
                    plain = [hmm.viterbi_traceback_slices_plain(6, *row)
                             for row in zip(*args)]
                    n0 = (hmm.traceback_slices_kernel.launches,
                          hmm.traceback_slices_kernel.routes[route])
                    got = hmm.traceback_slices_kernel(6, *args)
                    torch.cuda.synchronize()
                    assert (hmm.traceback_slices_kernel.launches,
                            hmm.traceback_slices_kernel.routes[route]) == \
                        (n0[0] + 1, n0[1] + 1)
                    for r in range(R):
                        for what, g, w, p in zip(("path0", "codes", "logp"),
                                                 got[r], want[r], plain[r]):
                            tag = (M, B, inputs, R, route, r, what)
                            assert torch.equal(_bits(g), _bits(w)), tag
                            assert torch.equal(_bits(g), _bits(p)), tag
                    if R == 1:
                        one = hmm.traceback_slices_kernel(
                            6, args[0][0], args[1][0], args[2][0], route)
                        for g, w in zip(one, got[0]):
                            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_traceback_slices_tensor_route_refuses_other_layouts(card):
    """The tensor route takes the rows' slices only as views of one
    allocation on the launch card: slices of their own raise, and nothing
    is counted."""
    fa, bps, ln = _grouped_walk_inputs(card, 4, 9, [9, 3, 0, 9], 5)
    columns, bp_rows, lengths = _slice_layouts(fa, bps, ln, 4, 1)["copies"]
    n0 = hmm.traceback_slices_kernel.launches
    with pytest.raises(ValueError, match="one"):
        hmm.traceback_slices_kernel(6, columns, bp_rows, lengths, "tensor")
    assert hmm.traceback_slices_kernel.launches == n0


def _nan_in_block3(dev, tmp_path):
    """The CLI priors' loaded table with a NaN log-prob at a state of block
    3 (states 3072-4095) in a slot whose block holds room for it: its K6a
    layout still takes 4 codebooks a slot, the NaN in block 3's codebook."""
    path = tmp_path / "s_priors_nan.tsv"
    transitions.save_tsv(transitions.build_structured(
        transitions.TransitionParams(0.1, 0.3), 6), path)
    st = transitions.load_tsv(str(path), 6)
    lp = np.array(st.from_logp, np.float32)
    k = next(k for k in range(lp.shape[0])
             if len(np.unique(lp[k, 3072:].view(np.int32))) <= 15)
    lp[k, 3500] = np.float32(np.nan)
    ops = convert.trans_ops(transitions.SparseTransitions(
        from_idx=st.from_idx, from_logp=lp, to_idx=st.to_idx,
        to_logp=st.to_logp, K=6), dev)
    assert hmm.resident_groups(ops) == 4
    book = ops.from_codebook[3 * lp.shape[0] + k]
    assert torch.isnan(book).any()
    return ops


def _mixed_batch_ops(dev, B: int):
    """Per-read structured tables of four kinetics whose odd reads carry an
    offset of g 2^-10 in block g of 1024 states: those reads need 4
    codebooks a slot, the others one, so the batch packs at 4."""
    params = np.array([[0.1, 0.3], [0.14, 0.21], [0.15, 0.2],
                       [0.07, 0.35]])[np.arange(B) % 4]
    flp, tlp = transitions.build_structured_batch(params, 6)
    flp[1::2] += (np.arange(4096) // 1024 * 2.0 ** -10).astype(np.float32)
    ops = convert.trans_ops_batch(flp, tlp, 6, dev)
    assert hmm.resident_groups(ops) == 4
    return ops


def _generic_tables(dev, tmp_path, B: int) -> dict:
    """The tables the generic mesh decode is held under: {name: (ops, the
    K6am form it takes)}: the loaded (0.14, 0.21) table (resident, one
    codebook a slot), the CLI priors' loaded table (resident at 4
    codebooks a slot), it with a NaN in block 3's codebook (resident) and
    without its packed layout (streaming), per-read structured tables of
    four kinetics (resident, per read), the same without their packed
    layout (streaming, per read), per-read tables of which half need 4
    codebooks a slot (resident, per read, at 4), a random table of 25
    slots (streaming; K6bm reads its from_idx from global memory) and a
    random table of 16 log-probs a block of 1024 states but 17 in one
    (streaming: no layout at 1 or 4 codebooks a slot)."""
    rng = np.random.default_rng(41)
    params = np.array([[0.1, 0.3], [0.14, 0.21], [0.15, 0.2],
                       [0.07, 0.35]])[np.arange(B) % 4]
    batch = convert.trans_ops_batch(
        *transitions.build_structured_batch(params, 6), 6, dev)
    idx = rng.integers(0, 4096, (25, 4096)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (25, 4096))).astype(np.float32)
    idx17, lp17 = random_block_table(rng, 21, 16, 4)
    lp17[5, 3072 + int(np.argmax(lp17[5, 3072:]))] = np.float32(-1e-3)
    priors = _loaded_ops(dev, tmp_path, 0.1, 0.3)
    return {
        "(0.14, 0.21)": (_loaded_ops(dev, tmp_path, 0.14, 0.21), "resident"),
        "(0.1, 0.3)": (priors, "resident"),
        "(0.1, 0.3) NaN in block 3": (_nan_in_block3(dev, tmp_path),
                                      "resident"),
        "(0.1, 0.3) streaming": (priors._replace(from_packed=None,
                                                 from_codebook=None),
                                 "streaming"),
        "per-read": (batch, "resident"),
        "per-read streaming": (batch._replace(from_packed=None,
                                              from_codebook=None),
                               "streaming"),
        "per-read at 4 codebooks": (_mixed_batch_ops(dev, B), "resident"),
        "random 25 slots": (convert.trans_ops(transitions.SparseTransitions(
            from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), dev),
            "streaming"),
        "random 17 values in a block": (convert.trans_ops(
            transitions.SparseTransitions(from_idx=idx17, from_logp=lp17,
                                          to_idx=idx17, to_logp=lp17, K=6),
            dev), "streaming"),
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
    2, 4, 8 and 16 ranks on cuda:0 (statepar.viterbi_decode_generic_statepar),
    against their plain versions over the same ranks and against K6a + K6b
    (hmm.viterbi_decode), path and score-only, every output as bits, under
    _generic_tables' five tables, on clean reads of lengths 0, 1, T-1 and T
    and on _nan_generic_inputs (every table's K6a layout at 1 and at 4
    codebooks a slot, each rank's cut holding its blocks' codebooks); K6am
    on its default path (a cluster a read up to 8 ranks) and, forced by
    cluster=False, on its cooperative path;
    one launch of K6am's form a row (one wave) and of K6bm a card, two
    rows of one table on the card walked in one launch; a row of one rank
    decodes by K6a + K6b.  Then K6bm alone on K6a's final alphas and
    backpointers cut over M = 2, 4, 8, 16 and 64 ranks, one and two rows a
    launch, on both routes (one tensor copy a stage; a bulk copy a row and
    rank) and under both from rules (the from-state table in shared memory
    and from_idx from global memory), bit-equal to its plain version and
    to K6b on each row's whole rows."""
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
    # (M, cluster): None the default path, False the cooperative one
    forms = [(1, None)] + [(M, c) for M in (2, 4, 8, 16)
                           for c in (None, False)]
    for name, (ops, form) in _generic_tables(card, tmp_path, B).items():
        assert hmm.generic_forward_route(ops) == form, name
        for with_path in (True, False):
            ref = hmm.viterbi_decode(ops, model, ev, with_path=with_path)
            for M, cluster in forms:
                rows = [statepar.split_table_states(ops, model, ev,
                                                    [card] * M)]
                want = statepar.viterbi_decode_generic_statepar_plain(
                    rows, with_path)
                n0 = (wrappers[form].launches,
                      hmm.generic_traceback_slices_kernel.launches)
                got = statepar.viterbi_decode_generic_statepar(
                    rows, with_path, cluster)
                torch.cuda.synchronize()
                assert (wrappers[form].launches - n0[0],
                        hmm.generic_traceback_slices_kernel.launches
                        - n0[1]) == (int(M > 1), int(M > 1 and with_path))
                for key in ref:
                    what = (inputs, name, M, cluster, with_path, key)
                    assert got[0][key].device == card, what
                    assert torch.equal(_bits(got[0][key]),
                                       _bits(want[0][key])), what
                    assert torch.equal(_bits(got[0][key]),
                                       _bits(ref[key])), what
            if inputs == "NaN":
                assert torch.isnan(ref["logp"]).any(), name
        if name in ("(0.14, 0.21)", "(0.1, 0.3)", "random 25 slots"):
            _generic_two_rows_one_walk(card, ops, model, ev, name)
        _generic_walks_both_routes(card, ops, model, ev, (inputs, name))


def _generic_two_rows_one_walk(card, ops, model, ev, name) -> None:
    """Two data rows of one table over 2 and 4 ranks on the card: K6bm
    walks both in one launch on the tensor route, path and logp bit-equal
    to K6a + K6b."""
    from nanocall_tpu_torch.parallel import statepar

    B = ev["length"].shape[0]
    ref = hmm.viterbi_decode(ops, model, ev)
    half = [slice(0, B // 2), slice(B // 2, B)]
    for M in (2, 4):
        rows = [statepar.split_table_states(
            ops, hmm.ModelArrays(*(x[h] for x in model)),
            {k: v[h] for k, v in ev.items()}, [card] * M) for h in half]
        n0 = dict(hmm.generic_traceback_slices_kernel.routes)
        got = statepar.viterbi_decode_generic_statepar(rows)
        torch.cuda.synchronize()
        assert hmm.generic_traceback_slices_kernel.routes == \
            {"tensor": n0["tensor"] + 1, "copies": n0["copies"]}, name
        for key in ("path", "logp"):
            g = torch.cat([o[key] for o in got])
            assert torch.equal(_bits(g), _bits(ref[key])), (name, M, key)


def _generic_walks_both_routes(card, ops, model, ev, what) -> None:
    """K6bm alone on K6a's outputs cut over SLICES_RANKS ranks (the last
    part of test_generic_statepar_kernels_bit_equal_on_the_card)."""
    fa, bps = hmm.viterbi_forward(ops, model, ev)
    lengths = ev["length"]
    B = lengths.shape[0]
    rules = [("from_idx", ops._replace(from_states=None))]
    if ops.from_states is not None:
        rules.append(("from-state table", ops))
    for rule, t in rules:
        for R in (1, 2):
            b = B // R
            want = [hmm.viterbi_traceback(
                ops, fa[r * b:(r + 1) * b],
                bps[:, r * b:(r + 1) * b].contiguous(),
                lengths[r * b:(r + 1) * b].contiguous()) for r in range(R)]
            for M in SLICES_RANKS:
                for route, args in _slice_layouts(fa, bps, lengths, M,
                                                  R).items():
                    plain = [hmm.viterbi_traceback_generic_slices_plain(
                        t, *row) for row in zip(*args)]
                    n0 = hmm.generic_traceback_slices_kernel.routes[route]
                    got = hmm.generic_traceback_slices_kernel(t, *args,
                                                              route=route)
                    torch.cuda.synchronize()
                    assert hmm.generic_traceback_slices_kernel.routes[
                        route] == n0 + 1
                    for r in range(R):
                        for key, g, w, p in zip(("path", "logp"), got[r],
                                                want[r], plain[r]):
                            tag = (*what, rule, R, M, route, r, key)
                            assert torch.equal(_bits(g), _bits(w)), tag
                            assert torch.equal(_bits(g), _bits(p)), tag


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_per_read_forward_bit_equal_on_the_card(card, tmp_path, inputs):
    """K6a under per-read tables (a per-read stride in both kernels): the
    resident kernel on the per-read packed layouts (at 1 codebook a slot,
    and at 4 where half the reads need 4) and the streaming one without
    them, path and score-only, bit-equal to the plain version, and K6b on
    its output; each read's path and logp equal to its decode alone under
    its own table."""
    T = 40
    if inputs == "clean":
        lengths = [T, 0, 1, T - 1, 17, T]
        _, model, ev = _k6_inputs(card, len(lengths), T, lengths, 44)
    else:
        model, ev = _nan_generic_inputs(card, T)
    tables = _generic_tables(card, tmp_path, ev["length"].shape[0])
    for name in ("per-read", "per-read streaming", "per-read at 4 codebooks"):
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


#: K6c's and K6e's per-read kernel wrappers by (function, form), with the
#: one-table wrapper of the same form and the plain version
PER_READ_FWBW = {
    ("fwbw", "resident"): (hmm.fwbw_resident_per_read_kernel,
                           hmm.fwbw_resident_kernel, hmm.fwbw_plain),
    ("fwbw", "streaming"): (hmm.fwbw_generic_per_read_kernel,
                            hmm.fwbw_generic_kernel, hmm.fwbw_plain),
    ("fwbw_custom", "resident"): (hmm.fwbw_custom_resident_per_read_kernel,
                                  hmm.fwbw_custom_resident_kernel,
                                  hmm.fwbw_custom_plain),
    ("fwbw_custom", "streaming"): (hmm.fwbw_custom_per_read_kernel,
                                   hmm.fwbw_custom_kernel,
                                   hmm.fwbw_custom_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_per_read_fwbw_bit_equal_on_the_card(card, inputs, monkeypatch):
    """K6c and K6e under per-read structured tables (transitions.
    build_structured_batch, convert.trans_ops_batch), each kernel's
    per-read instance: the resident ones on the per-read packed layouts of
    both sides and the streaming ones without them, through hmm.fwbw and
    hmm.fwbw_custom (one launch of the per-read wrapper counted, none of
    the one-table one), every output bit-equal to the plain version; K6e's
    again into outputs between guard rows, which it leaves as they were;
    lengths 0, 1, 2, T-1 and T among the reads (K6E_EDGE_LENGTHS), clean
    and with NaN events in one read from its middle on, a +inf event in
    another and a NaN model entry at one state of a third.  Then each
    read's outputs bit-equal to the read alone through the one-table
    kernel of the same form, under its own table (convert.trans_ops of
    build_structured at its kinetics)."""
    T = 40
    lengths = _edge_lengths(T, (T, T, T, 17))
    B = len(lengths)
    _, model, ev = _k6_inputs(card, B, T, lengths, 45)
    if inputs == "NaN":
        _nan_fwbw_events(ev, (8, 10))
        model.level_mean[9, 99] = float("nan")
    rng = np.random.default_rng(46)
    params = np.stack([rng.uniform(0.05, 0.2, B),
                       rng.uniform(0.2, 0.4, B)], 1)
    batch = convert.trans_ops_batch(
        *transitions.build_structured_batch(params, 6), 6, card)
    alone = [convert.trans_ops(transitions.build_structured(
        transitions.TransitionParams(*p), 6), card) for p in params]
    forms = {"resident": batch,
             "streaming": batch._replace(fwbw_packed=None)}
    for (fn, form), (per, one, plain) in PER_READ_FWBW.items():
        ops = forms[form]
        assert hmm.fwbw_route(ops) == form
        want = plain(ops, model, ev)
        n0, n1 = per.launches, one.launches
        got = getattr(hmm, fn)(ops, model, ev)
        torch.cuda.synchronize()
        what = (fn, form)
        assert (per.launches - n0, one.launches - n1) == (1, 0), what
        if inputs == "NaN":
            k = "gamma" if fn == "fwbw_custom" else "alpha"
            assert torch.isnan(want[k][8]).any(), what
            assert torch.isnan(want[k][9]).any(), what
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (what, k)
        if fn == "fwbw_custom":
            out = _guarded_call(monkeypatch, per, ops, model, ev, what)
            for k in want:
                assert torch.equal(_bits(out[k]), _bits(want[k])), \
                    (what, k, "guarded")
        for b, o in enumerate(alone):
            o = o if form == "resident" else o._replace(fwbw_packed=None)
            assert hmm.fwbw_route(o) == form
            solo = one(o, hmm.ModelArrays(*(x[b:b + 1] for x in model)),
                       {k: v[b:b + 1] for k, v in ev.items()})
            torch.cuda.synchronize()
            for k in want:
                assert torch.equal(_bits(got[k][b]), _bits(solo[k][0])), \
                    (what, b, k)


def _random_stream_ops(dev, deg: int, seed: int, reads: int = 0):
    """A table of `deg` slots a side of random states and log-probs (no
    packed layout: the streaming K6c and K6e take it), from a numpy seed;
    with reads > 0, per-read (reads, deg, n) log-probs over its slot
    maps."""
    rng = np.random.default_rng(seed)
    lead = (reads,) if reads else ()
    sides = []
    for _ in range(2):
        idx = rng.integers(0, 4096, (deg, 4096)).astype(np.int32)
        lp = np.log(rng.uniform(0.01, 1.0, (*lead, deg, 4096))).astype(
            np.float32)
        sides.append((idx, lp))
    (fi, fl), (ti, tl) = sides
    ops = convert.trans_ops(transitions.SparseTransitions(
        from_idx=fi, from_logp=fl[0] if reads else fl, to_idx=ti,
        to_logp=tl[0] if reads else tl, K=6), dev)
    if reads:
        ops = ops._replace(from_logp=convert.tensor(fl, dev),
                           to_logp=convert.tensor(tl, dev))
    assert hmm.fwbw_route(ops) == "streaming"
    return ops


#: the streaming K6c and K6e: their one-table and per-read wrappers, the
#: plain version and the function that allocates the outputs
STREAM_FWBW = {
    "fwbw": (hmm.fwbw_generic_kernel, hmm.fwbw_generic_per_read_kernel,
             hmm.fwbw_plain, "_fwbw_outputs"),
    "fwbw_custom": (hmm.fwbw_custom_kernel, hmm.fwbw_custom_per_read_kernel,
                    hmm.fwbw_custom_plain, "_custom_outputs"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_streaming_fwbw_bit_equal_on_the_card(card, inputs, monkeypatch):
    """The streaming K6c and K6e, one table and per read, through
    hmm.fwbw and hmm.fwbw_custom: B = 11 reads of lengths 0, 1, 2, T-1, T
    and others, under random tables of 1, 21 and 40 slots, clean and with
    NaN events in one read from its middle on, a +inf event in another
    and a NaN model entry at one state of a third: every output bit-equal
    to the plain version, written into buffers between guard rows, which
    the kernel leaves as they were; one launch counted on the instance's
    wrapper."""
    T = 24
    lengths = [T, 0, 1, 2, T - 1, T, T, 5, T, 13, T]
    B = len(lengths)
    _, model, ev = _k6_inputs(card, B, T, lengths, 71)
    if inputs == "NaN":
        _nan_fwbw_events(ev, (5, 6))
        model.level_mean[8, 99] = float("nan")
    for deg in (1, 21, 40):
        for per_read in (False, True):
            ops = _random_stream_ops(card, deg, 80 + deg, B if per_read else 0)
            for fn, (one, per, plain, alloc) in STREAM_FWBW.items():
                wrapper = per if per_read else one
                what = (fn, deg, per_read, inputs)
                want = plain(ops, model, ev)
                if inputs == "NaN":
                    k = "gamma" if fn == "fwbw_custom" else "alpha"
                    assert torch.isnan(want[k][5]).any(), what
                bufs = {k: torch.full((B + 2, *v.shape[1:]), POISON,
                                      dtype=torch.int32,
                                      device=card).view(torch.float32)
                        for k, v in want.items()}
                out = {k: v[1:B + 1] for k, v in bufs.items()}
                n0 = wrapper.launches
                with monkeypatch.context() as m:
                    m.setattr(hmm, alloc, lambda *_: out)
                    got = getattr(hmm, fn)(ops, model, ev)
                torch.cuda.synchronize()
                assert got is out, what
                assert wrapper.launches == n0 + 1, what
                for k in want:
                    assert torch.equal(_bits(got[k]), _bits(want[k])), \
                        (what, k)
                for k, v in bufs.items():
                    for row in (0, B + 1):
                        assert bool((v[row].view(torch.int32)
                                     == POISON).all()), \
                            (what, k, f"guard row {row} written")


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_fwbw_split_forms_bit_equal_on_the_card(card, inputs, monkeypatch):
    """The streaming K6c and K6e (the one-card split) in every form the
    route takes (S of hmm.FWBW_SPLIT_STATES states a thread, whatever the
    read count), one table and per read, at B = 11 reads of lengths 0, 1,
    2, T - 1, T and others under random tables of 1, 21 and 40 slots,
    clean and with NaN events, a +inf event and a NaN model entry: every
    output bit-equal to fwbw_plain / fwbw_custom_plain (and to the split's
    own plain version at (C, S) = (FWBW_SPLIT_CUTS, S)), written into
    buffers between guard rows that no block touches; one launch counted a
    call."""
    T = 24
    lengths = [T, 0, 1, 2, T - 1, T, T, 5, T, 13, T]
    B = len(lengths)
    _, model, ev = _k6_inputs(card, B, T, lengths, 72)
    if inputs == "NaN":
        _nan_fwbw_events(ev, (5, 6))
        model.level_mean[8, 99] = float("nan")
    for deg in (1, 21, 40):
        for per_read in (False, True):
            ops = _random_stream_ops(card, deg, 90 + deg, B if per_read else 0)
            for fn, (one, per, plain, alloc) in STREAM_FWBW.items():
                wrapper = per if per_read else one
                want = plain(ops, model, ev)
                for S in hmm.FWBW_SPLIT_STATES:
                    what = (fn, deg, per_read, inputs, S)
                    split = (hmm.fwbw_custom_split_plain if fn == "fwbw_custom"
                             else hmm.fwbw_split_plain)(
                        ops, model, ev, hmm.FWBW_SPLIT_CUTS, S)
                    for k in want:
                        assert torch.equal(_bits(split[k]), _bits(want[k])), \
                            (what, k, "plain split")
                    bufs = {k: torch.full((B + 2, *v.shape[1:]), POISON,
                                          dtype=torch.int32,
                                          device=card).view(torch.float32)
                            for k, v in want.items()}
                    out = {k: v[1:B + 1] for k, v in bufs.items()}
                    n0 = wrapper.launches
                    with monkeypatch.context() as m:
                        m.setattr(hmm, alloc, lambda *_: out)
                        got = one(ops, model, ev, S)
                    torch.cuda.synchronize()
                    assert got is out, what
                    assert wrapper.launches == n0 + 1, what
                    for k in want:
                        assert torch.equal(_bits(got[k]), _bits(want[k])), \
                            (what, k)
                    for k, v in bufs.items():
                        for row in (0, B + 1):
                            assert bool((v[row].view(torch.int32)
                                         == POISON).all()), \
                                (what, k, f"guard row {row} written")


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


#: the rank counts of the state-axis card tests, each a case of its own
#: (the 64-rank folds alone: -k "64")
STATEPAR_RANKS = (2, 4, 8, 64)
@pytest.mark.cuda
def test_k4m_log_pr_data_reads_every_rank_after_its_counter_on_the_card(
        card, tmp_path):
    """The 64-rank folds (the cooperative path) of K4m's and K6cm's log
    Pr[data] and of K5m's statistics, which add one partial a rank
    pairwise in rank order: lane l adds ranks 2 l and 2 l + 1, and must
    read them only after its own wait on their counters
    (wave_exchange.cuh wait_fold_ranks; a stale partial sum once put lpd a
    few ULP off, in about one launch in ten).  Each rank's partials (K4m's
    and K6cm's part, K5m's per-step records) start as a NaN of a payload
    no kernel makes, and 40 launches of each give the plain version's
    outputs as bits, on every rank: K4m's lpd, K5m's statistics with both
    train flags, K6cm's (resident, under the loaded table of (0.14, 0.21))
    alpha, beta, em and lpd."""
    from nanocall_tpu_torch.ops import em
    from nanocall_tpu_torch.parallel import statepar

    M, W = 64, 64
    batch = _train_batch(card, 4, 24, False, 17)
    ranks = statepar.split_round_states(*batch, [card] * M)
    want = [statepar._fwd_wave_rank(r, False) for r in ranks]
    B = want[0].lpd.shape[0]
    hmm.fwbw_forward_wave_plain(want, 0, B)
    for i in range(40):
        fk = [statepar._fwd_wave_rank(r, False) for r in ranks]
        for f in fk:
            f.part.view(torch.int32).fill_(POISON)
        statepar._wave_kernels(
            fk, lambda *a: hmm.fwbw_forward_wave_kernel(*a, None),
            lambda d, sys: hmm.fwbw_forward_wave_resident(d, sys, W),
            clusters=True)
        torch.cuda.synchronize()
        for m, f in enumerate(fk):
            assert torch.equal(_bits(f.lpd), _bits(want[0].lpd)), (i, m)
    # K5m on the plain forward's stored alphas
    fwd = [statepar._fwd_wave_rank(r, True) for r in ranks]
    hmm.fwbw_forward_wave_plain(fwd, 0, B)
    bp = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
    em.em_backward_wave_plain(bp, 0, B, True, True)
    for i in range(40):
        bk = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
        for r in bk:
            r.red.view(torch.int32).fill_(POISON)
        statepar._wave_kernels(
            bk, lambda *a: em.em_backward_wave_kernel(*a, True, True, None),
            lambda d, sys: em.em_backward_wave_resident(d, sys, True, W),
            clusters=True)
        torch.cuda.synchronize()
        for g, p in zip((bk[0].scal, bk[0].st3), (bp[0].scal, bp[0].st3)):
            assert torch.equal(_bits(g), _bits(p)), ("K5m", i)
    # K6cm: its ranks built as statepar._fwbw_generic_row builds them
    ops = _loaded_ops(card, tmp_path, 0.14, 0.21)
    every = torch.arange(B, device=card)
    sub = [statepar._select_rank_rows(r, every) for r in ranks]
    T = sub[0]["ev"]["mean"].shape[1]
    plain = statepar._fwbw_generic_row(ops, sub, False, None)

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=card)

    for i in range(40):
        rows = []
        for m, s in enumerate(sub):
            rows.append(hmm.FwbwWaveRank(
                hmm.cut_fwbw_table(ops, slice(m * W, (m + 1) * W), card),
                s["model"], s["ev"], buf(B, T, W), buf(B, T, W),
                buf(B, T, W), buf(B), buf(2, B, W),
                torch.full((2, B), POISON, dtype=torch.int32,
                           device=card).view(torch.float32),
                torch.zeros(B, dtype=torch.int32, device=card)))
        statepar._wave_kernels(
            rows, lambda *a: hmm.fwbw_generic_wave_kernel(*a, cluster=None),
            lambda d, sys: hmm.fwbw_wave_resident(d, sys, True, 21, W),
            clusters=True)
        torch.cuda.synchronize()
        for m, (r, p) in enumerate(zip(rows, plain)):
            for k, g in (("alpha", r.alpha), ("beta", r.beta),
                         ("em", r.em), ("log_pr_data", r.lpd)):
                assert torch.equal(_bits(g), _bits(p[k])), ("K6cm", i, m, k)


@pytest.mark.cuda
@pytest.mark.parametrize("M", STATEPAR_RANKS)
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_train_statepar_kernels_bit_equal_on_the_card(card, inputs, M):
    """K4m and K5m, the EM round's kernels with the 4096 states split over
    M = 2, 4, 8 or 64 ranks (a case each) on cuda:0 (parallel/statepar.py),
    against
    their plain versions over the same ranks and against K4 + K5, every
    output as bits: K4m with the alphas stored and without, on its default
    path (a cluster a read up to 8 ranks) and, up to 8 ranks, on its
    cooperative path; K5m with both train flags and each alone, on both
    paths;
    on rows of lengths 0, 1, T-1 and T and an invalid row (clean) and on
    NaN / +inf inputs; one launch of each (one wave).  Then the placed round
    (statepar.train_one_round_placed on mesh.shard_train_inputs) on (1, M)
    and (2, M) meshes of cuda:0 against the unplaced round, with both
    flags, each alone and neither (M < 64)."""
    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em
    from nanocall_tpu_torch.parallel import mesh, statepar

    batch = _train_batch(card, 4, 24, inputs == "NaN", 17)
    inp = train.round_inputs(*batch, K=6)
    B = inp["x_unc"].shape[0]
    alphas, lpd = hmm.fwbw_grouped_forward(inp["gtf"], inp["model"],
                                           inp["ev"])
    W = 4096 // M
    ranks = statepar.split_round_states(*batch, [card] * M)
    # (stored, cluster): None the default path
    forms = [(True, None), (False, None)]
    if M <= hmm.MAX_CLUSTER:
        forms += [(True, False)]
    for stored, cluster in forms:
        fk = [statepar._fwd_wave_rank(r, stored) for r in ranks]
        fp = [statepar._fwd_wave_rank(r, stored) for r in ranks]
        n0 = hmm.fwbw_forward_wave_kernel.launches
        statepar._wave_kernels(
            fk, lambda *a: hmm.fwbw_forward_wave_kernel(*a, cluster),
            lambda d, sys: hmm.fwbw_forward_wave_resident(d, sys, W),
            clusters=cluster is None)
        hmm.fwbw_forward_wave_plain(fp, 0, B)
        torch.cuda.synchronize()
        assert hmm.fwbw_forward_wave_kernel.launches - n0 == 1
        for rk, rp in zip(fk, fp):
            what = (inputs, M, stored, cluster)
            assert torch.equal(_bits(rk.lpd), _bits(rp.lpd)), what
            assert torch.equal(_bits(rk.lpd), _bits(lpd)), what
            if stored:
                assert torch.equal(_bits(rk.alphas), _bits(rp.alphas))
        if stored:
            got = torch.cat([r.alphas for r in fk], dim=2)
            assert torch.equal(_bits(got), _bits(alphas)), (inputs, M)
            fwd = fk
    paths = (None, False) if M <= hmm.MAX_CLUSTER else (None,)
    for (ts, tt), cluster in itertools.product(
            ((True, True), (True, False), (False, True)), paths):
        want = em.em_backward_kernel(*train.em_backward_args(
            inp if ts else {**inp, "W": None}, lpd, alphas, ts, tt))
        bk = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
        bp = [statepar._em_wave_rank(r, f) for r, f in zip(ranks, fwd)]
        n0 = em.em_backward_wave_kernel.launches
        statepar._wave_kernels(
            bk, lambda *a: em.em_backward_wave_kernel(*a, ts, tt,
                                                      cluster),
            lambda d, sys: em.em_backward_wave_resident(d, sys, ts, W),
            clusters=cluster is None)
        em.em_backward_wave_plain(bp, 0, B, ts, tt)
        torch.cuda.synchronize()
        assert em.em_backward_wave_kernel.launches - n0 == 1
        for g, p, w in zip((bk[0].scal, bk[0].st3),
                           (bp[0].scal, bp[0].st3), want):
            what = (inputs, M, ts, tt, cluster)
            assert torch.equal(_bits(g), _bits(p)), what
            assert torch.equal(_bits(g), _bits(w)), what
    for D in ((1, 2) if M < 64 else ()):
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


@pytest.mark.cuda
@pytest.mark.parametrize("M", STATEPAR_RANKS)
@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_legacy_statepar_kernels_bit_equal_on_the_card(card, tmp_path,
                                                       inputs, M):
    """K6cm and K6dm, the legacy EM round's kernels with the 4096 states
    split over M = 2, 4, 8 or 64 ranks (a case each) on cuda:0
    (parallel/statepar.py),
    against their plain versions over the same ranks and against K6c and
    K6d on the whole rows, every output as bits: K6cm in its resident form
    under the loaded tables of (0.14, 0.21) and of the CLI priors (0.1,
    0.3) and in its streaming form (the (0.14, 0.21) table without its
    packed layout), K6dm after K4m, each on its default path (a cluster a
    read up to 8 ranks) and, up to 8 ranks, on its cooperative path; on
    rows of lengths 0, 1, T-1 and T and an invalid row (clean) and on NaN
    / +inf inputs; one launch of each (one wave).  Then the placed legacy
    round (statepar.train_one_round_placed(default_ops=...)) on (1, M) and
    (2, M) meshes of cuda:0 against the unplaced one, with rows at the
    priors and off them in every data row (M < 64)."""
    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em
    from nanocall_tpu_torch.parallel import mesh, statepar

    priors = (0.1, 0.3)
    ev, mdl, pm, st = _train_batch(card, 4, 24, inputs == "NaN", 17)
    st = st.clone()
    st[0, 0] = st[3, 0] = st[2, 1] = torch.tensor(priors)
    batch = (ev, mdl, pm, st)
    inp = train.round_inputs(*batch, K=6)
    B = inp["x_unc"].shape[0]
    loaded = _loaded_ops(card, tmp_path, 0.14, 0.21)
    tables = {"(0.14, 0.21)": loaded,
              "(0.1, 0.3)": _loaded_ops(card, tmp_path, *priors),
              "streaming": loaded._replace(fwbw_packed=None)}
    k6c = {name: hmm.fwbw(ops, inp["model"], inp["ev"])
           for name, ops in tables.items()}
    k6d = hmm.fwbw_grouped(inp["gtf"], inp["model"], inp["ev"])
    every = torch.arange(B, device=card)
    ranks = statepar.split_round_states(*batch, [card] * M)
    sub = [statepar._select_rank_rows(r, every) for r in ranks]
    paths = (None, False) if M <= hmm.MAX_CLUSTER else (None,)
    for (name, ops), cluster in itertools.product(tables.items(), paths):
        wrapper = (hmm.fwbw_wave_streaming_kernel if name == "streaming"
                   else hmm.fwbw_wave_resident_kernel)
        n0 = wrapper.launches
        got = statepar._fwbw_generic_row(ops, sub, True, cluster)
        plain = statepar._fwbw_generic_row(ops, sub, False, cluster)
        torch.cuda.synchronize()
        assert wrapper.launches - n0 == 1
        what = (inputs, M, name, cluster)
        for k in ("alpha", "beta", "em", "log_pr_data"):
            for g, p in zip(got, plain):
                assert torch.equal(_bits(g[k]), _bits(p[k])), (what, k)
        for k in ("alpha", "beta", "em"):
            whole = torch.cat([g[k] for g in got], dim=-1)
            assert torch.equal(_bits(whole), _bits(k6c[name][k])), \
                (what, k)
        for g in got:
            assert torch.equal(_bits(g["log_pr_data"]),
                               _bits(k6c[name]["log_pr_data"])), what
    for cluster in paths:
        n0 = em.fwbw_backward_wave_kernel.launches
        got = statepar._fwbw_grouped_row(sub, True, cluster)
        plain = statepar._fwbw_grouped_row(sub, False, cluster)
        torch.cuda.synchronize()
        assert em.fwbw_backward_wave_kernel.launches - n0 == 1
        for k in ("alpha", "beta", "em", "log_pr_data"):
            for g, p in zip(got, plain):
                assert torch.equal(_bits(g[k]), _bits(p[k])), \
                    (inputs, M, cluster, k)
            whole = (got[0][k] if k == "log_pr_data"
                     else torch.cat([g[k] for g in got], dim=-1))
            assert torch.equal(_bits(whole), _bits(k6d[k])), \
                (inputs, M, cluster, k)
    for D in ((1, 2) if M < 64 else ()):
        grid = mesh.make_mesh(D * M, model_axis=M,
                              devices=[card] * (D * M))
        placed = mesh.shard_train_inputs(grid, *batch)
        for ts, tt in ((True, True), (False, False)):
            kw = dict(train_scaling=ts, train_transitions=tt,
                      default_ops=loaded, default_priors=priors)
            want = train.train_one_round(*batch, K=6, **kw)
            got = mesh.join(statepar.train_one_round_placed(*placed,
                                                            **kw))
            for k, v in want.items():
                assert torch.equal(_bits(got[k]), _bits(v.cpu())), \
                    (inputs, M, D, ts, tt, k)
    if inputs == "NaN":
        assert torch.isnan(k6c["(0.14, 0.21)"]["log_pr_data"]).any()


#: the rank counts of the block-reads card test (16 and 64: the cooperative
#: path alone)
BLOCK_READS_RANKS = (2, 4, 8, 16, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("M", BLOCK_READS_RANKS)
def test_legacy_statepar_block_reads_bit_equal_on_the_card(card, tmp_path,
                                                           monkeypatch, M):
    """K6cm's blocks of several reads and K6dm on their edge rows, over M =
    2, 4, 8, 16 or 64 ranks on cuda:0: 13 of the NaN batch's 16 rows (a
    count that 2, 4 and 8 reads a block do not divide: the last group holds
    fewer reads than a block), its first group of lengths 0, 1, 2 and T
    (one block at 4 reads a block, two at 2), a NaN event, a NaN model
    entry and a +inf event in rows whose blocks hold clean rows too; K6cm
    in its resident form under the loaded tables of (0.14, 0.21) and of the
    CLI priors (0.1, 0.3) and in its streaming form, on the cluster path
    (up to 8 ranks) and the cooperative path, each at its own reads a
    block (hmm.fwbw_wave_reads) and forced to 1, 2 and 4 where they fit,
    K6dm after K4m on both paths, one launch each: every output bit-equal
    to the plain version over the same ranks and, joined, to K6c's and
    K6d's on the same rows."""
    from nanocall_tpu_torch import train
    from nanocall_tpu_torch.ops import em
    from nanocall_tpu_torch.parallel import statepar

    T = 24
    ev, mdl, pm, st = _train_batch(card, 4, T, True, 23)
    ev = dict(ev)
    ev["length"] = ev["length"].clone()
    ev["length"][0] = torch.tensor([0, 1, 2, T])
    batch = (ev, mdl, pm, st)
    inp = train.round_inputs(*batch, K=6)
    rows = torch.arange(13, device=card)
    W = 4096 // M
    loaded = _loaded_ops(card, tmp_path, 0.14, 0.21)
    tables = {"(0.14, 0.21)": loaded,
              "(0.1, 0.3)": _loaded_ops(card, tmp_path, 0.1, 0.3),
              "streaming": loaded._replace(fwbw_packed=None)}
    sub = [statepar._select_rank_rows(r, rows)
           for r in statepar.split_round_states(*batch, [card] * M)]
    gtf, model, ev13 = train._select_rows(inp, rows)
    paths = (None, False) if M <= hmm.MAX_CLUSTER else (False,)
    reads_of = hmm.fwbw_wave_reads
    for name, ops in tables.items():
        resident = name != "streaming"
        k6c = hmm.fwbw(ops, model, ev13)
        plain = statepar._fwbw_generic_row(ops, sub, False, None)
        assert torch.isnan(k6c["log_pr_data"]).any(), name
        for cluster in paths:
            on = cluster is None
            own = reads_of(W, 21, resident, on)
            counts = {own} | {R for R in (1, 2, 4)
                              if R * W // 4 >= 32 and R <= 4096 // W
                              and hmm.fwbw_wave_smem(R, W, 21, resident, on)
                              <= hmm.FWBW_WAVE_SMEM}
            for reads in sorted(counts):
                assert reads == 1 or 13 % reads
                monkeypatch.setattr(hmm, "fwbw_wave_reads",
                                    lambda *a, reads=reads, **k: reads)
                wrapper = (hmm.fwbw_wave_resident_kernel if resident
                           else hmm.fwbw_wave_streaming_kernel)
                n0 = wrapper.launches
                got = statepar._fwbw_generic_row(ops, sub, True, cluster)
                torch.cuda.synchronize()
                monkeypatch.undo()
                assert wrapper.launches - n0 == 1
                what = (M, name, cluster, reads)
                for k in ("alpha", "beta", "em", "log_pr_data"):
                    for g, p in zip(got, plain):
                        assert torch.equal(_bits(g[k]), _bits(p[k])), \
                            (what, k)
                        if k == "log_pr_data":
                            assert torch.equal(_bits(g[k]), _bits(k6c[k])), \
                                what
                    if k != "log_pr_data":
                        assert torch.equal(
                            _bits(torch.cat([g[k] for g in got], -1)),
                            _bits(k6c[k])), (what, k)
    k6d = hmm.fwbw_grouped_backward(gtf, model, ev13)
    plain = statepar._fwbw_grouped_row(sub, False, None)
    for cluster in paths:
        n0 = em.fwbw_backward_wave_kernel.launches
        got = statepar._fwbw_grouped_row(sub, True, cluster)
        torch.cuda.synchronize()
        assert em.fwbw_backward_wave_kernel.launches - n0 == 1
        for g, p in zip(got, plain):
            assert torch.equal(_bits(g["beta"]), _bits(p["beta"])), \
                (M, cluster)
        assert torch.equal(_bits(torch.cat([g["beta"] for g in got], -1)),
                           _bits(k6d)), (M, cluster)
        assert torch.isnan(k6d).any()
