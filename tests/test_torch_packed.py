"""The resident kernels' packed slot-table layout (nanocall_tpu_torch.ops.hmm
pack_slots) and the choice between the streaming and the resident kernels
of K6a and K6c, on the CPU.

A (deg, 4096) slot table packs into 16-bit entries (the state in the low 12
bits, a code into a 16-entry float32 codebook in the high 4) with G
codebooks per slot, one per block of 4096 / G states, when every (slot,
block) holds at most 16 distinct float32 bit patterns and deg fits one
block's 232,448 B of shared memory beside two buffers of the gathered
vector.  K6a takes the from side at G = 1 (hmm.MAX_RESIDENT_SLOTS = 24
slots), K6c both sides at G = hmm.FWBW_GROUPS = 4
(hmm.MAX_FWBW_RESIDENT_SLOTS = 23).  The layout must give back the indices
and log-probs bit for bit (tolerance 0, -inf padding and NaN by their bit
patterns), and which kernel runs on the card is a function of the table
alone.  The kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from nanocall_tpu import transitions as jtransitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, transitions
from nanocall_tpu_torch.ops import hmm, kernels
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401
from torch_helpers import random_block_table

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096


def _loaded(tmp_path_factory, p_stay: float, p_skip: float):
    """The 21-neighbour table of (p_stay, p_skip) written as a transitions
    TSV and loaded back by the JAX package's transitions.load_tsv (`-s`)."""
    path = str(tmp_path_factory.mktemp("packed") / "trans.tsv")
    jtransitions.save_tsv(jtransitions.build_structured(
        jtransitions.TransitionParams(p_stay, p_skip), 6), path)
    return jtransitions.load_tsv(path, 6)


@pytest.fixture(scope="module")
def loaded21(tmp_path_factory):
    """The loaded table of (0.14, 0.21): up to 15 log-probs in a slot."""
    return _loaded(tmp_path_factory, 0.14, 0.21)


@pytest.fixture(scope="module")
def loaded_priors(tmp_path_factory):
    """The loaded table of the CLI priors (0.1, 0.3): 17 log-probs in some
    slots, so no K6a layout at G = 1."""
    return _loaded(tmp_path_factory, 0.1, 0.3)


def _unpack(packed, book, groups: int = 1):
    """(indices int64, log-prob bits int32) of a packed layout of `groups`
    codebooks per slot."""
    e = packed.view(np.uint16).astype(np.int64)
    block = np.arange(N) // (N // groups)
    codes = block[None, :] * hmm.RESIDENT_CODES + (e >> 12)
    bits = np.take_along_axis(book.view(np.int32), codes, axis=1)
    return e & 0xFFF, bits


def _old_pack_from_slots(from_idx, from_logp):
    """K6a's layout as its packing function wrote it before it took G
    codebooks per slot: one codebook of a slot's distinct bit patterns in
    ascending int32 order, unused entries 0."""
    idx = np.asarray(from_idx).astype(np.int64)
    bits = np.ascontiguousarray(from_logp, np.float32).view(np.int32)
    deg, n = idx.shape
    if n != 4096 or not 1 <= deg <= hmm.MAX_RESIDENT_SLOTS \
            or idx.min() < 0 or idx.max() >= n:
        return None
    packed = np.empty((deg, n), np.uint16)
    book = np.zeros((deg, hmm.RESIDENT_CODES), np.int32)
    for k in range(deg):
        vals, codes = np.unique(bits[k], return_inverse=True)
        if len(vals) > hmm.RESIDENT_CODES:
            return None
        book[k, :len(vals)] = vals
        packed[k] = (codes.reshape(n) << 12) | idx[k]
    return packed.view(np.int16), book.view(np.float32)


def random_table(rng, deg: int, values: int):
    """A (deg, 4096) from-side table: random from-states and, per slot,
    `values` distinct log-probs (one of them -inf padding) on random
    states."""
    idx = rng.integers(0, N, (deg, N)).astype(np.int32)
    pool = np.log(rng.uniform(0.01, 1.0, (deg, values))).astype(np.float32)
    pool[:, 0] = -np.inf
    pick = np.concatenate([np.tile(np.arange(values), (deg, 1)),
                           rng.integers(0, values, (deg, N - values))], 1)
    lp = np.take_along_axis(pool, rng.permuted(pick, axis=1), axis=1)
    return idx, lp


def test_packed_layout_round_trips_the_loaded_table(loaded21):
    """The loaded 21-neighbour table, as numpy, packs (int16 entries, float32
    codebooks of 16) and unpacks to its from_idx and the bit patterns of
    its from_logp: -inf padding and an injected NaN included."""
    idx = np.asarray(loaded21.from_idx).copy()
    lp = np.asarray(loaded21.from_logp, np.float32).copy()
    assert idx.shape == (21, N)
    nan = np.array([0x7FC01234], np.int32).view(np.float32)[0]
    lp[3, 100] = nan
    bits = lp.view(np.int32)
    assert (bits == np.float32(-np.inf).view(np.int32)).sum() > 0
    packed, book = hmm.pack_slots(idx, lp)
    assert packed.dtype == np.int16 and packed.shape == (21, N)
    assert book.dtype == np.float32 and book.shape == (21, hmm.RESIDENT_CODES)
    got_idx, got_bits = _unpack(packed, book)
    assert np.array_equal(got_idx, idx)
    assert np.array_equal(got_bits, bits)
    assert got_bits[3, 100] == 0x7FC01234
    # tensors pack as their numpy arrays do
    packed_t, book_t = hmm.pack_slots(torch.from_numpy(idx),
                                           torch.from_numpy(lp))
    assert np.array_equal(packed_t, packed) and np.array_equal(
        book_t.view(np.int32), book.view(np.int32))


@pytest.mark.parametrize("case", ["17 values", "one slot too many",
                                  "16 values", "the most slots"])
def test_pack_refuses_what_does_not_fit(case):
    """None for a slot of 17 distinct bit patterns and for a table one slot
    wider than MAX_RESIDENT_SLOTS; a layout at 16 values and at the limit,
    which is the most slots whose layout and two alpha buffers fit 232,448
    B with the kernel's 8-byte barrier."""
    rng = np.random.default_rng(7)
    deg = {"one slot too many": hmm.MAX_RESIDENT_SLOTS + 1,
           "the most slots": hmm.MAX_RESIDENT_SLOTS}.get(case, 21)
    idx, lp = random_table(rng, deg, 17 if case == "17 values" else 16)
    layout = hmm.pack_slots(idx, lp)
    if case in ("17 values", "one slot too many"):
        assert layout is None
    else:
        got_idx, got_bits = _unpack(*layout)
        assert np.array_equal(got_idx, idx)
        assert np.array_equal(got_bits, lp.view(np.int32))
    assert hmm.MAX_RESIDENT_SLOTS == 24
    fits = [hmm.resident_smem_bytes(d) + 8 <= hmm.SMEM_PER_BLOCK
            for d in (24, 25)]
    assert fits == [True, False]


def test_pack_refuses_other_widths_and_states():
    """Only 4096-wide tables of from-states in [0, 4096) pack: a K = 3
    table (n = 64) and a from-state of 4096 give None."""
    st3 = transitions.build_structured(transitions.TransitionParams(0.14,
                                                                    0.21), 3)
    assert hmm.pack_slots(transitions.slot_from_state(3),
                               st3.from_logp) is None
    idx, lp = random_table(np.random.default_rng(8), 4, 3)
    idx[2, 7] = N
    assert hmm.pack_slots(idx, lp) is None


def _sparse(idx, lp):
    return transitions.SparseTransitions(from_idx=idx, from_logp=lp,
                                         to_idx=idx, to_logp=lp, K=6)


def test_route_is_a_function_of_the_table(loaded21):
    """convert.trans_ops gives every table that fits the packed layout, and
    the card's kernel follows from it: resident for the loaded table and a
    24-slot table of 16 values a slot, streaming for 17 values in a slot,
    25 slots, or a TransOps without the layout."""
    rng = np.random.default_rng(9)
    tables = {
        "loaded": (np.asarray(loaded21.from_idx),
                   np.asarray(loaded21.from_logp)),
        "24 slots": random_table(rng, 24, 16),
        "17 values": random_table(rng, 21, 17),
        "25 slots": random_table(rng, 25, 16),
    }
    want = {"loaded": "resident", "24 slots": "resident",
            "17 values": "streaming", "25 slots": "streaming"}
    for name, (idx, lp) in tables.items():
        ops = convert.trans_ops(_sparse(idx, lp), CPU)
        assert hmm.generic_forward_route(ops) == want[name], name
        layout = hmm.pack_slots(idx, lp)
        if layout is None:
            assert ops.from_packed is None and ops.from_codebook is None
            continue
        assert ops.from_packed.dtype == torch.int16
        assert np.array_equal(ops.from_packed.numpy(), layout[0])
        assert np.array_equal(ops.from_codebook.numpy().view(np.int32),
                              layout[1].view(np.int32))
        bare = ops._replace(from_packed=None, from_codebook=None)
        assert hmm.generic_forward_route(bare) == "streaming"


def test_resident_wrappers_refuse_cpu_and_bad_layouts(loaded21):
    """The resident kernel's wrappers take CUDA tensors and a K = 6 table's
    packed layout only; nothing launches."""
    (_, _, _), (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(3), 2, 6,
                                         [6, 3])
    ops = convert.trans_ops(loaded21, CPU)
    for call in (hmm.resident_forward_path_kernel,
                 hmm.resident_forward_score_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(ops, m_t, ev_t)
        with pytest.raises(ValueError, match="packed layout"):
            call(ops._replace(from_packed=None), m_t, ev_t)
        with pytest.raises(ValueError, match="K=6"):
            call(ops._replace(K=3), m_t, ev_t)
        with pytest.raises(ValueError, match="int16"):
            call(ops._replace(from_packed=ops.from_packed.int()), m_t, ev_t)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name


def test_random_resident_table_decodes_as_jax():
    """A 24-slot table of 16 values a slot is a table like any other: the
    port's Viterbi forward (its plain version, on the CPU) under it agrees
    with the JAX package's viterbi_forward (backpointers equal, final alpha
    within rtol 1e-5, test_torch_trans.py's tolerance)."""
    idx, lp = random_table(np.random.default_rng(10), 24, 16)
    ops_t = convert.trans_ops(_sparse(idx, lp), CPU)
    assert hmm.generic_forward_route(ops_t) == "resident"
    ops_j = jhmm.make_trans_ops(jtransitions.SparseTransitions(
        from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(11), 3, 8, [8, 1, 5])
    fa_j, bps_j = jhmm.viterbi_forward(ops_j, m_j, ev_j)
    fa_t, bps_t = hmm.viterbi_forward(ops_t, m_t, ev_t)
    assert np.array_equal(bps_t.numpy(), np.asarray(bps_j))
    np.testing.assert_allclose(fa_t.numpy(), np.asarray(fa_j), rtol=1e-5)


def test_kernel_source_states_the_layout():
    """The CUDA source's codebook width and shared-memory layout are the
    ones hmm.py packs for and budgets."""
    with open(os.path.join(ROOT, "nanocall_tpu_torch", "csrc",
                           "viterbi_generic.cu")) as fh:
        src = fh.read()
    assert f"constexpr int CODES = {hmm.RESIDENT_CODES};" in src
    assert "const int smem = 2 * N * 4 + deg * (CODES * 4 + N * 2);" in src
    assert hmm.resident_smem_bytes(21) == 2 * N * 4 + 21 * (16 * 4 + N * 2)


# K6c's layout: FWBW_GROUPS codebooks per slot, both sides --------------------


@pytest.mark.parametrize("table", ["loaded_priors", "loaded21"])
def test_fwbw_layout_rebuilds_both_sides(table, request):
    """Both sides of the loaded tables of the CLI priors (0.1, 0.3) and of
    (0.14, 0.21) pack at G = FWBW_GROUPS = 4 and unpack to from_idx /
    from_logp and to_idx / to_logp bit for bit; convert.trans_ops gives
    the same layout on the table's TransOps and routes K6c to the resident
    kernel.  G = 4 is the fewest codebooks per slot for which both pack:
    at G = 2 a side of the priors' table holds 17 log-probs in a block."""
    st = request.getfixturevalue(table)
    sides = {s: (np.asarray(getattr(st, f"{s}_idx")),
                 np.asarray(getattr(st, f"{s}_logp"), np.float32))
             for s in ("from", "to")}
    assert hmm.FWBW_GROUPS == 4
    layout = hmm.pack_fwbw_sides(*sides["from"], *sides["to"])
    assert layout is not None
    for side, (packed, book) in zip(sides, (layout[:2], layout[2:])):
        assert packed.dtype == np.int16 and packed.shape == (21, N)
        assert book.dtype == np.float32 and book.shape == (21, 4 * 16)
        got_idx, got_bits = _unpack(packed, book, hmm.FWBW_GROUPS)
        assert np.array_equal(got_idx, sides[side][0]), side
        assert np.array_equal(got_bits, sides[side][1].view(np.int32)), side
    ops = convert.trans_ops(st, CPU)
    assert hmm.fwbw_route(ops) == "resident"
    for got, want in zip(ops.fwbw_packed, layout):
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))
    fewer = [hmm.pack_slots(*sides[s], 2, hmm.MAX_FWBW_RESIDENT_SLOTS)
             for s in sides]
    assert (None in fewer) == (table == "loaded_priors")
    # the priors' table has no K6a layout (17 log-probs in a slot)
    assert hmm.generic_forward_route(ops) == (
        "streaming" if table == "loaded_priors" else "resident")


@pytest.mark.parametrize("case", ["loaded", "random 24 x 16",
                                  "random 17 values", "random 25 slots",
                                  "K = 3"])
def test_one_codebook_layout_keeps_its_bytes(case, loaded21):
    """pack_slots at G = 1 (K6a's layout) gives the bytes of the packing
    function it generalises, and None where that gave None."""
    rng = np.random.default_rng(12)
    if case == "loaded":
        idx, lp = (np.asarray(loaded21.from_idx),
                   np.asarray(loaded21.from_logp))
    elif case == "K = 3":
        idx = transitions.slot_from_state(3)
        lp = transitions.build_structured(transitions.TransitionParams(
            0.14, 0.21), 3).from_logp
    else:
        deg, values = {"random 24 x 16": (24, 16), "random 17 values":
                       (21, 17), "random 25 slots": (25, 16)}[case]
        idx, lp = random_table(rng, deg, values)
    want = _old_pack_from_slots(idx, lp)
    got = hmm.pack_slots(idx, lp)
    assert (got is None) == (want is None) == (case in (
        "random 17 values", "random 25 slots", "K = 3"))
    if want is not None:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


@pytest.mark.parametrize("case", ["16 codes a block", "the most slots",
                                  "17 codes in a block", "one slot too many",
                                  "to side only too wide", "a state of 4096"])
def test_fwbw_layout_refuses_what_does_not_fit(case):
    """K6c's layout holds both sides or neither: None (and K6c's streaming
    kernel) for 17 log-probs in one (slot, block), for a side one slot
    wider than MAX_FWBW_RESIDENT_SLOTS (23: the layout, its codebooks and
    two buffers of the gathered vector fit 232,448 B beside the kernel's
    static 264 B), and for a state outside [0, 4096); a layout of 64
    log-probs a slot (16 a block, which G = 1 refuses) and of 23 slots."""
    rng = np.random.default_rng(13)
    deg = {"the most slots": hmm.MAX_FWBW_RESIDENT_SLOTS,
           "one slot too many": hmm.MAX_FWBW_RESIDENT_SLOTS + 1}.get(case, 21)
    values = 17 if case == "17 codes in a block" else 16
    idx, lp = random_block_table(rng, deg, values, hmm.FWBW_GROUPS)
    to_idx, to_lp = idx, lp
    if case == "to side only too wide":
        to_idx, to_lp = random_block_table(
            rng, hmm.MAX_FWBW_RESIDENT_SLOTS + 1, 16, hmm.FWBW_GROUPS)
    if case == "a state of 4096":
        idx = idx.copy()
        idx[3, 9] = N
    table = transitions.SparseTransitions(from_idx=idx, from_logp=lp,
                                          to_idx=to_idx, to_logp=to_lp, K=6)
    fits = case in ("16 codes a block", "the most slots")
    layout = hmm.pack_fwbw_sides(idx, lp, to_idx, to_lp)
    assert (layout is not None) == fits
    if case == "a state of 4096":
        return  # convert.trans_ops would refuse the table's other checks
    ops = convert.trans_ops(table, CPU)
    assert hmm.fwbw_route(ops) == ("resident" if fits else "streaming")
    assert (ops.fwbw_packed is None) == (not fits)
    if fits:
        got_idx, got_bits = _unpack(*layout[:2], hmm.FWBW_GROUPS)
        assert np.array_equal(got_idx, idx)
        assert np.array_equal(got_bits, lp.view(np.int32))
        assert hmm.pack_slots(idx, lp) is None  # 64 log-probs a slot
        assert hmm.fwbw_route(ops._replace(fwbw_packed=None)) == "streaming"
    sizes = [hmm.fwbw_resident_smem_bytes(d) + 264 <= hmm.SMEM_PER_BLOCK
             for d in (23, 24)]
    assert sizes == [True, False]


def test_fwbw_resident_wrapper_refuses_cpu_and_bad_layouts(loaded_priors):
    """The resident K6c's wrapper takes CUDA tensors and a K = 6 table's
    layout of both sides only (int16 entries, FWBW_GROUPS x 16 float32
    codebooks a slot); nothing launches."""
    (_, _, _), (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(3), 2, 6,
                                         [6, 3])
    ops = convert.trans_ops(loaded_priors, CPU)
    p = ops.fwbw_packed
    call = hmm.fwbw_resident_kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(ops, m_t, ev_t)
    with pytest.raises(ValueError, match="packed layout"):
        call(ops._replace(fwbw_packed=None), m_t, ev_t)
    with pytest.raises(ValueError, match="K=6"):
        call(ops._replace(K=3), m_t, ev_t)
    with pytest.raises(ValueError, match="int16"):
        call(ops._replace(fwbw_packed=p._replace(
            to_packed=p.to_packed.int())), m_t, ev_t)
    with pytest.raises(ValueError, match=r"\(21, 64\)"):
        call(ops._replace(fwbw_packed=p._replace(
            from_codebook=p.from_codebook[:, :16].contiguous())), m_t, ev_t)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name


def _csrc(*names) -> str:
    """The CUDA sources `names` of nanocall_tpu_torch/csrc, concatenated."""
    out = []
    for name in names:
        with open(os.path.join(ROOT, "nanocall_tpu_torch", "csrc",
                               name)) as fh:
            out.append(fh.read())
    return "\n".join(out)


def test_fwbw_kernel_source_states_the_layout():
    """fwbw_generic.cu's resident layout constants (in the header it shares
    with K6e's resident kernel, resident_slots.cuh) and shared-memory size
    are the ones hmm.py packs for and budgets."""
    src = _csrc("fwbw_generic.cu", "resident_slots.cuh")
    assert f"constexpr int GROUPS = {hmm.FWBW_GROUPS};" in src
    assert f"constexpr int CODES = {hmm.RESIDENT_CODES};" in src
    assert f"constexpr int MAX_DEG = {hmm.MAX_FWBW_RESIDENT_SLOTS};" in src
    assert ("const int smem = 2 * nc::N * 4 + deg * (GROUPS * CODES * 4 + "
            "nc::N * 2);") in src
    assert hmm.fwbw_resident_smem_bytes(21) == 2 * N * 4 + 21 * (
        4 * 16 * 4 + N * 2)


# K6e's resident kernel (K6c's layout) and K6b's ring (the from-state table)


def test_custom_resident_kernel_source_states_the_layout():
    """fwbw_custom.cu's resident kernel takes K6c's layout from the shared
    header and sets the same shared memory, one instance for 21 slots a
    side and one for any count (<0>)."""
    src = _csrc("fwbw_custom.cu")
    assert '#include "resident_slots.cuh"' in src
    assert ("const int smem = 2 * nc::N * 4 + deg * (GROUPS * CODES * 4 + "
            "nc::N * 2);") in src
    assert "fwbw_custom_resident_kernel<21>" in src
    assert "fwbw_custom_resident_kernel<0>" in src
    # no second copy of the slot arithmetic
    for name in ("fwbw_custom.cu", "fwbw_generic.cu"):
        assert "float lse_resident(" not in _csrc(name), name
    assert "float lse_resident(" in _csrc("resident_slots.cuh")


def test_custom_resident_backward_writes_each_gamma_row_once():
    """The resident K6e's backward writes gamma rows T-1 .. t_top + 1 with
    the frozen beta, then t_top .. 0 by steps: every row 0 .. T-1 once and
    no other, for every length 0 .. T + 1 (a length-0 read must not write
    row -1, the read before's last row).  t_top as fwbw_custom.cu computes
    it, evaluated here."""
    src = _csrc("fwbw_custom.cu")
    expr = re.search(r"const int t_top = (.*);", src).group(1)
    for T in range(1, 7):
        for length in range(T + 2):
            t_top = eval(expr, {"min": min, "max": max, "T": T,
                                "len": length})
            rows = list(range(T - 1, t_top, -1)) + list(range(t_top, -1, -1))
            assert sorted(rows) == list(range(T)), (T, length, rows)


def _route_of(call, *args):
    """Which wrapper `call` (hmm.fwbw_custom or hmm.viterbi_traceback)
    takes for tensors on a CUDA device, with every kernel wrapper of K6b and
    K6e replaced by a recorder: the dispatch alone, no card needed."""
    names = ("fwbw_custom_kernel", "fwbw_custom_resident_kernel",
             "generic_traceback_kernel", "generic_traceback_ring_kernel")
    taken = []
    saved = {n: getattr(hmm, n) for n in names}
    try:
        for n in names:
            setattr(hmm, n, lambda *a, n=n: taken.append(n))
        call(*args)
    finally:
        for n, f in saved.items():
            setattr(hmm, n, f)
    return taken


class _OnCard:
    """A stand-in for a tensor on the card: the dispatch reads .device."""

    device = torch.device("cuda", 0)


def test_custom_fwbw_route_follows_fwbw_route(loaded_priors, loaded21):
    """hmm.fwbw_custom takes the resident K6e exactly where hmm.fwbw takes
    the resident K6c (hmm.fwbw_route): under the loaded tables of the CLI
    priors and of (0.14, 0.21), and the streaming K6e without the layout
    or under a table that does not pack."""
    rng = np.random.default_rng(21)
    tables = {"priors": convert.trans_ops(loaded_priors, CPU),
              "(0.14, 0.21)": convert.trans_ops(loaded21, CPU),
              "17 values a block": convert.trans_ops(
                  _sparse(*random_block_table(rng, 21, 17,
                                              hmm.FWBW_GROUPS)), CPU)}
    tables["no layout"] = tables["priors"]._replace(fwbw_packed=None)
    ev = {"mean": _OnCard()}
    for what, ops in tables.items():
        want = {"resident": "fwbw_custom_resident_kernel",
                "streaming": "fwbw_custom_kernel"}[hmm.fwbw_route(ops)]
        assert _route_of(hmm.fwbw_custom, ops, None, ev) == [want], what
        assert (hmm.fwbw_route(ops) == "resident") == (
            what in ("priors", "(0.14, 0.21)")), what


def _structured_ops():
    return convert.trans_ops(transitions.build_structured(
        transitions.TransitionParams(0.14, 0.21), 6), CPU)


def test_from_state_table_equals_from_idx(loaded21, loaded_priors):
    """convert.trans_ops gives K6b's uint16 from-state table, equal to
    from_idx, to the structured 21-slot table, the loaded tables of
    (0.14, 0.21) and of the CLI priors (whose slots hold 17 log-probs, so
    K6a's layout misses it) and a random table of 24 slots of random
    log-probs: it holds no log-prob, so every table that small has it."""
    rng = np.random.default_rng(22)
    idx = rng.integers(0, N, (24, N)).astype(np.int32)
    lp = np.log(rng.uniform(0.01, 1.0, (24, N))).astype(np.float32)
    tables = {"structured": _structured_ops(),
              "(0.14, 0.21)": convert.trans_ops(loaded21, CPU),
              "priors": convert.trans_ops(loaded_priors, CPU),
              "random 24 slots": convert.trans_ops(_sparse(idx, lp), CPU)}
    assert tables["priors"].from_packed is None
    for what, ops in tables.items():
        st = ops.from_states
        assert st is not None, what
        assert st.dtype == torch.uint16 and st.is_contiguous(), what
        assert tuple(st.shape) == tuple(ops.from_idx.shape), what
        assert torch.equal(st.to(torch.int32), ops.from_idx), what
        assert hmm.generic_traceback_route(ops) == "ring", what
        assert np.array_equal(hmm.from_state_table(ops.from_idx.numpy()),
                              ops.from_idx.numpy()), what


@pytest.mark.parametrize("deg", [24, 25])
def test_traceback_route_is_a_function_of_the_table(deg):
    """K6b takes its ring kernel at 24 slots, the most whose from-state
    table fits one block beside MIN_RING_STAGES ring stages, and its
    streaming kernel at 25 (convert.trans_ops gives no from-state table
    there) or on a TransOps without one."""
    idx, lp = random_table(np.random.default_rng(deg), deg, 16)
    ops = convert.trans_ops(_sparse(idx, lp), CPU)
    assert hmm.MAX_TRACEBACK_RING_SLOTS == 24
    want = "ring" if deg <= 24 else "streaming"
    assert hmm.generic_traceback_route(ops) == want
    assert (ops.from_states is None) == (want == "streaming")
    assert (hmm.from_state_table(idx) is None) == (want == "streaming")
    bare = ops._replace(from_states=None)
    assert hmm.generic_traceback_route(bare) == "streaming"
    fa = _OnCard()
    assert _route_of(hmm.viterbi_traceback, ops, fa, None, None) == [
        "generic_traceback_ring_kernel" if want == "ring"
        else "generic_traceback_kernel"]
    assert _route_of(hmm.viterbi_traceback, bare, fa, None, None) == [
        "generic_traceback_kernel"]


def test_from_state_table_refuses_other_widths_and_states():
    """Only 4096-wide tables of from-states in [0, 4096) have one."""
    st3 = transitions.build_structured(transitions.TransitionParams(0.14,
                                                                    0.21), 3)
    assert hmm.from_state_table(transitions.slot_from_state(3)) is None
    assert convert.trans_ops(st3, CPU).from_states is None
    idx, _ = random_table(np.random.default_rng(23), 4, 3)
    idx[1, 9] = N
    assert hmm.from_state_table(idx) is None
    idx[1, 9] = -1
    assert hmm.from_state_table(idx) is None


def test_ring_kernel_source_states_its_shared_memory():
    """viterbi_traceback.cu's ring constants and K6b's shared-memory size
    are the ones hmm.py budgets: a stage of 4 rows of 4096 bytes, 2 to 12
    stages, the table's deg x 4096 uint16 beside them in 232,448 B less
    512 for the static arrays; 3 stages at 21 slots, 2 at 24, none left at
    25."""
    src = _csrc("viterbi_traceback.cu")
    for line in (f"constexpr int RING_ROWS = {hmm.RING_ROWS};",
                 f"constexpr int MIN_STAGES = {hmm.MIN_RING_STAGES};",
                 f"constexpr int SMEM_PER_BLOCK = {hmm.SMEM_PER_BLOCK};",
                 "constexpr int TABLE_RING_STATIC = "
                 f"{hmm._TABLE_RING_STATIC_SMEM};",
                 "const int smem = stages * (int)STAGE_BYTES + deg * N * 2;"):
        assert line in src, line
    assert hmm.traceback_ring_smem_bytes(21, 3) == 3 * 4 * N + 21 * 2 * N
    # ring_stages: the stages that fit beside the table, at most 12
    room = hmm.SMEM_PER_BLOCK - hmm._TABLE_RING_STATIC_SMEM
    for deg, stages in ((21, 3), (24, 2), (25, 1)):
        assert (room - deg * 2 * N) // (hmm.RING_ROWS * N) == stages, deg
        assert hmm.traceback_ring_smem_bytes(deg, stages) <= room
        assert hmm.traceback_ring_smem_bytes(deg, stages + 1) > room


def test_end_argmax_has_one_implementation():
    """K2's, K2m's, K6b's ring, K6bm's and K6b's streaming kernels take
    their end argmax from common.cuh (end_argmax_partials, or
    end_argmax_partials_at for K2m's and K6bm's states in the ranks'
    slices, a barrier, end_argmax), and no kernel source holds a second
    copy of its rule or its shuffles."""
    common = _csrc("common.cuh")
    for name in ("void take_better(", "void warp_argmax(",
                 "void end_argmax_partials(", "void end_argmax_partials_at(",
                 "void end_argmax("):
        assert name in common, name
    for name, kernels in (("viterbi_traceback.cu", 4),
                          ("viterbi_generic.cu", 1)):
        src = _csrc(name)
        assert "void take_better(" not in src, name
        assert "__shfl_down_sync" not in src, name
        assert (src.count("end_argmax_partials(")
                + src.count("end_argmax_partials_at(")) == kernels, name
        assert src.count("end_argmax(w_best, w_idx, ") == kernels, name


def test_new_wrappers_refuse_cpu_and_bad_layouts(loaded_priors):
    """K6b's ring wrapper and K6e's resident wrapper take CUDA tensors and
    the table's layouts only (uint16 from-states; both packed sides);
    nothing launches."""
    (_, _, _), (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(3), 2, 6,
                                         [6, 3])
    ops = convert.trans_ops(loaded_priors, CPU)
    call = hmm.fwbw_custom_resident_kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(ops, m_t, ev_t)
    with pytest.raises(ValueError, match="packed layout"):
        call(ops._replace(fwbw_packed=None), m_t, ev_t)
    with pytest.raises(ValueError, match="K=6"):
        call(ops._replace(K=3), m_t, ev_t)
    fa = torch.zeros((2, N), dtype=torch.float32)
    bps = torch.zeros((5, 2, N), dtype=torch.uint8)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    ring = hmm.generic_traceback_ring_kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring(ops, fa, bps, lengths)
    with pytest.raises(ValueError, match="from-state table"):
        ring(ops._replace(from_states=None), fa, bps, lengths)
    with pytest.raises(ValueError, match="uint16"):
        ring(ops._replace(from_states=ops.from_states.to(torch.int32)), fa,
             bps, lengths)
    with pytest.raises(ValueError, match="K=6"):
        ring(ops._replace(K=3), fa, bps, lengths)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name
