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


def test_fwbw_kernel_source_states_the_layout():
    """fwbw_generic.cu's resident layout constants and shared-memory size
    are the ones hmm.py packs for and budgets."""
    with open(os.path.join(ROOT, "nanocall_tpu_torch", "csrc",
                           "fwbw_generic.cu")) as fh:
        src = fh.read()
    assert f"constexpr int GROUPS = {hmm.FWBW_GROUPS};" in src
    assert f"constexpr int CODES = {hmm.RESIDENT_CODES};" in src
    assert f"constexpr int MAX_DEG = {hmm.MAX_FWBW_RESIDENT_SLOTS};" in src
    assert ("const int smem = 2 * nc::N * 4 + deg * (GROUPS * CODES * 4 + "
            "nc::N * 2);") in src
    assert hmm.fwbw_resident_smem_bytes(21) == 2 * N * 4 + 21 * (
        4 * 16 * 4 + N * 2)
