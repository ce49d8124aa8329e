"""The resident K6a's packed slot-table layout (nanocall_tpu_torch.ops.hmm
pack_from_slots) and the choice between K6a's two kernels, on the CPU.

A from-side table (deg, 4096) packs into 16-bit entries (the from-state in
the low 12 bits, a code into the slot's 16-entry float32 codebook in the
high 4) when every slot holds at most 16 distinct float32 bit patterns and
deg is at most hmm.MAX_RESIDENT_SLOTS (24: the packed table, the codebooks
and two alpha buffers in one block's 232,448 B of shared memory).  The
layout must give back from_idx and from_logp bit for bit (tolerance 0, -inf
padding and NaN by their bit patterns), and which kernel runs on the card
is a function of the table alone.  The kernels themselves are held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
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

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096


@pytest.fixture(scope="module")
def loaded21(tmp_path_factory):
    """The 21-neighbour table of (0.14, 0.21) written as a transitions TSV
    and loaded back by the JAX package's transitions.load_tsv."""
    path = str(tmp_path_factory.mktemp("packed") / "trans.tsv")
    jtransitions.save_tsv(jtransitions.build_structured(
        jtransitions.TransitionParams(0.14, 0.21), 6), path)
    return jtransitions.load_tsv(path, 6)


def _unpack(packed, book):
    """(from_idx int64, from_logp bits int32) of a packed layout."""
    e = packed.view(np.uint16).astype(np.int64)
    codes = e >> 12
    bits = np.take_along_axis(book.view(np.int32), codes, axis=1)
    return e & 0xFFF, bits


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
    packed, book = hmm.pack_from_slots(idx, lp)
    assert packed.dtype == np.int16 and packed.shape == (21, N)
    assert book.dtype == np.float32 and book.shape == (21, hmm.RESIDENT_CODES)
    got_idx, got_bits = _unpack(packed, book)
    assert np.array_equal(got_idx, idx)
    assert np.array_equal(got_bits, bits)
    assert got_bits[3, 100] == 0x7FC01234
    # tensors pack as their numpy arrays do
    packed_t, book_t = hmm.pack_from_slots(torch.from_numpy(idx),
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
    layout = hmm.pack_from_slots(idx, lp)
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
    assert hmm.pack_from_slots(transitions.slot_from_state(3),
                               st3.from_logp) is None
    idx, lp = random_table(np.random.default_rng(8), 4, 3)
    idx[2, 7] = N
    assert hmm.pack_from_slots(idx, lp) is None


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
        layout = hmm.pack_from_slots(idx, lp)
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
