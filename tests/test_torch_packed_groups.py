"""K6a's resident layout at G codebooks a slot (nanocall_tpu_torch.ops.hmm
resident_layout), on the CPU: which tables take G = 1 and which G = 4, the
layout's bytes, the mesh's cut of it, and a numpy emulation of the resident
slot loop (csrc/viterbi_generic.cu max_slots) on it.

A user writes a table with `compute-state-transitions --fast -t p_stay -k
p_skip` (convert.write_fast_transitions) and decodes with `-s`.  Over the
grid p_stay in {0.05, 0.1, 0.14, 0.2, 0.3} x p_skip in {0.1, 0.21, 0.3}
every loaded table has 21 slots and 12-17 distinct log-probs in a slot:
9 pack at one codebook a slot, all 15 at hmm.FWBW_GROUPS = 4 (one
codebook per block of 1024 states), the CLI priors' (0.1, 0.3) among the
6 that need 4.  The layout keeps the one-codebook bytes where they fit.

Tolerances: the layout gives back from_idx and the log-probs' bit
patterns exactly (-inf padding and NaN payloads included); the emulated
slot loop gives viterbi_forward_plain's bits (a NaN as a NaN: the card's
one NaN is not the CPU's) and backpointers; against the JAX package's
viterbi_forward and viterbi_decode, backpointers and paths equal and the
final alpha within rtol 1e-5 (tests/test_torch_trans.py's tolerance: XLA
reorders the jitted emission).
"""

import math

import numpy as np
import pytest
import torch

from nanocall_tpu import transitions as jtransitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, transitions
from nanocall_tpu_torch.ops import hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from test_torch_packed import _old_pack_from_slots, _unpack
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401
from torch_helpers import random_block_table

CPU = torch.device("cpu")
N = 4096
P_STAY = (0.05, 0.1, 0.14, 0.2, 0.3)
P_SKIP = (0.1, 0.21, 0.3)
#: the grid's tables that need 4 codebooks a slot (17 log-probs in a slot)
NEED_FOUR = {(0.05, 0.21), (0.05, 0.3), (0.1, 0.3), (0.2, 0.21),
             (0.2, 0.3), (0.3, 0.3)}
PRIORS = (0.1, 0.3)
NAN_BITS = 0x7FC01234


def _fast_path(tmp_path_factory, p_stay: float, p_skip: float) -> str:
    path = tmp_path_factory.mktemp("fast") / f"trans_{p_stay}_{p_skip}.tsv"
    convert.write_fast_transitions(str(path), p_stay, p_skip)
    return str(path)


def _fast_table(tmp_path_factory, p_stay: float, p_skip: float):
    """The `--fast` table of (p_stay, p_skip) as the port's `-s` loader
    reads it back."""
    return transitions.load_tsv(_fast_path(tmp_path_factory, p_stay, p_skip),
                                6)


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    return _fast_table(tmp_path_factory, *PRIORS)


def _slot_major(book, groups: int):
    """A block-major (G deg, 16) codebook as pack_slots' slot-major (deg, G
    16), which test_torch_packed._unpack reads."""
    deg = book.shape[0] // groups
    return np.ascontiguousarray(book.reshape(groups, deg, 16).transpose(
        1, 0, 2)).reshape(deg, groups * 16)


def _nan_in_block(lp, block: int, groups: int = 4):
    """A copy of `lp` with a NaN (payload NAN_BITS) at a state of `block`
    in a slot whose block holds at most 15 log-probs, so the table still
    packs at `groups`; (the copy, (slot, state))."""
    lp = np.array(lp, np.float32)
    w = N // groups
    for k in range(lp.shape[0]):
        blk = lp[k, block * w:(block + 1) * w]
        if len(np.unique(blk.view(np.int32))) <= 15:
            j = block * w + 77
            lp[k, j] = np.array([NAN_BITS], np.int32).view(np.float32)[0]
            return lp, (k, j)
    raise AssertionError("no slot with room for a NaN")


@pytest.mark.parametrize("p_stay", P_STAY)
@pytest.mark.parametrize("p_skip", P_SKIP)
def test_every_fast_table_has_a_k6a_layout(tmp_path_factory, p_stay,
                                           p_skip):
    """Each `--fast` table of the grid, written and loaded back, gets a K6a
    layout from convert.trans_ops (K6a's resident kernel): the 9 that
    packed at one codebook a slot keep G = 1 and the bytes of the packing
    function before G; the 6 with 17 log-probs in a slot take G = 4 and
    unpack to from_idx and the bit patterns of from_logp, -inf padding and
    a NaN injected into block 3's codebook included."""
    st = _fast_table(tmp_path_factory, p_stay, p_skip)
    idx = np.asarray(st.from_idx)
    lp = np.asarray(st.from_logp, np.float32)
    assert idx.shape == (21, N)
    ops = convert.trans_ops(st, CPU)
    assert hmm.generic_forward_route(ops) == "resident"
    old = _old_pack_from_slots(idx, lp)
    groups = hmm.resident_groups(ops)
    assert (old is None) == ((p_stay, p_skip) in NEED_FOUR)
    if old is not None:
        assert groups == 1
        assert np.array_equal(ops.from_packed.numpy(), old[0])
        assert np.array_equal(ops.from_codebook.numpy().view(np.int32),
                              old[1].view(np.int32))
        return
    assert groups == hmm.FWBW_GROUPS == 4
    assert tuple(ops.from_codebook.shape) == (4 * 21, hmm.RESIDENT_CODES)
    assert hmm.resident_layout(idx, lp, 1) is None
    bits = lp.view(np.int32)
    assert (bits == np.float32(-np.inf).view(np.int32)).any()
    got_idx, got_bits = _unpack(ops.from_packed.numpy(),
                                _slot_major(ops.from_codebook.numpy(), 4), 4)
    assert np.array_equal(got_idx, idx)
    assert np.array_equal(got_bits, bits)
    nan_lp, (k, j) = _nan_in_block(lp, 3)
    packed, book = hmm.resident_layout(idx, nan_lp)
    assert book.shape == (4 * 21, 16)
    got_idx, got_bits = _unpack(packed, _slot_major(book, 4), 4)
    assert np.array_equal(got_idx, idx)
    assert np.array_equal(got_bits, nan_lp.view(np.int32))
    assert got_bits[k, j] == NAN_BITS
    # the NaN lies in block 3's codebook of slot k, row 3 * 21 + k
    assert NAN_BITS in book[3 * 21 + k].view(np.int32)


def test_layout_arithmetic():
    """resident_smem_bytes and max_resident_slots: 24 slots at one codebook
    a slot, 23 at 4 (32768 + deg (4 * 4 * 16 + 8192) bytes within 232,448
    less the kernel's 8-byte barrier); a table of 24 slots of 16 values a
    slot keeps G = 1, 23 slots of 16 a block take G = 4, 24 of them none."""
    assert hmm.RESIDENT_GROUPS == (1, hmm.FWBW_GROUPS)
    assert (hmm.max_resident_slots(1), hmm.max_resident_slots(4)) == (24, 23)
    for groups, deg in ((1, 24), (4, 23)):
        assert hmm.resident_smem_bytes(deg, groups=groups) + 8 <= \
            hmm.SMEM_PER_BLOCK
        assert hmm.resident_smem_bytes(deg + 1, groups=groups) + 8 > \
            hmm.SMEM_PER_BLOCK
    assert hmm.resident_smem_bytes(23, groups=4) == 32768 + 23 * (
        4 * 4 * 16 + 8192)
    rng = np.random.default_rng(30)
    for deg, values, groups, want in ((24, 16, 1, 1), (23, 16, 4, 4),
                                      (24, 16, 4, None), (21, 17, 4, None)):
        idx, lp = random_block_table(rng, deg, values, groups)
        layout = hmm.resident_layout(idx, lp)
        assert (layout is None) == (want is None), (deg, values, groups)
        if layout is not None:
            assert layout[1].shape == (want * deg, 16)


def test_seventeen_values_in_one_block_stream():
    """A random table of 16 log-probs in every block of 1024 states but 17
    in one (slot 5, block 3) packs at neither count: convert.trans_ops
    gives it no K6a layout, so K6a takes its streaming kernel; a TransOps
    without the layout streams too."""
    rng = np.random.default_rng(31)
    idx, lp = random_block_table(rng, 21, 16, 4)
    j = 3 * 1024 + np.flatnonzero(lp[5, 3072:] == lp[5, 3072:].max())[0]
    lp[5, j] = np.float32(-1e-3)  # a 17th value in that block
    assert len(np.unique(lp[5, 3072:].view(np.int32))) == 17
    assert hmm.resident_layout(idx, lp) is None
    ops = convert.trans_ops(transitions.SparseTransitions(
        from_idx=idx, from_logp=lp, to_idx=idx, to_logp=lp, K=6), CPU)
    assert ops.from_packed is None and ops.from_codebook is None
    assert hmm.generic_forward_route(ops) == "streaming"
    good = convert.trans_ops(transitions.SparseTransitions(
        from_idx=idx, from_logp=random_block_table(rng, 21, 16, 4)[1],
        to_idx=idx, to_logp=lp, K=6), CPU)
    assert hmm.resident_groups(good) == 4
    assert hmm.generic_forward_route(
        good._replace(from_packed=None, from_codebook=None)) == "streaming"


# the resident slot loop, emulated ------------------------------------------


def _slot_loop(packed, book, alpha):
    """max_slots over every state of a (deg, W) packed cut whose block-major
    codebooks (G deg, 16) cover its W states in G blocks, each state's
    block taken from its index: (best (B, W) float32, slot (B, W) int64),
    as the kernels compute them.  alpha: the whole previous column (B,
    4096) float32."""
    deg, W = packed.shape
    groups = book.shape[0] // deg
    e = packed.view(np.uint16).astype(np.int64)
    frm, code = e & 0xFFF, e >> 12
    block = np.arange(W) * groups // W
    with np.errstate(invalid="ignore"):
        for k in range(deg):
            v = book[block * deg + k, code[k]][None, :] + alpha[:, frm[k]]
            if k == 0:
                best, bfrom = v, np.broadcast_to(frm[0], v.shape)
                slot, nan = np.zeros(v.shape, np.int64), np.isnan(v)
                continue
            take = (v > best) | ((v == best) & (frm[k] < bfrom))
            bfrom = np.where(take, frm[k], bfrom)
            slot = np.where(take, k, slot)
            best = np.where(v > best, v, best)
            nan |= np.isnan(v)
    best = np.where(nan, np.float32(np.nan), best).astype(np.float32)
    return best, np.where(np.isnan(best), 0, slot)


def _emulated_forward(cuts, model, ev):
    """K6a's resident forward (cuts: one (packed, codebook) for all 4096
    states) or K6am's (one a rank, in rank order) emulated in numpy on the
    same alpha0 and emissions as viterbi_forward_plain: (final alpha (B,
    4096), bps (T - 1, B, 4096) uint8)."""
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    B, T = mean.shape
    alpha = (hmm.log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0])
             - math.log(N)).numpy()
    lengths = ev["length"].numpy()
    bps = np.empty((T - 1, B, N), np.uint8)
    for t in range(1, T):
        parts = [_slot_loop(p, b, alpha) for p, b in cuts]
        best = np.concatenate([p[0] for p in parts], 1)
        bps[t - 1] = np.concatenate([p[1] for p in parts], 1)
        em = hmm.log_emission(model, mean[:, t], stdv[:, t],
                              log_stdv[:, t]).numpy()
        alpha = np.where((t < lengths)[:, None], best + em, alpha)
    return alpha, bps


def _same_bits(got, want):
    """Bit-equal float32 arrays, a NaN matching any NaN."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _rank_cuts(ops, model, ev, M: int) -> list:
    """The ranks' cuts of the table's resident layout as statepar cuts them
    for M ranks on the CPU: [(packed (deg, W), codebook) numpy]."""
    row = statepar.split_table_states(ops, model, ev, [CPU] * M)
    return [(p.ops.from_packed.numpy(), p.ops.from_codebook.numpy())
            for p in row.parts]


@pytest.mark.parametrize("inputs", ["clean", "NaN"])
def test_emulated_slot_loop_on_four_codebooks(priors, inputs):
    """The resident slot loop, emulated in numpy on the priors' table's G =
    4 layout (each state's codebook by its block), gives
    viterbi_forward_plain's final alpha bits and backpointers, on all 4096
    states at once (K6a) and on the ranks' cuts at 2, 4 and 8 ranks
    (K6am); its backpointers equal the JAX package's viterbi_forward's and
    its final alpha is within rtol 1e-5 of it.  NaN: a NaN event in read 1
    and a NaN log-prob in block 3's codebook."""
    idx = np.asarray(priors.from_idx)
    lp = np.asarray(priors.from_logp, np.float32)
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(32), 3, 8, [8, 5, 1])
    if inputs == "NaN":
        lp, _ = _nan_in_block(lp, 3)
        ev_t["mean"][1, 3] = float("nan")
        ev_j = dict(ev_j, mean=ev_t["mean"].numpy())
    table = transitions.SparseTransitions(from_idx=idx, from_logp=lp,
                                          to_idx=idx, to_logp=lp, K=6)
    ops = convert.trans_ops(table, CPU)
    assert hmm.resident_groups(ops) == 4
    fa_p, bps_p = hmm.viterbi_forward_plain(ops, m_t, ev_t)
    fa_p, bps_p = fa_p.numpy(), bps_p.numpy()
    for M in (1, 2, 4, 8):
        cuts = ([(ops.from_packed.numpy(), ops.from_codebook.numpy())]
                if M == 1 else _rank_cuts(ops, m_t, ev_t, M))
        fa_e, bps_e = _emulated_forward(cuts, m_t, ev_t)
        _same_bits(fa_e, fa_p)
        assert np.array_equal(bps_e, bps_p), M
    assert np.isnan(fa_p).any() == (inputs == "NaN")
    fa_j, bps_j = jhmm.viterbi_forward(jhmm.make_trans_ops(
        jtransitions.SparseTransitions(from_idx=idx, from_logp=lp,
                                       to_idx=idx, to_logp=lp, K=6)),
        m_j, ev_j)
    assert np.array_equal(bps_p, np.asarray(bps_j))
    np.testing.assert_allclose(fa_p, np.asarray(fa_j), rtol=1e-5)


# the mesh's cut ------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4, 8])
def test_mesh_cut_holds_only_the_ranks_codebooks(tmp_path_factory, priors,
                                                 M):
    """The mesh's cut of a G = 4 layout (statepar.split_table_states and
    mesh.shard_decode_inputs alike) gives rank m its (21, W) entries and
    only the codebooks of the blocks its W states lie in: rows [g0 21, g1
    21) of the (4 x 21, 16) codebooks, W / 1024 blocks at 2 ranks and one
    at 4 and 8; a G = 1 layout's one codebook a slot goes to every rank."""
    ops = convert.trans_ops(priors, CPU)
    _, (_, model, ev), _ = _rows(6, np.random.default_rng(33), 4, 4,
                                 [4, 4, 2, 0])
    W = N // M
    book = ops.from_codebook
    row = statepar.split_table_states(ops, model, ev, [CPU] * M)
    placed, _, _ = mesh.shard_decode_inputs(
        mesh.make_mesh(2 * M, model_axis=M, devices=[CPU] * (2 * M)), ops,
        model, ev)
    for m, part in enumerate(row.parts):
        g0, g1 = m * W // 1024, max(m * W // 1024 + 1, (m + 1) * W // 1024)
        assert g1 - g0 == max(1, W // 1024)
        want = book[g0 * 21:g1 * 21]
        assert hmm.resident_groups(part.ops) == g1 - g0
        assert part.ops.from_codebook.shape == ((g1 - g0) * 21, 16)
        assert torch.equal(part.ops.from_codebook, want), m
        assert torch.equal(part.ops.from_packed,
                           ops.from_packed[:, m * W:(m + 1) * W])
        for d in range(2):
            assert torch.equal(placed.cut.from_codebook.shards[d][m], want)
            assert torch.equal(placed.cut.from_packed.shards[d][m],
                               part.ops.from_packed)
        assert (g1 - g0) in hmm.cut_groups(W)
    loaded21 = convert.trans_ops(_fast_table(tmp_path_factory, 0.14, 0.21),
                                 CPU)
    assert hmm.resident_groups(loaded21) == 1
    for part in statepar.split_table_states(loaded21, model, ev,
                                            [CPU] * M).parts:
        assert torch.equal(part.ops.from_codebook, loaded21.from_codebook)


@pytest.mark.parametrize("D,M", [(1, 2), (1, 4), (2, 2), (4, 2), (1, 8)])
def test_placed_decode_under_the_priors_matches_jax(tmp_path_factory, D, M):
    """The placed decode (statepar.viterbi_decode_placed on
    mesh.shard_decode_inputs, the plain K6am + K6bm) under the priors'
    loaded table, whose K6a layout takes 4 codebooks a slot, on CPU
    meshes: paths byte-equal to the JAX package's viterbi_decode and to
    the unplaced decode, logp within rtol 1e-5 of JAX's and bit-equal to
    the unplaced one's."""
    path = _fast_path(tmp_path_factory, *PRIORS)
    ops = convert.trans_ops(transitions.load_tsv(path, 6), CPU)
    assert hmm.resident_groups(ops) == 4
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(34), 8, 10, [10, 0, 1, 9, 6, 10, 3, 10])
    want = jhmm.viterbi_decode(jhmm.make_trans_ops(
        jtransitions.load_tsv(path, 6)), m_j, ev_j)
    ref = hmm.viterbi_decode(ops, m_t, ev_t)
    got = mesh.join(statepar.viterbi_decode_placed(*mesh.shard_decode_inputs(
        mesh.make_mesh(D * M, model_axis=M, devices=[CPU] * (D * M)), ops,
        m_t, ev_t)))
    assert got["path"].numpy().tobytes() == np.asarray(
        want["path"]).astype(np.uint16).tobytes()
    assert torch.equal(got["path"], ref["path"])
    assert torch.equal(got["logp"].view(torch.int32),
                       ref["logp"].view(torch.int32))
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)


# per-read tables -----------------------------------------------------------


def _mixed_batch():
    """Per-read structured tables (B = 4) whose reads 1 and 3 carry a small
    offset a block of 1024 states (g 2^-10 in block g, -inf kept): each of
    their slots then holds more than 16 log-probs, at most 16 a block, so
    they need 4 codebooks a slot and reads 0 and 2 one."""
    params = np.array([[0.1, 0.3], [0.14, 0.21], [0.07, 0.35],
                       [0.15, 0.2]])
    flp, tlp = transitions.build_structured_batch(params, 6)
    offset = (np.arange(N) // 1024 * 2.0 ** -10).astype(np.float32)
    flp[[1, 3]] = flp[[1, 3]] + offset
    return flp, tlp


def test_per_read_batch_packs_at_the_most_any_read_needs():
    """make_trans_ops_batch (convert.trans_ops_batch) packs every read at
    one count of codebooks a slot, the most any read needs: a batch of
    reads that need 1 and 4 packs at 4, each read's layout resident_layout's
    at 4 (reads 0 and 2 too), (B, 4 x 21, 16) codebooks; the same batch
    without the offset reads packs at 1."""
    flp, tlp = _mixed_batch()
    from_idx = transitions.slot_from_state(6)
    needs = [1 if hmm.resident_layout(from_idx, f, 1) is not None else 4
             for f in flp]
    assert needs == [1, 4, 1, 4]
    ops = convert.trans_ops_batch(flp, tlp, 6, CPU)
    assert hmm.generic_forward_route(ops) == "resident"
    assert hmm.resident_groups(ops) == 4
    assert tuple(ops.from_codebook.shape) == (4, 4 * 21, 16)
    for b in range(4):
        packed, book = hmm.resident_layout(from_idx, flp[b], 4)
        assert np.array_equal(ops.from_packed[b].numpy(), packed)
        assert np.array_equal(ops.from_codebook[b].numpy().view(np.int32),
                              book.view(np.int32))
    ones = convert.trans_ops_batch(flp[[0, 2]], tlp[[0, 2]], 6, CPU)
    assert hmm.resident_groups(ones) == 1


def test_per_read_emulation_matches_plain_and_jax():
    """Under the mixed batch, each read's G = 4 layout emulated (the
    per-read instance's block b reads its own layout) gives the plain
    per-read forward's bits and backpointers for that read, and the plain
    per-read decode's paths equal JAX's make_trans_ops_batch decode's."""
    flp, tlp = _mixed_batch()
    ops = convert.trans_ops_batch(flp, tlp, 6, CPU)
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(35), 4, 8, [8, 0, 3, 8])
    fa_p, bps_p = hmm.viterbi_forward_plain(ops, m_t, ev_t)
    for b in range(4):
        one = hmm.ModelArrays(*(x[b:b + 1] for x in m_t))
        ev_b = {k: v[b:b + 1] for k, v in ev_t.items()}
        fa_e, bps_e = _emulated_forward(
            [(ops.from_packed[b].numpy(), ops.from_codebook[b].numpy())],
            one, ev_b)
        _same_bits(fa_e, fa_p[b:b + 1].numpy())
        assert np.array_equal(bps_e, bps_p[:, b:b + 1].numpy()), b
    want = jhmm.viterbi_decode(jhmm.make_trans_ops_batch(flp, tlp, 6), m_j,
                               ev_j)
    got = hmm.viterbi_decode(ops, m_t, ev_t)
    np.testing.assert_array_equal(got["path"].numpy().astype(np.int64),
                                  np.asarray(want["path"]).astype(np.int64))
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)


def test_resident_wrappers_check_the_groups(priors):
    """The resident K6a wrapper takes codebooks of G x deg rows, G of
    RESIDENT_GROUPS, and refuses others (before the CUDA check); K6am's
    rank check takes a cut's codebooks at cut_groups(W); nothing
    launches."""
    ops = convert.trans_ops(priors, CPU)
    _, (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(36), 2, 6, [6, 3])
    bad = ops._replace(from_codebook=ops.from_codebook[:3 * 21].contiguous())
    n0 = hmm.resident_forward_path_kernel.launches
    with pytest.raises(ValueError, match="codebooks"):
        hmm.resident_forward_path_kernel(bad, m_t, ev_t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hmm.resident_forward_path_kernel(ops, m_t, ev_t)
    assert hmm.resident_forward_path_kernel.launches == n0
    assert hmm.cut_groups(2048) == (1, 2)
    assert hmm.cut_groups(1024) == hmm.cut_groups(64) == (1,)
    assert hmm.resident_book_rows(4, 21, slice(2048, 4096)) == slice(42, 84)
    assert hmm.resident_book_rows(4, 21, slice(1536, 2048)) == slice(21, 42)
    assert hmm.resident_book_rows(1, 21, slice(1536, 2048)) == slice(0, 21)
