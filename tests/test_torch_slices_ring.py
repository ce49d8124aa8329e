"""The state-parallel walks' ring stages and backpointer layout, on the CPU.

K2m and K6bm (csrc/viterbi_traceback.cu) fill a ring stage of RING_ROWS
backpointer rows either by one tensor copy from the one (R, M, T - 1, B,
W) allocation that holds every rank's slice of a card's data rows (the
tensor route), or by a bulk copy a row and rank (the copies route, rows
across cards).  Here: the plain twin of the tensor route's stage fill
(hmm.slices_box_coords, hmm.tensor_stage_plain) against the rows the
one-device ring assembles (hmm.copies_stage_plain, and the whole rows K6b's
ring reads); statepar.backpointer_slices' allocation; hmm.slices_walk_route;
and the placed decodes' walk launches on the CPU meshes, bit-equal to the
unplaced decodes.  Every comparison is exact (bytes and bits).
"""

import numpy as np
import pytest
import torch

from nanocall_tpu_torch import basecall
from nanocall_tpu_torch import transitions as ttrans
from nanocall_tpu_torch import convert
from nanocall_tpu_torch.ops import hmm
from nanocall_tpu_torch.parallel import mesh, statepar
from test_torch_statepar import _port_args
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
META = torch.device("meta")
#: the (data, model) meshes of test_torch_statepar.py
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (4, 2)]
#: events of the stage tests: 10 backpointer rows, three stages a walk
T_RING = 11


def _block(R: int, M: int, B: int, T: int, seed: int) -> torch.Tensor:
    """An (R, M, T - 1, B, 4096 / M) uint8 allocation of random bytes, from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        0, 256, (R, M, T - 1, B, 4096 // M), dtype=np.uint8))


@pytest.mark.parametrize("M", [2, 4, 8, 64])
def test_tensor_stage_equals_the_ring_rows(M):
    """Each stage of each walk, on the tensor route, holds in slot
    RING_ROWS - 1 - r the row the one-device ring puts in slot r (the
    backpointer row t_top - 1 - RING_ROWS q - r of the read, its M slices
    side by side: the whole row K6b's ring reads), for reads of lengths 0,
    1, 2, 5 and T in both rows of a launch; the box's rows below row 0
    (below event 1) are zeros, and the walk reads every row of the read
    from t_top - 1 down to 0 once."""
    R, T = 2, T_RING
    lengths = [0, 1, 2, 5, T]
    block = _block(R, M, len(lengths), T, M)
    for row in range(R):
        whole = torch.cat(list(block[row]), dim=2)  # (T - 1, B, 4096)
        for b, L in enumerate(lengths):
            t_top = min(L, T) - 1
            n = max(t_top, 0)
            seen = []
            for q in range(-(-n // hmm.RING_ROWS)):
                coords = hmm.slices_box_coords(row, b, t_top, q)
                assert coords[:3] == (0, 0, b) and coords[4] == row
                got = hmm.tensor_stage_plain(block, coords)
                ring, cnt = hmm.copies_stage_plain(list(block[row]), b,
                                                   t_top, q)
                for r in range(cnt):
                    s = hmm.RING_ROWS - 1 - r
                    i = t_top - 1 - hmm.RING_ROWS * q - r
                    assert torch.equal(got[s], ring[r]), (M, row, L, q, r)
                    assert torch.equal(got[s], whole[i, b]), (M, row, L, q)
                    seen.append(i)
                i0 = coords[3]
                for s in range(hmm.RING_ROWS):
                    if i0 + s < 0:
                        assert not got[s].any(), (M, row, L, q, s)
                        assert s < hmm.RING_ROWS - cnt
            assert seen == list(range(t_top - 1, -1, -1)), (M, L, seen)
            assert len(seen) == n


def test_partial_last_stage_is_zero_filled_below_event_one():
    """A read of 6 events walks rows 4 .. 0: the second stage's box starts
    at row -3, its slots 0 .. 2 zeros and slot 3 row 0."""
    block = _block(1, 4, 1, 8, 7)
    coords = hmm.slices_box_coords(0, 0, 5, 1)
    assert coords == (0, 0, 0, -3, 0)
    got = hmm.tensor_stage_plain(block, coords)
    assert not got[:3].any()
    assert torch.equal(got[3], block[0, :, 0, 0].reshape(-1))


def test_backpointer_slices_one_allocation_a_device():
    """Rows whose ranks lie on one device get views of one (R, M, T - 1, B,
    W) allocation (same storage, rank m of row r at (r M + m)(T - 1) B W
    bytes) and one launch; a row across devices a tensor a rank and a
    launch of its own; rows of another key (another table) an allocation
    and a launch of their own."""
    M, B, T, W = 4, 3, 7, 1024
    one = [(CPU, B, W)] * M
    span = [(CPU, B, W), (META, B, W)] * (M // 2)
    bps, launches = statepar.backpointer_slices([one, span, one], T)
    assert launches == [[0, 2], [1]]
    base = bps[0][0].data_ptr()
    size = (T - 1) * B * W
    for r, i in enumerate((0, 2)):
        for m, x in enumerate(bps[i]):
            assert x.shape == (T - 1, B, W) and x.dtype == torch.uint8
            assert x.is_contiguous()
            assert x.untyped_storage().data_ptr() == \
                bps[0][0].untyped_storage().data_ptr()
            assert x.data_ptr() == base + (r * M + m) * size
    assert [x.device for x in bps[1]] == [CPU, META] * (M // 2)
    cpu_spans = [x for x in bps[1] if x.device == CPU]
    assert len({x.untyped_storage().data_ptr() for x in cpu_spans}) == \
        len(cpu_spans)
    assert hmm.slices_walk_route([bps[0], bps[2]]) == "tensor"
    _, launches = statepar.backpointer_slices([one, one, one], T,
                                              ["a", "b", "a"])
    assert launches == [[0, 2], [1]]


def test_slices_walk_route():
    """slices_walk_route: "tensor" for rows of views [r, m] of one
    allocation in order (a run of rows from any first row too); "copies"
    for slices of their own, ranks or rows out of order, a slice that is
    not contiguous, or slices of another shape."""
    M, B, T, W = 4, 2, 5, 1024
    block = torch.zeros((3, M, T - 1, B, W), dtype=torch.uint8)
    rows = [list(block[r]) for r in range(3)]
    assert hmm.slices_walk_route(rows) == "tensor"
    assert hmm.slices_walk_route(rows[1:]) == "tensor"
    assert hmm.slices_walk_route([rows[1]]) == "tensor"
    assert hmm.slices_walk_route([rows[1], rows[0]]) == "copies"
    assert hmm.slices_walk_route([rows[0][::-1]]) == "copies"
    assert hmm.slices_walk_route([rows[0], rows[2]]) == "copies"
    own = [torch.zeros((T - 1, B, W), dtype=torch.uint8) for _ in range(M)]
    assert hmm.slices_walk_route([own]) == "copies"
    wide = torch.zeros((T - 1, B, M * W), dtype=torch.uint8)
    cut = [wide[..., m * W:(m + 1) * W] for m in range(M)]
    assert hmm.slices_walk_route([cut]) == "copies"
    assert hmm.slices_walk_route([[x.contiguous() for x in cut]]) == \
        "copies"
    flat = block.view(-1)
    n = (T - 1) * B * W
    odd = [flat[m * n:(m + 1) * n].view(T - 1, B, W // 2, 2)[..., 0]
           for m in range(M)]
    assert hmm.slices_walk_route([odd]) == "copies"


def _record_walks(monkeypatch) -> list:
    """statepar's walk launches, recorded: [(launches, [route a launch])]
    a decode."""
    seen = []
    orig = statepar._walk_rows

    def rec(groups, launches, walk, with_path, kernels, T):
        seen.append((launches, [hmm.slices_walk_route(
            [[r.bps for r in groups[i]] for i in idx]) for idx in launches]))
        return orig(groups, launches, walk, with_path, kernels, T)

    monkeypatch.setattr(statepar, "_walk_rows", rec)
    return seen


def _cpu_mesh(D: int, M: int) -> mesh.Mesh:
    return mesh.make_mesh(D * M, model_axis=M, devices=[CPU] * (D * M))


@pytest.mark.parametrize("D,M", MESHES)
def test_placed_generic_decode_walks_a_device_in_one_launch(monkeypatch, D,
                                                            M):
    """The placed generic decode on a (D, M) CPU mesh walks its D data rows
    in one launch on the tensor route (one allocation, every rank on the
    one device), and stays bit-equal to the unplaced decode (path, logp,
    NaN bits included)."""
    B, T = 8, 10
    lengths = [T, 0, 1, T - 1, 6, T, 3, T]
    _, (_, model, ev), _ = _rows(6, np.random.default_rng(90), B, T,
                                 lengths)
    ev["mean"][0, T // 2] = float("nan")
    ops = convert.trans_ops(ttrans.build_structured(
        ttrans.TransitionParams(0.14, 0.21), 6), CPU)
    ref = hmm.viterbi_decode(ops, model, ev)
    seen = _record_walks(monkeypatch)
    placed = mesh.shard_decode_inputs(_cpu_mesh(D, M), ops, model, ev)
    got = mesh.join(statepar.viterbi_decode_placed(*placed))
    assert seen == [([list(range(D))], ["tensor"])]
    for k in ("path", "logp"):
        g, w = got[k], ref[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (D, M, k)


@pytest.mark.parametrize("D,M", MESHES)
def test_placed_production_decode_walks_a_device_in_one_launch(monkeypatch,
                                                               D, M):
    """The placed production decode (basecall.decode_chunk_pooled on
    shard_pooled_decode_inputs) on a (D, M) CPU mesh walks its data rows in
    one launch on the tensor route, and stays bit-equal to the unplaced
    decode (path0, codes, logp)."""
    args = _port_args(8, 12, 5, nan=True)
    [ref] = basecall.decode_chunk_pooled(*args)
    seen = _record_walks(monkeypatch)
    placed = mesh.shard_pooled_decode_inputs(_cpu_mesh(D, M), *args)
    got = mesh.join(basecall.decode_chunk_pooled(*placed))
    assert seen == [([list(range(D))], ["tensor"])]
    for k in ("path0", "codes", "logp"):
        g, w = got[k], ref[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (D, M, k)


def test_score_only_decodes_allocate_no_backpointers(monkeypatch):
    """A score-only placed decode (generic and production, a (2, 2) CPU
    mesh) lays out no backpointer slices, and its logp stays bit-equal to
    the unplaced decode's."""
    def refuse(*args, **kw):
        raise AssertionError("backpointer slices for a score-only decode")

    monkeypatch.setattr(statepar, "backpointer_slices", refuse)
    B, T = 8, 10
    _, (_, model, ev), _ = _rows(6, np.random.default_rng(91), B, T,
                                 [T, 0, 1, T - 1, 6, T, 3, T])
    ops = convert.trans_ops(ttrans.build_structured(
        ttrans.TransitionParams(0.14, 0.21), 6), CPU)
    ref = hmm.viterbi_decode(ops, model, ev, with_path=False)
    placed = mesh.shard_decode_inputs(_cpu_mesh(2, 2), ops, model, ev)
    got = mesh.join(statepar.viterbi_decode_placed(*placed,
                                                   with_path=False))
    assert torch.equal(got["logp"].view(torch.int32),
                       ref["logp"].view(torch.int32))
    args = _port_args(8, 12, 6)
    [ref] = basecall.decode_chunk_pooled(*args, with_path=False)
    placed = mesh.shard_pooled_decode_inputs(_cpu_mesh(2, 2), *args)
    got = mesh.join(basecall.decode_chunk_pooled(*placed, with_path=False))
    assert torch.equal(got["logp"].view(torch.int32),
                       ref["logp"].view(torch.int32))


def test_slices_walk_wrappers_refuse_cpu_rows():
    """K2m's and K6bm's wrappers take several rows too, on CUDA tensors
    only: CPU rows raise, and nothing is counted on either route."""
    M, B, T, W = 2, 3, 5, 2048
    block = torch.zeros((2, M, T - 1, B, W), dtype=torch.uint8)
    cols = [[torch.zeros((B, W))] * M] * 2
    lengths = [torch.full((B,), T, dtype=torch.int32)] * 2
    ops = convert.trans_ops(ttrans.build_structured(
        ttrans.TransitionParams(0.14, 0.21), 6), CPU)
    before = [(k.launches, dict(k.routes)) for k in (
        hmm.traceback_slices_kernel, hmm.generic_traceback_slices_kernel)]
    with pytest.raises(ValueError, match="CUDA"):
        hmm.traceback_slices_kernel(6, cols, [list(b) for b in block],
                                    lengths)
    with pytest.raises(ValueError, match="CUDA"):
        hmm.generic_traceback_slices_kernel(ops, cols,
                                            [list(b) for b in block],
                                            lengths, route="tensor")
    assert [(k.launches, dict(k.routes)) for k in (
        hmm.traceback_slices_kernel,
        hmm.generic_traceback_slices_kernel)] == before
