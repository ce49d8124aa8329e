"""The port's chunk sizes: every (T, B) its drivers can dispatch comes from
nanocall_tpu_torch/shapes.py's enumeration, as tests/test_shapes.py holds
the JAX package's drivers to nanocall_tpu/shapes.py.

The real _DecodeDriver._pump/_flush and _EMDriver.add/finish are driven
over adversarial queue sizes, lengths, configurations and shard counts
(align, the data sharder's device count): a full chunk holds exactly the
bucket's cap, floored to a multiple of align, and every other chunk fewer
tasks.  The length rungs are the JAX package's.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from nanocall_tpu import shapes as jshapes
from nanocall_tpu_torch import basecall, batching, convert, shapes, \
    transitions
from nanocall_tpu_torch.config import Config
from nanocall_tpu_torch.parallel import mesh

CPU = torch.device("cpu")


class _FakeTask:
    def __init__(self, L):
        self.ev = np.zeros(L, np.float32)


class _FakeGroup:
    def __init__(self, L):
        self.read_idx = 0
        self.seqs = [(np.zeros(L, np.float32), 0)]


def _decode_driver(cfg, align: int = 1, trans=None):
    return basecall._DecodeDriver(
        [], {}, cfg, basecall.EventPool(CPU), default_transitions=trans,
        sharder=mesh.DataSharder(devices=[CPU] * align))


def _capture(drv) -> list:
    seen = []
    drv._dispatch = lambda sub, T, sparse, wp: seen.append((T, len(sub), wp))
    return seen


def test_length_rungs_cover_bucket_length_and_equal_jax():
    rungs = set(shapes.length_rungs(100_000))
    for L in [1, 100, 128, 129, 2047, 2048, 2049, 4096, 8191, 8192, 8193,
              50_000, 99_999, 100_000]:
        assert batching.bucket_length(L) in rungs
    assert max(rungs) == batching.bucket_length(100_000) == 100_352
    for n in (1, 5000, 100_000):
        assert shapes.length_rungs(n) == jshapes.length_rungs(n)


def test_floor_align():
    assert [shapes.floor_align(b, 1) for b in (1, 7, 256)] == [1, 7, 256]
    assert [shapes.floor_align(b, 8) for b in (1, 7, 8, 10, 256)] == \
        [8, 8, 8, 8, 256]
    for b in range(1, 300):
        for a in (2, 3, 8):
            assert shapes.floor_align(b, a) == jshapes._floor_align(b, a)


CFGS = [Config(), Config(score_max_batch=1024), Config(bucket_max_batch=64)]


@pytest.mark.parametrize("cfg", CFGS, ids=["default", "score1024", "small"])
@pytest.mark.parametrize("align", [1, 3, 8])
def test_decode_full_batch_is_the_cap(cfg, align):
    """Each bucket's full chunk is its cap from shapes.py, a multiple of
    align, within the backpointer budget unless align forces more."""
    drv = _decode_driver(cfg, align)
    for T in shapes.length_rungs(100_000):
        for wp, cap in ((True, shapes.path_chunk_cap),
                        (False, shapes.score_chunk_cap)):
            B = drv._full_batch(T, wp)
            assert B == cap(cfg, T, align) and B % align == 0, (T, wp)
            assert B in (shapes.path_chunk_batches if wp
                         else shapes.score_chunk_batches)(cfg, T, align)
        if align == 1:
            assert drv._full_batch(T, True) * (T - 1) * 4096 <= \
                shapes.BP_BUDGET or drv._full_batch(T, True) == 1


@pytest.mark.parametrize("with_path", [True, False])
@pytest.mark.parametrize("align", [1, 8])
def test_pump_and_flush_shapes_in_enumeration(with_path, align):
    """_pump dispatches only full chunks of the cap; _flush dispatches the
    rest in chunks of the cap and one shorter; every task goes once."""
    cfg = Config()
    ladder = (shapes.path_chunk_batches if with_path
              else shapes.score_chunk_batches)
    for qlen in [1, 2, 7, 8, 9, 63, 64, 65, 255, 256, 257, 1025]:
        for L in [50, 2048, 4100, 8192, 40_000, 99_999]:
            T = batching.bucket_length(L)
            drv = _decode_driver(cfg, align)
            seen = _capture(drv)
            drv.queue = {(T, False, with_path): [_FakeTask(L)] * qlen}
            drv._pump()
            cap = drv._full_batch(T, with_path)
            assert all(B == cap for _, B, _ in seen), (qlen, L)
            drv._flush(with_path)
            assert sum(B for _, B, _ in seen) == qlen
            for sT, sB, swp in seen:
                assert swp is with_path and sT == T
                assert sB in ladder(cfg, T, align), (sT, sB, qlen)
            assert sum(B < cap for _, B, _ in seen) <= 1


@settings(max_examples=60, deadline=None)
@given(
    bmb=st.sampled_from([16, 64, 256, 1000]),
    smb=st.sampled_from([0, 64, 700, 1024, 4096]),
    align=st.sampled_from([1, 2, 3, 8]),
    L=st.sampled_from([50, 2048, 8000, 40_000, 99_999]),
    qlen=st.integers(1, 300),
    wp=st.booleans(),
)
def test_flush_shapes_in_enumeration_randomized(bmb, smb, align, L, qlen,
                                                 wp):
    """A sweep over batch flags, shard counts, lengths and queue sizes:
    every chunk, and every shard the sharder cuts it into, is enumerated."""
    cfg = Config(bucket_max_batch=bmb, score_max_batch=smb)
    drv = _decode_driver(cfg, align)
    seen = _capture(drv)
    T = batching.bucket_length(L)
    drv.queue = {(T, False, wp): [_FakeTask(L)] * qlen}
    drv._flush(wp)
    ladder = shapes.path_chunk_batches if wp else shapes.score_chunk_batches
    cap = drv._full_batch(T, wp)
    assert seen and cap in ladder(cfg, T, align=align)
    for sT, sB, _ in seen:
        assert sB in ladder(cfg, sT, align=align), (sT, sB)
        sizes = shapes.shard_sizes(sB, align)
        assert sum(sizes) == sB and max(sizes) <= -(-cap // align)
        if sB == cap:  # a full chunk splits evenly
            assert len(set(sizes)) == 1 and len(sizes) == align


def test_sparse_kind_shares_the_caps():
    """Under a loaded table the sparse chunks take the same caps."""
    table = transitions.sparse_from_pairs(
        transitions.structured_to_pairs(transitions.build_structured()), 6)
    cfg = Config()
    drv = _decode_driver(cfg, 2, trans=table)
    seen = _capture(drv)
    drv.queue = {(8192, True, True): [_FakeTask(8000)] * 5}
    drv._flush(True)
    assert [B for _, B, _ in seen] == [5]
    assert isinstance(drv.sparse_ops, type(convert.trans_ops(table, CPU)))
    assert drv._full_batch(8192, True) == shapes.path_chunk_cap(cfg, 8192, 2)


@pytest.mark.parametrize("cfg,trans", [
    (Config(), False), (Config(scaling_num_events=4096), False),
    (Config(scaling_num_events=4096), True),
    (Config(train_scaling=False, train_transitions=False), False)],
    ids=["default", "long", "long_trans", "fit_only"])
@pytest.mark.parametrize("align", [1, 3])
def test_em_chunks_in_enumeration(cfg, trans, align):
    """_EMDriver runs full chunks of the train cap (a --trans table: the
    legacy round's, LEGACY_BYTES_PER_CELL) as groups arrive, and the rest
    at finish in chunks of at most the cap."""
    table = (transitions.sparse_from_pairs(transitions.structured_to_pairs(
        transitions.build_structured()), 6) if trans else None)
    drv = basecall._EMDriver([], {}, cfg, CPU, default_transitions=table,
                             sharder=mesh.DataSharder(devices=[CPU] * align))
    seen = []
    drv._run = lambda sub, T, states, limit: seen.append((T, len(sub)))
    for T in (128, 256, 2048):
        cap = drv._full_batch(T)
        assert cap == shapes.train_chunk_cap(cfg, T, align, trans)
        assert cap % align == 0 and cap in shapes.train_chunk_batches(
            cfg, T, align, trans)
        seen.clear()
        qlen = 2 * cap + 1
        for _ in range(qlen):
            drv.add([_FakeGroup(T)])
        assert seen == [(T, cap)] * 2
        drv.reads.clear()  # no summaries to select models for
        drv.finish()
        assert seen[-1] == (T, 1)
    want = shapes.train_chunk_cap(cfg, align=align, with_trans_table=trans)
    T0 = batching.bucket_length(max(1, cfg.scaling_num_events // 2))
    assert want == drv._full_batch(T0)
