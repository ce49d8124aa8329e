"""Per-read structured tables on one device, on the CPU: the port's
transitions.build_structured_batch, hmm.make_trans_ops_batch /
convert.trans_ops_batch and the generic Viterbi decode (K6a + K6b, their
plain versions) under (B, 21, n) tables, against nanocall_tpu's
build_structured_batch and make_trans_ops_batch (tests/test_hmm.py:142
test_per_batch_transition_tables) and against each read's decode alone;
the state axis's forward-backward (K6cm) refusing them.  The
forward-backward (K6c, K6e) under them: tests/test_torch_fwbw_batch.py.

Tolerances: build_structured_batch is numpy in both packages, so its
tables are equal (-inf entries included); against JAX's decode, paths
equal and logp within rtol 1e-5 (tests/test_torch_trans.py's tolerance:
XLA reorders the jitted emission); against each read alone under its own
table, path and logp bit-equal (the same plain ops on the same values).
"""

import numpy as np
import pytest
import torch

from nanocall_tpu import transitions
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, transitions as ttransitions
from nanocall_tpu_torch.ops import hmm, kernels
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
#: (p_stay, p_skip) rows: JAX's test's, then (0.14, 0.21)
PARAMS = np.array([[0.1, 0.3], [0.15, 0.2], [0.07, 0.35], [0.1, 0.3],
                   [0.14, 0.21]])
CASES = {  # K: (B, T, lengths), lengths 0, 1, T-1 and T among them
    3: (5, 40, [40, 0, 1, 39, 25]),
    6: (5, 12, [12, 0, 1, 11, 7]),
}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("K", [3, 6])
def test_build_structured_batch_equals_jax(K):
    """The port's build_structured_batch is JAX's, array for array (-inf
    entries equal), and each read's table is build_structured's at its
    kinetics."""
    fj, tj = transitions.build_structured_batch(PARAMS, K)
    ft, tt = ttransitions.build_structured_batch(PARAMS, K)
    assert ft.dtype == tt.dtype == np.float32
    assert ft.shape == tt.shape == (len(PARAMS), 21, 4 ** K)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(tt, tj)
    assert np.isneginf(ft).any()
    for b, (p_stay, p_skip) in enumerate(PARAMS):
        one = ttransitions.build_structured(
            ttransitions.TransitionParams(p_stay, p_skip), K)
        np.testing.assert_array_equal(ft[b], one.from_logp)
        np.testing.assert_array_equal(tt[b], one.to_logp)


def _batch_ops(K):
    B = CASES[K][0]
    fb, tb = transitions.build_structured_batch(PARAMS[:B], K)
    return jhmm.make_trans_ops_batch(fb, tb, K), convert.trans_ops_batch(
        fb, tb, K, CPU)


@pytest.mark.parametrize("K", [3, 6])
def test_trans_ops_batch_layout(K):
    """make_trans_ops_batch keeps the (B, 21, n) log-probs, the fixed slot
    maps and K6b's from-state table shared by every read; at n = 4096 each
    read's resident K6a layout is pack_slots' of its own table (every
    structured table packs; its K6c layout of both sides too:
    tests/test_torch_fwbw_batch.py), at n = 64 there is none."""
    ops_j, ops = _batch_ops(K)
    np.testing.assert_array_equal(ops.from_logp.numpy(),
                                  np.asarray(ops_j.from_logp))
    np.testing.assert_array_equal(ops.to_logp.numpy(),
                                  np.asarray(ops_j.to_logp))
    np.testing.assert_array_equal(ops.from_idx.numpy(),
                                  ttransitions.slot_from_state(K))
    np.testing.assert_array_equal(ops.to_idx.numpy(),
                                  ttransitions._slot_maps(K)[1])
    assert hmm.per_read(ops)
    if K == 3:
        assert ops.from_packed is ops.from_states is ops.fwbw_packed is None
        return
    assert hmm.fwbw_route(ops) == "resident"
    assert hmm.generic_forward_route(ops) == "resident"
    assert ops.from_packed.shape == (CASES[K][0], 21, 4096)
    assert ops.from_codebook.shape == (CASES[K][0], 21, hmm.RESIDENT_CODES)
    for b in range(CASES[K][0]):
        packed, book = hmm.pack_slots(ops.from_idx.numpy(),
                                      ops.from_logp[b].numpy())
        np.testing.assert_array_equal(ops.from_packed[b].numpy(), packed)
        np.testing.assert_array_equal(ops.from_codebook[b].numpy(), book)
    np.testing.assert_array_equal(ops.from_states.numpy(),
                                  ops.from_idx.numpy())
    # one read whose slot holds 17 log-probs takes every read's layout away
    flp = ops.from_logp.clone()
    flp[2, 3, :17] = -torch.arange(1.0, 18.0)
    assert hmm.make_trans_ops_batch(flp, ops.to_logp, K).from_packed is None


@pytest.mark.parametrize("K", [3, 6])
def test_per_read_decode_matches_jax(K):
    """The port's viterbi_decode under per-read tables against JAX's under
    make_trans_ops_batch: backpointers and paths equal, logp and the final
    alphas within rtol 1e-5; score-only the same logp."""
    ops_j, ops = _batch_ops(K)
    B, T, lengths = CASES[K]
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        K, np.random.default_rng(60 + K), B, T, lengths)
    fa_j, bps_j = jhmm.viterbi_forward(ops_j, m_j, ev_j)
    fa_t, bps_t = hmm.viterbi_forward(ops, m_t, ev_t)
    np.testing.assert_array_equal(bps_t.numpy(), np.asarray(bps_j))
    np.testing.assert_allclose(fa_t.numpy(), np.asarray(fa_j), rtol=1e-5)
    want = jhmm.viterbi_decode(ops_j, m_j, ev_j)
    got = hmm.viterbi_decode(ops, m_t, ev_t)
    np.testing.assert_array_equal(got["path"].numpy().astype(np.int64),
                                  np.asarray(want["path"]).astype(np.int64))
    np.testing.assert_allclose(got["logp"].numpy(), np.asarray(want["logp"]),
                               rtol=1e-5)
    score = hmm.viterbi_decode(ops, m_t, ev_t, with_path=False)
    assert torch.equal(score["logp"], got["logp"])


@pytest.mark.parametrize("K", [3, 6])
def test_per_read_decode_bit_equal_to_each_read_alone(K):
    """Each read's path and logp under the per-read tables are, bit for
    bit, those of its decode alone under its own table (convert.trans_ops
    of build_structured at its kinetics)."""
    _, ops = _batch_ops(K)
    B, T, lengths = CASES[K]
    _, (_, m_t, ev_t), _ = _rows(K, np.random.default_rng(70 + K), B, T,
                                 lengths)
    got = hmm.viterbi_decode(ops, m_t, ev_t)
    for b, (p_stay, p_skip) in enumerate(PARAMS[:B]):
        one = convert.trans_ops(ttransitions.build_structured(
            ttransitions.TransitionParams(p_stay, p_skip), K), CPU)
        solo = hmm.viterbi_decode(
            one, hmm.ModelArrays(*(x[b:b + 1] for x in m_t)),
            {k: v[b:b + 1] for k, v in ev_t.items()})
        assert torch.equal(got["path"][b], solo["path"][0]), b
        assert torch.equal(_bits(got["logp"][b]), _bits(solo["logp"][0])), b


def test_state_axis_fwbw_refuses_per_read_tables():
    """K6cm, the forward-backward on the mesh's state axis, takes one table
    for every read (JAX runs fwbw there only in the legacy EM round, under
    one loaded table): a rank's cut of per-read tables
    (hmm.cut_fwbw_table) and a rank of them (hmm._check_fwbw_wave_rank, the
    wrappers' check) raise ValueError before any launch."""
    _, ops = _batch_ops(6)
    B, T, lengths = CASES[6]
    _, (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(80), B, T,
                                 lengths)
    with pytest.raises(ValueError, match="per-read"):
        hmm.cut_fwbw_table(ops, slice(0, 2048), CPU)
    W = 2048
    rank = hmm.FwbwWaveRank(
        ops, hmm.ModelArrays(*(x[:, :W].contiguous() for x in m_t)), ev_t,
        *(torch.empty((B, T, W)) for _ in range(3)), torch.empty(B),
        torch.empty((2, B, W)), torch.empty((2, B)),
        torch.zeros(B, dtype=torch.int32))
    for resident in (True, False):
        with pytest.raises(ValueError, match="per-read"):
            hmm._check_fwbw_wave_rank(0, rank, B, T, W, resident)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name


def test_per_read_kernel_wrappers_check_the_tables():
    """K6a's wrappers take per-read tables of the events' B (the resident
    one its (B, 21, 4096) layout, the streaming one its (B, 21, 4096)
    log-probs) and, having checked them, refuse CPU tensors; tables of
    another B raise on their shape; nothing launches."""
    _, ops = _batch_ops(6)
    B, T, lengths = CASES[6]
    _, (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(81), B, T,
                                 lengths)
    fewer = ops._replace(from_logp=ops.from_logp[1:].contiguous(),
                         to_logp=ops.to_logp[1:].contiguous(),
                         from_packed=ops.from_packed[1:].contiguous(),
                         from_codebook=ops.from_codebook[1:].contiguous())
    for call in (hmm.resident_forward_path_kernel,
                 hmm.resident_forward_score_kernel,
                 hmm.generic_forward_path_kernel,
                 hmm.generic_forward_score_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(ops, m_t, ev_t)
        with pytest.raises(ValueError, match=f"\\({B - 1}, 21"):
            call(fewer, m_t, ev_t)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name
