"""The forward-backward under per-read structured tables on one device, on
the CPU: the port's hmm.fwbw (K6c) and hmm.fwbw_custom (K6e), their plain
versions, under convert.trans_ops_batch tables (B, 21, n), against
nanocall_tpu's fwbw / fwbw_custom under make_trans_ops_batch (JAX's
_from_vals / _to_vals broadcast a read's own table), against each read
run alone under its own table, and the per-read resident layout of both
sides (hmm.make_trans_ops_batch, pack_fwbw_sides a read).

Tolerances: against JAX, K6c's alpha and beta within rtol 1e-5 where a
state's weight is above e^-80, em within rtol 1e-5 or atol 5e-4, log
Pr[data] within rtol 1e-6 (tests/test_torch_trans.py:203; XLA reorders
the jitted emission and flushes denormals); K6e's alpha, beta and gamma
within atol 1e-3 (tests/test_torch_tools.py:109).  Against each read
alone, every output bit-equal: the same plain ops on the same values.
"""

import numpy as np
import pytest
import torch

from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, transitions as ttransitions
from nanocall_tpu_torch.ops import hmm, kernels
from test_torch_train import _rows
from test_torch_trans import _assert_fwbw_close
from test_torch_trans_batch import CASES, CPU, PARAMS, _batch_ops, _bits
from torch_helpers import one_torch_thread  # noqa: F401

#: the four per-read kernel wrappers and the one-table wrappers, which
#: hand per-read tables to them
PER_READ = (hmm.fwbw_generic_per_read_kernel,
            hmm.fwbw_resident_per_read_kernel,
            hmm.fwbw_custom_per_read_kernel,
            hmm.fwbw_custom_resident_per_read_kernel)
ONE_TABLE = (hmm.fwbw_generic_kernel, hmm.fwbw_resident_kernel,
             hmm.fwbw_custom_kernel, hmm.fwbw_custom_resident_kernel)


def _inputs(K, seed):
    ops_j, ops = _batch_ops(K)
    B, T, lengths = CASES[K]
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        K, np.random.default_rng(seed), B, T, lengths)
    return ops_j, ops, m_j, ev_j, m_t, ev_t


@pytest.mark.parametrize("K", [3, 6])
def test_per_read_fwbw_layout(K):
    """make_trans_ops_batch stacks each read's resident K6c / K6e layout of
    both sides, pack_fwbw_sides' of its own table, at n = 4096 (every
    structured table packs, so the route is the resident one); at n = 64
    there is none."""
    _, ops = _batch_ops(K)
    B = CASES[K][0]
    if K == 3:
        assert ops.fwbw_packed is None
        assert hmm.fwbw_route(ops) == "streaming"
        return
    assert hmm.fwbw_route(ops) == "resident"
    width = hmm.FWBW_GROUPS * hmm.RESIDENT_CODES
    p = ops.fwbw_packed
    assert p.from_packed.shape == p.to_packed.shape == (B, 21, 4096)
    assert p.from_codebook.shape == p.to_codebook.shape == (B, 21, width)
    for b in range(B):
        want = hmm.pack_fwbw_sides(ops.from_idx.numpy(),
                                   ops.from_logp[b].numpy(),
                                   ops.to_idx.numpy(), ops.to_logp[b].numpy())
        for got, w in zip(p, want):
            np.testing.assert_array_equal(got[b].numpy(), w)


@pytest.mark.parametrize("side", ["from", "to"])
def test_one_read_without_the_layout_takes_it_from_every_read(side):
    """A read whose slot holds 17 log-probs in one block of 1024 states (on
    either side) has no K6c layout, and then no read has one: the per-read
    tables take the streaming route.  K6a's layout (the from side, one
    codebook a slot) goes with a from side that does not pack only."""
    _, ops = _batch_ops(6)
    flp, tlp = ops.from_logp.clone(), ops.to_logp.clone()
    (flp if side == "from" else tlp)[2, 3, :17] = -torch.arange(1.0, 18.0)
    out = hmm.make_trans_ops_batch(flp, tlp, 6)
    assert out.fwbw_packed is None and hmm.fwbw_route(out) == "streaming"
    assert (out.from_packed is None) == (side == "from")


@pytest.mark.parametrize("K", [3, 6])
def test_per_read_fwbw_matches_jax(K):
    """hmm.fwbw under per-read tables against JAX's fwbw under
    make_trans_ops_batch (keep_emissions: JAX returns em only then, the
    port always): alpha and beta rtol 1e-5 above e^-80, em rtol 1e-5 or
    atol 5e-4, log Pr[data] rtol 1e-6; beta is 0 from t = length-1 on and
    alpha repeats its last row past a read's length."""
    ops_j, ops, m_j, ev_j, m_t, ev_t = _inputs(K, 90 + K)
    want = jhmm.fwbw(ops_j, m_j, ev_j, keep_emissions=True)
    got = hmm.fwbw(ops, m_t, ev_t)
    _assert_fwbw_close(got, want)
    for b, L in enumerate(CASES[K][2]):
        assert (got["beta"][b, max(L - 1, 0):] == 0).all()
        if L:
            assert torch.equal(got["alpha"][b, L:],
                               got["alpha"][b, L - 1].expand_as(
                                   got["alpha"][b, L:]))


@pytest.mark.parametrize("K", [3, 6])
def test_per_read_fwbw_custom_matches_jax(K):
    """hmm.fwbw_custom under per-read tables against JAX's fwbw_custom
    under make_trans_ops_batch: alpha, beta and gamma within atol 1e-3
    everywhere, padding included, NaN where JAX has NaN."""
    ops_j, ops, m_j, ev_j, m_t, ev_t = _inputs(K, 100 + K)
    want = jhmm.fwbw_custom(ops_j, m_j, ev_j)
    got = hmm.fwbw_custom(ops, m_t, ev_t)
    for k in ("alpha", "beta", "gamma"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, err_msg=k)
    assert torch.isfinite(got["gamma"]).any()


@pytest.mark.parametrize("fn", ["fwbw", "fwbw_custom"])
@pytest.mark.parametrize("K", [3, 6])
def test_per_read_fwbw_bit_equal_to_each_read_alone(K, fn):
    """Each read's outputs under the per-read tables are, bit for bit,
    those of the read run alone under its own table (convert.trans_ops of
    build_structured at its kinetics), through hmm.fwbw and
    hmm.fwbw_custom."""
    _, ops, _, _, m_t, ev_t = _inputs(K, 110 + K)
    call = getattr(hmm, fn)
    got = call(ops, m_t, ev_t)
    for b, (p_stay, p_skip) in enumerate(PARAMS[:CASES[K][0]]):
        one = convert.trans_ops(ttransitions.build_structured(
            ttransitions.TransitionParams(p_stay, p_skip), K), CPU)
        solo = call(one, hmm.ModelArrays(*(x[b:b + 1] for x in m_t)),
                    {k: v[b:b + 1] for k, v in ev_t.items()})
        assert got.keys() == solo.keys()
        for k, v in solo.items():
            assert torch.equal(_bits(got[k][b]), _bits(v[0])), (b, k)


def test_per_read_fwbw_wrappers_check_the_tables():
    """The per-read wrappers of K6c's and K6e's kernels (and the one-table
    wrappers, which hand per-read tables to them) take per-read tables of
    the events' B (the resident ones each read's packed sides, the
    streaming ones each read's (B, 21, 4096) log-probs) and, having checked
    them, refuse CPU tensors; tables of another B raise on their shape; the
    per-read wrappers refuse one table for every read; nothing launches."""
    _, ops, _, _, m_t, ev_t = _inputs(6, 120)
    B = CASES[6][0]
    fewer = ops._replace(
        from_logp=ops.from_logp[1:].contiguous(),
        to_logp=ops.to_logp[1:].contiguous(),
        fwbw_packed=hmm.PackedSides(*(x[1:].contiguous()
                                      for x in ops.fwbw_packed)))
    one = convert.trans_ops(ttransitions.build_structured(K=6), CPU)
    for call in PER_READ + ONE_TABLE:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(ops, m_t, ev_t)
        with pytest.raises(ValueError, match=f"\\({B - 1}, 21"):
            call(fewer, m_t, ev_t)
    for call in PER_READ:
        with pytest.raises(ValueError, match="per-read"):
            call(one, m_t, ev_t)
    for k in kernels.KERNELS:
        assert k.wrapper.launches == 0, k.name
