"""The streaming K6c and K6e (the forward-backward under a table without
K6c's packed layout), on the CPU: the port's hmm.fwbw and hmm.fwbw_custom
against nanocall_tpu's fwbw and fwbw_custom under seeded random tables of
1, 21 and 40 slots that pack_fwbw_sides refuses, one table and per read;
and a plain model of the order in which the streaming bodies read the
table (common.cuh lse_slots: each step the side's slot rows once for the
max, then once for the slot-ordered sum; a read past its end keeping its
alpha or zeroing its beta), bit-equal to fwbw_plain and
fwbw_custom_plain.

Tolerances against JAX: K6c's alpha and beta within rtol 1e-5 where a
state's weight is above e^-80, em within rtol 1e-5 or atol 5e-4, log
Pr[data] within rtol 1e-6 (tests/test_torch_trans.py _assert_fwbw_close);
K6e's alpha, beta and gamma within rtol 1e-5, atol 1e-3
(tests/test_torch_tools.py _assert_custom_close).  The model of the slot
order against the plain versions: bit-equal, NaN where they are NaN.
"""

import math

import numpy as np
import pytest
import torch

from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, transitions
from nanocall_tpu_torch.ops import hmm
from test_torch_tools import _assert_custom_close
from test_torch_train import _rows
from test_torch_trans import _assert_fwbw_close
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
N = 4096
#: slot counts of the random tables: one slot, the loaded tables' 21, and
#: more than the resident layout's 23
DEGS = (1, 21, 40)
#: B reads x T events, the lengths (0, 1, 2, T - 1, T among them)
B, T = 5, 9
LENGTHS = [T, 0, 1, 2, T - 1]


def _table(deg: int, seed: int, reads: int = 0):
    """A random table of `deg` slots a side, from a numpy seed: random
    states, and at each state probabilities U(0.01, 1) over its slots
    normalised to sum to 1, as a transition table's, with every seventh
    entry a padded slot (log-prob -inf); a table of one slot keeps its
    U(0.01, 1) unnormalised (else every log-prob is 0 and it packs);
    either one (deg, n) table or, reads > 0, per-read (reads, deg, n)
    log-probs over one slot map.  Returns (from_idx, from_logp, to_idx,
    to_logp) numpy arrays."""
    rng = np.random.default_rng(seed)
    lead = (reads,) if reads else ()
    out = []
    for _ in range(2):
        idx = rng.integers(0, N, (deg, N)).astype(np.int32)
        p = rng.uniform(0.01, 1.0, (*lead, deg, N))
        if deg > 1:
            p.reshape(*lead, -1)[..., ::7] = 0.0
            p /= p.sum(-2, keepdims=True)
        with np.errstate(divide="ignore"):
            lp = np.log(p).astype(np.float32)
        out += [idx, lp]
    return tuple(out)


def _both(table):
    """The table as nanocall_tpu's TransOps and the port's."""
    fi, fl, ti, tl = table
    ops_j = jhmm.TransOps(from_logp=fl, to_logp=tl, from_idx=fi, to_idx=ti,
                          K=6)
    if fl.ndim == 2:
        ops_t = convert.trans_ops(transitions.SparseTransitions(
            from_idx=fi, from_logp=fl, to_idx=ti, to_logp=tl, K=6), CPU)
    else:
        ops_t = convert.trans_ops(transitions.SparseTransitions(
            from_idx=fi, from_logp=fl[0], to_idx=ti, to_logp=tl[0], K=6),
            CPU)._replace(from_logp=torch.from_numpy(fl),
                          to_logp=torch.from_numpy(tl))
    return ops_j, ops_t


@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_random_tables_stream(deg, per_read):
    """pack_fwbw_sides refuses the random tables (no slot of 16 log-probs
    a block), so the port routes them to the streaming kernels, under one
    table and per read (hmm.per_read)."""
    fi, fl, ti, tl = _table(deg, deg, B if per_read else 0)
    for lp, tp in ((fl, tl),) if not per_read else zip(fl, tl):
        assert hmm.pack_fwbw_sides(fi, lp, ti, tp) is None
    _, ops = _both((fi, fl, ti, tl))
    assert hmm.fwbw_route(ops) == "streaming"
    assert hmm.per_read(ops) == per_read


@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_stream_fwbw_matches_jax(deg, per_read):
    """K6c (hmm.fwbw) under a random table against nanocall_tpu's fwbw:
    _assert_fwbw_close; beta 0 from t = length - 1 on, alpha repeating its
    last row past a read's length."""
    ops_j, ops_t = _both(_table(deg, 10 + deg, B if per_read else 0))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(20 + deg), B, T, LENGTHS)
    want = jhmm.fwbw(ops_j, m_j, ev_j, keep_emissions=True)
    got = hmm.fwbw(ops_t, m_t, ev_t)
    _assert_fwbw_close(got, want)
    for b, L in enumerate(LENGTHS):
        assert (got["beta"][b, max(L - 1, 0):] == 0).all()
        if L:
            assert torch.equal(got["alpha"][b, L:],
                               got["alpha"][b, L - 1:L].expand(T - L, N))


@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_stream_fwbw_custom_matches_jax(deg, per_read):
    """K6e (hmm.fwbw_custom) under a random table against nanocall_tpu's
    fwbw_custom: _assert_custom_close."""
    ops_j, ops_t = _both(_table(deg, 30 + deg, B if per_read else 0))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(40 + deg), B, T, LENGTHS)
    want = jhmm.fwbw_custom_jit(ops_j, m_j, ev_j)
    got = hmm.fwbw_custom(ops_t, m_t, ev_t)
    _assert_custom_close({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})


def _slot_rows(T_: int, deg_from: int, deg_to: int) -> list:
    """The slot rows a block reads, as (side, slot), in its order: each
    forward step the from side's slots twice (the max pass, then the sum
    pass), then each backward step the to side's (common.cuh
    lse_slots)."""
    one = [(0, k) for k in range(deg_from)]
    other = [(1, k) for k in range(deg_to)]
    return (one * 2) * (T_ - 1) + (other * 2) * (T_ - 1)


def _model_lse(walk, deg, x, ops, side, b):
    """lse_slots over the next 2 deg slot rows of the walk: the max pass,
    then the sum pass, for read b; x (n,) the gathered vector.  Returns
    (n,)."""
    idx_t, lp_t = ((ops.from_idx, ops.from_logp) if side == 0
                   else (ops.to_idx, ops.to_logp))
    lp_t = lp_t if lp_t.dim() == 2 else lp_t[b]
    m = None
    for k in range(deg):
        assert next(walk) == (side, k)
        v = lp_t[k] + x[idx_t[k].long()]
        m = v if m is None else torch.where((v > m) | torch.isnan(v), v, m)
    finite = torch.isfinite(m)
    safe = torch.where(finite, m, 0.0)
    s = None
    for k in range(deg):
        assert next(walk) == (side, k)
        e = torch.exp((lp_t[k] + x[idx_t[k].long()]) - safe)
        s = e if s is None else s + e
    return torch.where(finite, safe + torch.log(s), m)


def _block_model(ops, model, ev, custom):
    """The streaming K6c (custom: K6e) as its blocks run it, one read a
    block: every step's slot loop over the walk of slot rows
    (_slot_rows), every step run, a read past its end keeping its alpha /
    beta or zeroing its beta.  Returns the plain version's outputs."""
    n = model.level_mean.shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    B_, T_ = mean.shape
    deg_from, deg_to = ops.from_idx.shape[0], ops.to_idx.shape[0]
    keys = ("alpha", "beta", "gamma") if custom else ("alpha", "beta", "em")
    out = {k: torch.empty((B_, T_, n)) for k in keys}
    if not custom:
        out["log_pr_data"] = torch.empty(B_)
    for b in range(B_):
        m = hmm.ModelArrays(*(x[b] for x in model))
        length = int(ev["length"][b])
        em = [hmm.log_emission(m, mean[b, t], stdv[b, t], log_stdv[b, t])
              for t in range(T_)]
        walk = iter(_slot_rows(T_, deg_from, deg_to))
        if custom:
            alpha = torch.full((n,), -math.log(n), dtype=torch.float32)
            beta = hmm.log_normalize(em[0] + alpha)
            al, be = [alpha], [beta]
            for t in range(1, T_):
                alpha = _model_lse(walk, deg_from, beta, ops, 0, b)
                if t < length:
                    beta = hmm.log_normalize(em[t] + alpha)
                al.append(alpha)
                be.append(beta)
            gamma = [None] * T_
            gamma[T_ - 1] = beta
            for t in range(T_ - 2, -1, -1):
                g = gamma[t + 1] - al[t + 1]
                cand = be[t] + _model_lse(walk, deg_to, g, ops, 1, b)
                gamma[t] = be[t] if t >= length - 1 else cand
            seqs = {"alpha": al, "beta": be, "gamma": gamma}
        else:
            alpha = em[0] - math.log(n)
            al = [alpha]
            for t in range(1, T_):
                r = _model_lse(walk, deg_from, alpha, ops, 0, b)
                if t < length:
                    alpha = em[t] + r
                al.append(alpha)
            mfin = torch.amax(alpha)
            out["log_pr_data"][b] = mfin + torch.log(hmm.tree_sum(
                torch.exp(alpha - mfin)))
            beta = torch.zeros(n)
            be = [None] * T_
            be[T_ - 1] = beta
            for t in range(T_ - 2, -1, -1):
                r = _model_lse(walk, deg_to, em[t + 1] + beta, ops, 1, b)
                beta = torch.zeros(n) if t >= length - 1 else r
                be[t] = beta
            seqs = {"alpha": al, "beta": be, "em": em}
        assert next(walk, None) is None
        for k, seq in seqs.items():
            out[k][b] = torch.stack(seq)
    return out


def _bits_or_nan(got, want, what):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


@pytest.mark.parametrize("custom", [False, True], ids=["K6c", "K6e"])
@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_tile_order_model_bit_equal_to_plain(deg, per_read, custom):
    """The model of the streaming bodies' order of slot rows
    (_block_model) over B = 5 reads of lengths 0, 1, 2, T - 1 and T, on
    clean events and on events with a NaN from the middle of the read of
    length T on: bit-equal to fwbw_plain (custom: fwbw_custom_plain), NaN
    where they are NaN."""
    _, ops = _both(_table(deg, 50 + deg, B if per_read else 0))
    (_, _, _), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(60 + deg), B, T, LENGTHS)
    ev_nan = {k: v.clone() for k, v in ev_t.items()}
    ev_nan["mean"][0, T // 2:] = float("nan")
    plain = hmm.fwbw_custom_plain if custom else hmm.fwbw_plain
    for e, what in ((ev_t, "clean"), (ev_nan, "NaN")):
        want = plain(ops, m_t, e)
        if what == "NaN":
            assert torch.isnan(want["alpha"][0]).any()
        got = _block_model(ops, m_t, e, custom)
        for k in want:
            _bits_or_nan(got[k], want[k], f"{k} {what}")
