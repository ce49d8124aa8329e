"""The one-card split of the streaming K6c and K6e (csrc/fwbw_split.cu: a
read's 4096 states cut over a thread block cluster of C blocks, S states
a thread), on the CPU: its plain versions (hmm.fwbw_split_plain and
hmm.fwbw_custom_split_plain, the arithmetic of the kernels in each form)
bit-equal to fwbw_plain and fwbw_custom_plain under seeded random tables
of 1, 21 and 40 slots that pack_fwbw_sides refuses, one table and per
read, at C = 2, 4, 8 and S = 1, 2, 4, over reads of lengths T, 0, 1, 2 and
T - 1 beside reads with NaN events, a +inf event and a NaN model entry;
against nanocall_tpu's fwbw and fwbw_custom; and the route
(hmm.fwbw_stream_split).

Tolerances: against the plain versions bit-equal, NaN where they are NaN
(test_torch_fwbw_stream._bits_or_nan); against JAX those of
tests/test_torch_fwbw_stream.py's header: K6c's alpha and beta within rtol
1e-5 where a state's weight is above e^-80, em within rtol 1e-5 or atol
5e-4, log Pr[data] within rtol 1e-6 (test_torch_trans._assert_fwbw_close);
K6e's alpha, beta and gamma within rtol 1e-5, atol 1e-3
(test_torch_tools._assert_custom_close).
"""

import numpy as np
import pytest
import torch

from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch.ops import hmm
from test_torch_fwbw_stream import DEGS, _both, _table, _bits_or_nan
from test_torch_tools import _assert_custom_close
from test_torch_train import _rows
from test_torch_trans import _assert_fwbw_close
from torch_helpers import one_torch_thread  # noqa: F401

#: B reads x T events: lengths T, 0, 1, 2, T - 1, then three reads of
#: length T with NaN events from the middle on, a +inf event and a NaN
#: model entry
B, T = 8, 9
LENGTHS = [T, 0, 1, 2, T - 1, T, T, T]
CUTS = (2, 4, 8)
STATES = (1, 2, 4)

_cache: dict = {}


def _inputs(deg: int, per_read: bool):
    """The port's table, model and events of a case (NaN rows 5 to 7), and
    the plain versions' outputs on them, computed once a case."""
    key = (deg, per_read)
    if key not in _cache:
        _, ops = _both(_table(deg, 70 + deg, B if per_read else 0))
        (_, _, _), (_, m, ev), _ = _rows(
            6, np.random.default_rng(80 + deg), B, T, LENGTHS)
        m = hmm.ModelArrays(*(x.clone() for x in m))
        ev = {k: v.clone() for k, v in ev.items()}
        ev["mean"][5, T // 2:] = float("nan")
        ev["mean"][6, 3] = float("inf")
        m.level_mean[7, 1234] = float("nan")
        _cache[key] = (ops, m, ev, hmm.fwbw_plain(ops, m, ev),
                       hmm.fwbw_custom_plain(ops, m, ev))
    return _cache[key]


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("C", CUTS)
@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_split_plain_bit_equal_to_fwbw_plain(deg, per_read, C, S):
    """K6c over C cuts (fwbw_generic_wave_plain's steps, log Pr[data] from
    the cuts' S subtree sums): alpha, beta, em and log Pr[data] bit-equal
    to fwbw_plain, NaN where it is NaN (the rows of NaN and +inf events
    and of the NaN model entry included)."""
    ops, m, ev, want, _ = _inputs(deg, per_read)
    assert torch.isnan(want["alpha"][5]).any()
    assert torch.isnan(want["alpha"][7]).any()
    got = hmm.fwbw_split_plain(ops, m, ev, C, S)
    for k in want:
        _bits_or_nan(got[k], want[k], k)


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("C", CUTS)
@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_custom_split_plain_bit_equal_to_fwbw_custom_plain(deg, per_read, C,
                                                           S):
    """K6e with each step's normalisation folded over C cuts and the
    gathered beta formed from the exchanged column and its normaliser:
    alpha, beta and gamma bit-equal to fwbw_custom_plain, NaN where it is
    NaN."""
    ops, m, ev, _, want = _inputs(deg, per_read)
    assert torch.isnan(want["gamma"][5]).any()
    assert torch.isnan(want["beta"][7]).all()
    got = hmm.fwbw_custom_split_plain(ops, m, ev, C, S)
    for k in want:
        _bits_or_nan(got[k], want[k], k)


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("C", CUTS)
def test_split_sum_and_normalizer_are_tree_sum_and_log_normalize(C, S):
    """The split's sum (C cuts' S subtrees, pairwise) is tree_sum bit for
    bit, and x minus its normaliser is log_normalize(x), also with -inf,
    +inf and NaN entries."""
    rng = np.random.default_rng(C * 10 + S)
    x = torch.from_numpy(rng.normal(-40.0, 20.0, (6, 4096)).astype(
        np.float32))
    x[1, 17] = float("-inf")
    x[2, :] = float("-inf")
    x[3, 4000] = float("inf")
    x[4, 5] = float("nan")
    e = torch.exp(x[0:1] - x[0:1].max())
    assert torch.equal(hmm.split_sum(e, C, S).view(torch.int32),
                       hmm.tree_sum(e).view(torch.int32))
    got = x - hmm.split_normalizer(x, C, S)[:, None]
    _bits_or_nan(got, hmm.log_normalize(x), "normalised")


@pytest.mark.parametrize("custom", [False, True], ids=["K6c", "K6e"])
@pytest.mark.parametrize("per_read", [False, True], ids=["one", "per_read"])
@pytest.mark.parametrize("deg", DEGS)
def test_split_plain_matches_jax(deg, per_read, custom):
    """The split's plain versions at (C, S) = (8, 1) and (2, 4) against
    nanocall_tpu's fwbw (keep_emissions) and fwbw_custom on clean inputs:
    the tolerances of the header."""
    ops_j, ops_t = _both(_table(deg, 90 + deg, B if per_read else 0))
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(
        6, np.random.default_rng(100 + deg), B, T, LENGTHS)
    if custom:
        want = {k: np.asarray(v) for k, v in
                jhmm.fwbw_custom_jit(ops_j, m_j, ev_j).items()}
    else:
        want = jhmm.fwbw(ops_j, m_j, ev_j, keep_emissions=True)
    for C, S in ((8, 1), (2, 4)):
        if custom:
            got = hmm.fwbw_custom_split_plain(ops_t, m_t, ev_t, C, S)
            _assert_custom_close({k: v.numpy() for k, v in got.items()},
                                 want)
        else:
            _assert_fwbw_close(hmm.fwbw_split_plain(ops_t, m_t, ev_t, C, S),
                               want)


@pytest.mark.parametrize("B", [1, 2, 16, 48, 49, 96, 512, 5000])
def test_stream_split_route_choices(B):
    """fwbw_stream_split's choice, as its timings chose it: one state a
    thread up to FWBW_SPLIT_FEW_READS reads, two above; both forms of
    FWBW_SPLIT_STATES, C = 8 blocks a read."""
    assert hmm.FWBW_SPLIT_CUTS == 8 and hmm.FWBW_SPLIT_STATES == (1, 2)
    assert hmm.fwbw_stream_split(B) == (1 if B <= 48 else 2)


@pytest.mark.parametrize("custom", [False, True], ids=["K6c", "K6e"])
def test_split_wrappers_refuse_cpu_tensors_and_bad_forms(custom):
    """The streaming wrappers check their inputs (CUDA tensors) and refuse
    a form outside FWBW_SPLIT_STATES; the per-read wrappers refuse one
    table; nothing is counted."""
    ops, m, ev, _, _ = _inputs(21, False)
    one, per = ((hmm.fwbw_custom_kernel, hmm.fwbw_custom_per_read_kernel)
                if custom else
                (hmm.fwbw_generic_kernel, hmm.fwbw_generic_per_read_kernel))
    n0 = one.launches, per.launches
    for S in (None, *hmm.FWBW_SPLIT_STATES):
        with pytest.raises(ValueError, match="CUDA tensors"):
            one(ops, m, ev, S)
    for S in (0, 4):
        with pytest.raises(ValueError, match="states a thread"):
            one(ops, m, ev, S)
    with pytest.raises(ValueError, match="per-read"):
        per(ops, m, ev)
    assert (one.launches, per.launches) == n0
