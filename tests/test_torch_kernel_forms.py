"""The plain-torch forms behind K1's, K4's and K5's designs for the H100
(csrc/viterbi_forward.cu, csrc/fwbw_forward.cu, csrc/em_backward.cu),
checked on the CPU:

- K5's transition codebooks (hmm.bwd_codebooks) rebuild the three
  backward tables bit for bit;
- K5's sum16, continued from sum4 by a chain through 4 threads, is
  hmm.block_sum(G, 16) bit for bit;
- K1's column maxima m16 / g16 composed from m4 / g4 equal the serial
  16-row order, and where a NaN could hide values the kernel's warp vote
  routes the columns to the serial order;
- K1's tie rule as one minimum of integer keys, its thread layout and
  padded shared-memory slots;
- K4's column sums on K1's layout: S4 over a thread's own registers and
  S16 gathered by shuffles in increasing row order are hmm.strided_sum's
  float sequences bit for bit (NaN and +-inf entries included), and its
  padded column arrays are free of bank conflicts;
- K2's end argmax (csrc/viterbi_traceback.cu): 4 states a thread, the
  warp's shuffle-down tree, then the 32 warps, by the rule that counts a
  NaN above every number and breaks ties to the lower index, is
  torch.argmax / torch.amax (value as bits) under NaN, +-inf and ties.
"""

import numpy as np
import pytest
import torch

from nanocall_tpu_torch import transitions
from nanocall_tpu_torch.ops import hmm

N = 4096


@pytest.mark.parametrize("seed", [0, 1, 2, "priors"])
def test_bwd_codebooks_rebuild_the_tables_bitwise(seed):
    """codebooks[:, q, pattern] == bwd_exp_tables' table q, bit for bit,
    over seeded random (p_stay, p_skip) rows or the CLI priors (0.1, 0.3);
    27 patterns at K = 6, fixed by the overlap conditions."""
    if seed == "priors":
        ps, pk = np.full(4, 0.1, np.float32), np.full(4, 0.3, np.float32)
    else:
        rng = np.random.default_rng(seed)
        ps = rng.uniform(0.001, 0.6, 64).astype(np.float32)
        pk = rng.uniform(0.001, 0.39, 64).astype(np.float32)
    gtf = hmm.make_grouped_full_device(torch.from_numpy(ps),
                                       torch.from_numpy(pk), 6)
    pattern, books = hmm.bwd_codebooks(gtf)
    assert pattern.dtype == torch.uint8 and int(pattern.max()) == 26
    assert books.shape == (len(ps), 3, hmm.BWD_CODES)
    assert torch.all(books[:, :, 27:] == 0)
    for q, table in enumerate(hmm.bwd_exp_tables(gtf)):
        got = books[:, q, pattern.long()]
        assert torch.equal(got.view(torch.int32), table.view(torch.int32)), q
    # the pattern is the states' overlap conditions, and nothing else
    m = transitions.grouped_condition_masks(6)
    mt = transitions.grouped_condition_masks_to(6)
    cols = np.stack([m[f"stay_l{l}"] for l in range(1, 6)]
                    + list(mt.values()), 1)
    pat = pattern.numpy()
    for p in range(27):
        assert (cols[pat == p] == cols[pat == p][0]).all()


def _sum16_chain(G: torch.Tensor) -> torch.Tensor:
    """K5's sum16: thread 4c's sum4 = ((G0 + G1) + G2) + G3, then threads
    4c+1 .. 4c+3 in turn add their 4 states one by one to the sum passed
    up to them."""
    g = G.view(G.shape[0], N // 16, 4, 4)  # (B, block, thread, state)
    s = ((g[..., 0, 0] + g[..., 0, 1]) + g[..., 0, 2]) + g[..., 0, 3]
    for k in range(1, 4):
        s = (((s + g[..., k, 0]) + g[..., k, 1]) + g[..., k, 2]) + g[..., k, 3]
    return s


def _k6d_g(seed: int = 3) -> torch.Tensor:
    """g = em(t+1) + beta of fwbw_grouped_backward_plain (K6d's plain
    version) at every step of 4 random reads of 6 events: the values whose
    exp(g - m) K6d sums by K5's chain (csrc/beta_step.cuh)."""
    rng = np.random.default_rng(seed)
    B, T = 4, 6
    model = hmm.make_model_arrays(*(torch.from_numpy(
        rng.uniform(lo, hi, N).astype(np.float32)) for lo, hi in (
            (60.0, 120.0), (1.0, 3.0), (0.5, 2.0), (0.5, 2.0))), B=B)
    stdv = torch.from_numpy(rng.uniform(0.6, 1.8, (B, T)).astype(np.float32))
    ev = {"mean": torch.from_numpy(rng.uniform(60.0, 120.0, (B, T)).astype(
              np.float32)),
          "stdv": stdv, "log_stdv": torch.log(stdv),
          "length": torch.full((B,), T, dtype=torch.int32)}
    gtf = hmm.make_grouped_full_device(
        torch.from_numpy(rng.uniform(0.05, 0.2, B).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.2, 0.4, B).astype(np.float32)), 6)
    betas = hmm.fwbw_grouped_backward_plain(gtf, model, ev)
    return torch.cat([hmm.log_emission(model, ev["mean"][:, t + 1],
                                       ev["stdv"][:, t + 1],
                                       ev["log_stdv"][:, t + 1])
                      + betas[:, t + 1] for t in range(T - 1)])


@pytest.mark.parametrize("seed", [0, 1, "k6d"])
def test_sum16_chain_equals_block_sum_bitwise(seed):
    """The chain through 4 threads is block_sum(G, 16)'s float sequence,
    and its first link is block_sum(G, 4), on exp(g - max g) of seeded
    random g of a wide range (tiny and large terms mixed), and ("k6d") of
    K6d's own g, which takes the same chain since K6d runs K5's step."""
    if seed == "k6d":
        g = _k6d_g()
    else:
        rng = np.random.default_rng(seed)
        g = torch.from_numpy(rng.normal(0.0, 8.0, (16, N)).astype(
            np.float32))
    G = torch.exp(g - torch.amax(g, dim=-1, keepdim=True))
    want = hmm.block_sum(G, 16)
    assert torch.equal(_sum16_chain(G).view(torch.int32),
                       want.view(torch.int32))
    s4 = ((G[:, 0::4] + G[:, 1::4]) + G[:, 2::4]) + G[:, 3::4]
    assert torch.equal(s4.view(torch.int32),
                       hmm.block_sum(G, 4).view(torch.int32))


def _colmax_serial(a: torch.Tensor):
    """(B, R, m) -> max, first argmax over R (strict > in r): the plain
    version's order (hmm._grouped_step_core's colmax)."""
    m = a[:, 0]
    g = torch.zeros_like(m, dtype=torch.int64)
    for r in range(1, a.shape[1]):
        take = a[:, r] > m
        m = torch.where(take, a[:, r], m)
        g = torch.where(take, r, g)
    return m, g


def _m16_composed(alpha: torch.Tensor):
    """K1's m16 / g16 from m4 / g4: over q < 4, the max of m4[256 q + c]
    and the lowest r = q + 4 g4 among the q that reach it."""
    m4, g4 = _colmax_serial(alpha.view(-1, 4, N // 4))
    m = m4.view(-1, 4, N // 16)
    r = torch.arange(4)[None, :, None] + 4 * g4.view(-1, 4, N // 16)
    M, R = m[:, 0], r[:, 0]
    for q in range(1, 4):
        take = (m[:, q] > M) | ((m[:, q] == M) & (r[:, q] < R))
        M = torch.where(take, m[:, q], M)
        R = torch.where(take, r[:, q], R)
    return M, R


def _warp_nan_vote(alpha: torch.Tensor) -> torch.Tensor:
    """(B, 256): True for the m16 columns of a warp that holds a NaN in
    alpha; warp w owns columns c16 = 8 w + k (k < 8) of every row r < 16."""
    nan = torch.isnan(alpha).view(-1, 16, 32, 8)  # (B, r, warp, k)
    return nan.any(dim=3).any(dim=1).repeat_interleave(8, dim=1)


def _m16_kernel(alpha: torch.Tensor):
    """K1's m16 / g16: composed, or the serial order in a flagged warp."""
    M, R = _m16_composed(alpha)
    Ms, Rs = _colmax_serial(alpha.view(-1, 16, N // 16))
    vote = _warp_nan_vote(alpha)
    return torch.where(vote, Ms, M), torch.where(vote, Rs, R)


def _same(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_composed_column_max_equals_the_serial_order(seed):
    """On seeded random alphas with forced ties (values on a coarse grid,
    -inf and +inf among them), m16 / g16 composed from m4 / g4 equal the
    serial 16-row order bit for bit."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-6, 3, (32, N)).astype(np.float32)
    a[rng.random((32, N)) < 0.02] = -np.inf
    a[rng.random((32, N)) < 0.002] = np.inf
    a[0] = -np.inf  # a row of ties only
    alpha = torch.from_numpy(a)
    Ms, Rs = _colmax_serial(alpha.view(-1, 16, N // 16))
    M, R = _m16_composed(alpha)
    assert _same(M, Ms) and torch.equal(R, Rs)


@pytest.mark.parametrize("seed", [0, 1])
def test_nan_columns_take_the_serial_order(seed):
    """Rows with NaN at several positions (row 0 of a column, later rows,
    everywhere): the composed max alone differs from the serial order
    where a NaN at r > 0 of a column lies in front of larger values, and
    the kernel's warp vote, which sends every warp holding a NaN to the
    serial order, keeps the serial order's bits everywhere."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-6, 3, (8, N)).astype(np.float32)
    alpha = torch.from_numpy(a)
    for b, states in enumerate(([5], [1024 + 7, 3 * 1024 + 300],
                                [256 + 9], list(range(0, N, 97)),
                                list(range(N)))):
        alpha[b, states] = float("nan")
    # the composed max alone is wrong behind a NaN at r = 1 of m16 column 9
    # (state 256 + 9, row 0 of m4 column 265): it hides that m4 column's
    # later rows, among them the max, row 5 of column 9 (state 5 * 256 + 9)
    alpha[2, 5 * 256 + 9] = 10.0
    Ms, Rs = _colmax_serial(alpha.view(-1, 16, N // 16))
    M, R = _m16_composed(alpha)
    assert not (_same(M, Ms) and torch.equal(R, Rs))
    Mk, Rk = _m16_kernel(alpha)
    assert _same(Mk, Ms) and torch.equal(Rk, Rs)
    # the rows without NaN (5..7) never take the serial order
    assert not _warp_nan_vote(alpha[5:]).any()


def _bp_by_keys(gt: hmm.GroupedTrans, alpha: torch.Tensor):
    """K1's tie rule as one integer minimum: key = (from-state << 8) | bp
    code per candidate (0x7fffff00 where its value is not the best), the
    least key's low byte the bp.  Returns (best, bp uint8)."""
    B, n = alpha.shape
    m4, g4 = _colmax_serial(alpha.view(B, 4, n // 4))
    m16, g16 = _colmax_serial(alpha.view(B, 16, n // 16))
    j = torch.arange(n)
    r4 = g4[:, j >> 2]
    r16 = g16[:, j >> 4]
    v0 = gt.stay_lp + alpha
    v1 = gt.step_lp + m4[:, j >> 2]
    v2 = gt.skip_lp + m16[:, j >> 4]
    best = torch.maximum(torch.maximum(v0, v1), v2)
    nokey = 0x7FFFFF00
    k0 = torch.where(v0 == best, j << 8, nokey)
    k1 = torch.where(v1 == best, (((r4 << 10) | (j >> 2)) << 8) | (64 + r4),
                     nokey)
    k2 = torch.where(v2 == best, (((r16 << 8) | (j >> 4)) << 8) | (128 + r16),
                     nokey)
    key = torch.minimum(torch.minimum(k0, k1), k2)
    return best, (key & 0xFF).to(torch.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_key_tie_rule_equals_the_plain_bps(seed):
    """The key minimum gives _grouped_step_core's bp bytes and best scores
    bit for bit, on alphas and tables of a coarse grid (many ties between
    stay, step and skip and between rows), with -inf, NaN table entries
    and NaN alphas at a few states."""
    rng = np.random.default_rng(seed)
    B = 8
    alpha = torch.from_numpy(rng.integers(-4, 1, (B, N)).astype(np.float32))
    tabs = [torch.from_numpy(rng.integers(-2, 1, (B, N)).astype(np.float32))
            for _ in range(3)]
    alpha[0, rng.integers(0, N, 40)] = -np.inf
    alpha[1, rng.integers(0, N, 5)] = np.nan
    tabs[0][2, rng.integers(0, N, 5)] = np.nan
    tabs[1][3, rng.integers(0, N, 5)] = np.nan
    tabs[2][4, rng.integers(0, N, 5)] = -np.inf
    gt = hmm.GroupedTrans(*tabs, K=6)
    want_best, want_bp = hmm._grouped_step_core(gt, alpha)
    best, bp = _bp_by_keys(gt, alpha)
    assert _same(best, want_best)
    assert torch.equal(bp, want_bp)


def test_k1_thread_layout_and_padded_slots():
    """K1's thread layout (warp w, lane 8 q + k owns column c = 256 q +
    8 w + k and states 1024 r + c) covers every state once; the padded
    slots of m4 (i + 2 (i >> 6)) and m16 (i + (i >> 4)) are distinct and
    those of state 1024 r + c are its column's plus r times a constant
    (264, 68); each warp's reads of its states' m4 and m16 slots (8-byte
    entries, per half-warp) and its staged bp words (4-byte, per warp) hit
    distinct banks."""
    w, lane = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    q, k = lane >> 3, lane & 7
    c = 256 * q + 8 * w + k
    states = np.concatenate([(1024 * r + c).ravel() for r in range(4)])
    assert np.array_equal(np.sort(states), np.arange(N))

    def p4(i):
        return i + 2 * (i >> 6)

    def p16(i):
        return i + (i >> 4)

    assert len(set(p4(np.arange(1024)))) == 1024
    assert len(set(p16(np.arange(256)))) == 256
    for r in range(4):
        j = 1024 * r + c  # (warp, lane)
        assert np.array_equal(p4(j >> 2), p4(c >> 2) + 264 * r)
        assert np.array_equal(p16(j >> 4), p16(c >> 4) + 68 * r)
        for slots in (p4(j >> 2), p16(j >> 4)):
            for half in (slice(0, 16), slice(16, 32)):
                for wi in range(32):
                    s = np.unique(slots[wi, half])
                    assert len(np.unique(s % 16)) == len(s), (r, wi)
        for wi in range(32):
            s = np.unique(p4(j >> 2)[wi])
            assert len(np.unique(s % 32)) == len(s), (r, wi)


def _k4_columns(E: torch.Tensor):
    """K4's S4 and S16 on K1's layout: lane 8q + k of warp w holds, in its
    register r, E[1024 r + 256 q + 8 w + k].  S4 of column c = 256 q + 8 w
    + k adds the thread's own registers in r order; S16 of column c16 =
    8 w + k takes row r16 = 4 r + q' from register r of lane 8 q' + k (a
    shuffle) and adds the rows in increasing r16 order.  Returns (S4 (B,
    1024) by c, S16 (B, 256) by c16)."""
    B = E.shape[0]
    reg = E.view(B, 4, 4, 32, 8)  # (B, r, q, w, k)
    s4 = ((reg[:, 0] + reg[:, 1]) + reg[:, 2]) + reg[:, 3]  # (B, q, w, k)
    s16 = reg[:, 0, 0]  # row r16 = 0 of column 8 w + k: (B, w, k)
    for r16 in range(1, 16):
        s16 = s16 + reg[:, r16 >> 2, r16 & 3]
    return s4.reshape(B, N // 4), s16.reshape(B, N // 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_column_sums_equal_strided_sum_bitwise(seed):
    """K4's S4 and S16 in the column layout are hmm.strided_sum(E, 4) and
    hmm.strided_sum(E, 16) bit for bit, on exp(a - max a) of seeded random
    a of a wide range and on rows with NaN, +inf and -inf entries."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(0.0, 8.0, (8, N)).astype(np.float32))
    E = torch.exp(a - torch.amax(a, dim=-1, keepdim=True))
    E[1, rng.integers(0, N, 7)] = np.nan
    E[2, rng.integers(0, N, 5)] = np.inf
    E[3, rng.integers(0, N, 5)] = -np.inf
    E[4, rng.integers(0, N, 3)] = np.inf
    E[4, rng.integers(0, N, 3)] = -np.inf
    E[5] = np.nan
    s4, s16 = _k4_columns(E)
    for got, r in ((s4, 4), (s16, 16)):
        want = hmm.strided_sum(E, r)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), r


def test_k4_padded_columns_free_of_bank_conflicts():
    """K4's S4 and S16 arrays (4-byte words, K1's p4 and p16 padding):
    each warp's writes (S4 at its column c, S16 at c16 from the lanes
    q = 0) and its reads of its states' columns (j >> 2, j >> 4 for
    j = 1024 r + c) hit distinct banks, or one word that several lanes
    read; the slots are distinct and state 1024 r + c reads its column's
    plus r times 264 and 68."""
    w, lane = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    q, k = lane >> 3, lane & 7
    c16 = 8 * w + k
    c = 256 * q + c16

    def p4(i):
        return i + 2 * (i >> 6)

    def p16(i):
        return i + (i >> 4)

    assert len(set(p4(np.arange(1024)))) == 1024
    assert len(set(p16(np.arange(256)))) == 256

    def conflict_free(slots):
        words = np.unique(slots)
        return len(np.unique(words % 32)) == len(words)

    for wi in range(32):
        assert conflict_free(p4(c[wi]))
        assert conflict_free(p16(c16[wi][q[wi] == 0]))
        for r in range(4):
            j = 1024 * r + c[wi]
            assert conflict_free(p4(j >> 2)) and conflict_free(p16(j >> 4))
            assert np.array_equal(p4(j >> 2), p4(c[wi] >> 2) + 264 * r)
            assert np.array_equal(p16(j >> 4), p16(c[wi] >> 4) + 68 * r)


def _take_better(best, idx, ob, oi):
    """common.cuh's take_better (K6b's rule, K2's too) on tensors: the
    better of (best, idx) and (ob, oi), a NaN above every number, ties to
    the lower index."""
    o_nan, b_nan = torch.isnan(ob), torch.isnan(best)
    take = torch.where(o_nan | b_nan, o_nan & (~b_nan | (oi < idx)),
                       (ob > best) | ((ob == best) & (oi < idx)))
    return torch.where(take, ob, best), torch.where(take, oi, idx)


def _take_better_dropping_nan(best, idx, ob, oi):
    """A rule by `ob > best` alone, which never takes a NaN."""
    take = (ob > best) | ((ob == best) & (oi < idx))
    return torch.where(take, ob, best), torch.where(take, oi, idx)


def _shfl_down_tree(best, idx, rule):
    """The 32-lane shuffle-down tree over the last dim: at offset 16, 8, ..
    1 lane l takes lane l + off, or keeps its own value past lane 31 (what
    __shfl_down_sync returns there); lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        ob = torch.cat([best[..., off:], best[..., 32 - off:]], -1)
        oi = torch.cat([idx[..., off:], idx[..., 32 - off:]], -1)
        best, idx = rule(best, idx, ob, oi)
    return best[..., 0], idx[..., 0]


def _k2_end_argmax(fa: torch.Tensor, rule=_take_better):
    """K2's and K6b's end reduction (common.cuh end_argmax_partials, then
    end_argmax) in the kernels' order: thread t's states 4t .. 4t+3 in
    turn, the shuffle tree of each warp (threads 32 w .. 32 w + 31), then
    the tree over the 32 warps' results.  Returns (best, idx)."""
    B = fa.shape[0]
    v = fa.view(B, 1024, 4)
    i = torch.arange(N, dtype=torch.int64).view(1, 1024, 4).expand(B, -1, -1)
    best, idx = v[..., 0], i[..., 0]
    for k in range(1, 4):
        best, idx = rule(best, idx, v[..., k], i[..., k])
    best, idx = _shfl_down_tree(best.view(B, 32, 32), idx.view(B, 32, 32),
                                rule)
    return _shfl_down_tree(best, idx, rule)


def _end_alpha(case: str, rng) -> torch.Tensor:
    """Rows of final alphas for one case of the K2 argmax test."""
    fa = torch.from_numpy(rng.normal(-5000.0, 50.0, (6, N)).astype(
        np.float32))
    nan, inf = float("nan"), float("inf")
    if case == "nan_at_0":
        fa[:, 0] = nan
    elif case == "nan_middle":
        fa[:, 1234] = nan
        fa[:, 3801] = -1.0  # the largest number, above the NaN's index
    elif case == "nan_several":
        for r in range(6):
            fa[r, rng.choice(N, 2 + r, replace=False)] = nan
    elif case == "all_nan":
        fa[:] = nan
    elif case == "pm_inf":
        fa[0, 77] = inf
        fa[1, [5, 4000]] = inf
        fa[2] = -inf
        fa[3, :2048] = -inf
        fa[4, 3000] = inf
        fa[4, 2999] = nan
        fa[5, rng.choice(N, 100, replace=False)] = -inf
    elif case == "ties":
        for r in range(6):
            fa[r, rng.choice(N, 3 + r, replace=False)] = -7.5
        fa[5, :] = -7.5
    return fa


@pytest.mark.parametrize("case", ["random", "nan_at_0", "nan_middle",
                                  "nan_several", "all_nan", "pm_inf",
                                  "ties"])
def test_k2_end_argmax_equals_torch_argmax(case):
    """K2's end state and logp, reduced in the kernel's order by its rule,
    equal torch.argmax's index and torch.amax's value (as bits) on rows
    with a NaN at state 0, at a middle state below a larger number, at
    several states, at every state, with +-inf (an +inf beside a NaN, rows
    of -inf), and with ties (first index wins)."""
    fa = _end_alpha(case, np.random.default_rng(7))
    best, idx = _k2_end_argmax(fa)
    assert torch.equal(idx, torch.argmax(fa, dim=-1)), case
    assert torch.equal(best.view(torch.int32),
                       torch.amax(fa, dim=-1).view(torch.int32)), case
    if case == "nan_middle":
        # a rule by `>` alone drops that NaN: state 3801, logp -1
        best, idx = _k2_end_argmax(fa, _take_better_dropping_nan)
        assert torch.all(idx == 3801) and torch.all(best == -1.0)
