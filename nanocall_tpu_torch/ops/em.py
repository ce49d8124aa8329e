"""K5: the EM E-step's fused backward pass with both M-steps' sufficient
statistics (nanocall_tpu/train.py:159-320, `_fused_bwd_mstats`).

The reverse recursion keeps beta on chip and never stores it, recomputes
each emission, and folds the posteriors into 14 scaling moments and 3
log-space transition totals per row.  The plain PyTorch version runs on
CPU tensors; CUDA tensors go to the kernel of csrc/em_backward.cu.  K4, the
forward half whose alphas this pass reads, is in ops/hmm.py.  The kernel
reads the three transition tables as per-row codebooks over the states'
overlap-condition patterns (hmm.bwd_codebooks).

K5m (em_backward_wave_kernel vs em_backward_wave_plain) is K5 with the
states split over the ranks of a data row (parallel/statepar.py drives
it after K4m): each step the ranks exchange their partial maxima and the
sums of their own blocks of 4 and 16 states, each rank's statistics are
subtrees of K5's pairwise sums, and the row's first rank folds the ranks'
per-step partials.  K6dm (fwbw_backward_wave_kernel vs
fwbw_backward_wave_plain) is K6d, the grouped backward with its betas
stored, split so (the legacy EM round's rows off the priors): a kernel of
its own on K6d's beta step, its two exchanges a step pushed into every
rank's shared memory on the cluster path.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..pore_model import LOG_2PI
from . import _cuda, hmm

#: the 14 per-row scaling moments K5 returns, in column order
SCAL_NAMES = ("A00", "A01", "A11", "A02", "A12", "A22", "B0", "B1", "B2",
              "D", "Vn", "Vd", "Up", "Ne")
#: the 3 per-row log-space transition totals K5 returns, in column order
ST_NAMES = ("denom", "stay", "skip")
#: bits of the backward kernel's per-state flag byte: K6d's, and the
#: transition-training subset
BWD_FLAG_BITS = {**hmm.GROUPED_BWD_FLAG_BITS, "subset": 3}

_NEG_INF = float("-inf")


def _bwd_tables(gtf: hmm.GroupedTransFull, p_stay_seq, p_skip_seq):
    """The backward pass's derived inputs, made by the same torch ops for
    the plain version and the kernel: exp of the stay and to-side tables,
    and the per-row log rates log p_stay and log(p_step / 4)."""
    return (*hmm.bwd_exp_tables(gtf), *_log_rates(p_stay_seq, p_skip_seq))


def _log_rates(p_stay_seq, p_skip_seq):
    """The per-row log p_stay and log(p_step / 4)."""
    return (torch.log(p_stay_seq),
            torch.log(1.0 - p_stay_seq - p_skip_seq) - math.log(4.0))


def _post_stats(post, W, x, ts, y, w):
    """Scaling-M-step contributions of one event (hpp:265-296): post (B, n)
    contracted with W (B, 6, n), folded against the uncorrected mean x,
    the start ts and the stdv y into the 14 moments of SCAL_NAMES."""
    return _moments(hmm.tree_sum(post[:, None, :] * W), x, ts, y, w)


def _moments(sums, x, ts, y, w):
    """The 14 moments of SCAL_NAMES from one event's contraction sums
    (B, 6) s0 s1 s2 l0 l1 l2, in _post_stats' op order."""
    s0, s1, s2, l0, l1, l2 = sums.unbind(1)
    cnt = w[:, 0].to(torch.float32)
    return torch.stack([
        s0, s1, s2,
        s0 * ts, s1 * ts,
        s0 * ts * ts,
        s0 * x, s1 * x,
        s0 * x * ts,
        s0 * x * x,
        l2 * y, l1,
        l0 / y,
        cnt,
    ], dim=-1)


def _step_lse(v, w):
    """Per-row log-sum-exp of v (B, 3, n) over the states where w (B, 1, n);
    -inf where w is empty."""
    vm = torch.where(w, v, _NEG_INF)
    mm = torch.amax(vm, dim=-1)
    safe = torch.where(torch.isfinite(mm), mm, 0.0)
    s = hmm.tree_sum(torch.exp(vm - safe[..., None]))
    return torch.where(torch.isfinite(mm), safe + torch.log(s), mm)


def fused_bwd_mstats_plain(gtf: hmm.GroupedTransFull, model: hmm.ModelArrays,
                           ev: dict, lpd, alphas, W, x_unc, t_start, valid,
                           subset, p_stay_seq, p_skip_seq,
                           train_scaling: bool, train_transitions: bool):
    """Plain version of K5 (nanocall_tpu/train.py:159-320), a loop over
    events from T-2 down to 0 in the reverse scan's op order.

    ev: the drift-corrected {mean, stdv, log_stdv, length} rows (B, T);
    lpd (B,) and alphas (T, B, n) from K4; W (B, 6, n) state weights of the
    unscaled models (None without train_scaling); x_unc / t_start (B, T)
    uncorrected means and start times; valid (B,) bool; subset (n,) bool
    transition-training states; p_stay_seq / p_skip_seq (B,) current
    transition parameters.  Returns (scal (B, 14) in SCAL_NAMES order, zero
    without train_scaling; st3 (B, 3) in ST_NAMES order, -inf without
    train_transitions)."""
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    n = model.level_mean.shape[-1]
    dev = mean.device
    m_ = hmm.correction_masks(gtf.K, dev)
    mH, mP2, mS5T = m_["H"], m_["P2mH"], m_["S5T"]
    e_stay, e_step_to, e_skip_to, log_p_stay, log_p_step4 = _bwd_tables(
        gtf, p_stay_seq, p_skip_seq)
    log_p_stay, log_p_step4 = log_p_stay[:, None], log_p_step4[:, None]
    lpd_c = lpd[:, None]
    valid_c = valid[:, None]
    scal = torch.zeros((B, 14), dtype=torch.float32, device=dev)
    st3 = torch.full((B, 3), _NEG_INF, dtype=torch.float32, device=dev)
    if train_scaling:
        # t = T-1: beta = 0, no outgoing transition
        w_last = ((T - 1 < lengths) & valid)[:, None]
        post = torch.exp(alphas[T - 1] - lpd_c) * w_last
        scal = _post_stats(post, W, x_unc[:, T - 1], t_start[:, T - 1],
                           stdv[:, T - 1], w_last)
    beta = torch.zeros((B, n), dtype=torch.float32, device=dev)
    for t in range(T - 2, -1, -1):
        em_next = hmm.log_emission(model, mean[:, t + 1], stdv[:, t + 1],
                                   log_stdv[:, t + 1])
        g = em_next + beta
        m = torch.amax(g, dim=-1, keepdim=True)  # finite, as em and beta are
        G = torch.exp(g - m)
        sum4 = hmm.block_sum(G, 4)
        T4 = sum4.repeat(1, 4)
        T16 = hmm.block_sum(G, 16).repeat(1, 16)
        total = (e_stay * G + e_step_to * (T4 - mH * G)
                 + e_skip_to * (T16 - mP2 * G - mS5T * T4))
        cand = m + torch.log(total)
        beta = torch.where((t >= lengths - 1)[:, None], 0.0, cand)

        alpha_t = alphas[t]
        lp_j1 = alpha_t + beta - lpd_c  # log Pr[S_t = j | data]
        if train_scaling:
            w_t = ((t < lengths) & valid)[:, None]
            scal = scal + _post_stats(torch.exp(lp_j1) * w_t, W, x_unc[:, t],
                                      t_start[:, t], stdv[:, t], w_t)
        if train_transitions:
            # transition i = t (hpp:479-512); the 4-block sums of
            # exp(g - m) are the beta recursion's own sum4
            lp_stay = torch.minimum(alpha_t + log_p_stay + g - lpd_c, lp_j1)
            safe_m = torch.where(torch.isfinite(m), m, 0.0)
            lsum4 = safe_m + torch.log(sum4).repeat(1, 4)
            lp_steps = alpha_t + log_p_step4 + lsum4 - lpd_c
            lp_d01 = torch.minimum(torch.logaddexp(lp_stay, lp_steps), lp_j1)
            p_d2 = torch.clamp_min(torch.exp(lp_j1) - torch.exp(lp_d01), 0.0)
            lp_d2 = torch.log(p_d2)
            w_tr = ((t < lengths - 1)[:, None] & valid_c) & subset[None, :]
            part = _step_lse(torch.stack([lp_j1, lp_stay, lp_d2], dim=1),
                             w_tr[:, None, :])
            st3 = hmm.logaddexp(st3, part)
    return scal, st3


def em_backward_kernel(gtf: hmm.GroupedTransFull, model: hmm.ModelArrays,
                       ev: dict, lpd, alphas, W, x_unc, t_start, valid,
                       subset, p_stay_seq, p_skip_seq, train_scaling: bool,
                       train_transitions: bool):
    """K5 on the card: (scal (B, 14), st3 (B, 3)), as the plain version."""
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    n = 4096
    if gtf.K != 6:
        raise ValueError(f"the CUDA EM backward kernel takes K=6, got "
                         f"K={gtf.K}")
    if T < 1:
        raise ValueError("the backward pass needs at least one event column")
    hmm._check_events(ev, B, T, dev)
    log_p_stay, log_p_step4 = _log_rates(p_stay_seq, p_skip_seq)
    pattern, books = hmm.bwd_codebooks(gtf)
    hmm._check("codebooks", books, torch.float32, (B, 3, hmm.BWD_CODES), dev)
    hmm._check_tables(tuple(model), B, n, dev)
    if train_scaling:
        hmm._check("W", W, torch.float32, (B, 6, n), dev)
        if W.data_ptr() % 16:  # copied to shared memory in 16-byte units
            raise ValueError("W is not 16-byte aligned")
    hmm._check("alphas", alphas, torch.float32, (T, B, n), dev)
    for name, x in (("lpd", lpd), ("log_p_stay", log_p_stay),
                    ("log_p_step4", log_p_step4)):
        hmm._check(name, x, torch.float32, (B,), dev)
    for name, x in (("x_unc", x_unc), ("t_start", t_start)):
        hmm._check(name, x, torch.float32, (B, T), dev)
    hmm._check("valid", valid, torch.bool, (B,), dev)
    hmm._check("subset", subset, torch.bool, (n,), dev)
    hmm._require_cuda(dev, "EM backward")
    masks = {**hmm.correction_masks(6, dev), "subset": subset}
    flags = hmm.mask_flags(masks, BWD_FLAG_BITS)
    red = torch.empty((B, T, 9), dtype=torch.float32, device=dev)
    scal = torch.empty((B, 14), dtype=torch.float32, device=dev)
    st3 = torch.empty((B, 3), dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_em_backward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, books.data_ptr(), pattern.data_ptr(),
        *(x.data_ptr() for x in model),
        W.data_ptr() if train_scaling else None, alphas.data_ptr(),
        lpd.data_ptr(), x_unc.data_ptr(), t_start.data_ptr(),
        valid.data_ptr(), log_p_stay.data_ptr(), log_p_step4.data_ptr(),
        flags.data_ptr(), int(train_scaling), int(train_transitions), LOG_2PI,
        red.data_ptr(), scal.data_ptr(), st3.data_ptr(), *_cuda.target(dev),
    )
    _cuda.check(err, "em_backward kernel launch")
    _cuda.count_launch(em_backward_kernel)
    return scal, st3


em_backward_kernel.launches = 0


def fused_bwd_mstats(gtf, model, ev, lpd, alphas, W, x_unc, t_start, valid,
                     subset, p_stay_seq, p_skip_seq, train_scaling: bool,
                     train_transitions: bool):
    """K5 on the tensors' device: (scal (B, 14), st3 (B, 3))."""
    dev = ev["mean"].device
    args = (gtf, model, ev, lpd, alphas, W, x_unc, t_start, valid, subset,
            p_stay_seq, p_skip_seq, train_scaling, train_transitions)
    if dev.type == "cpu":
        return fused_bwd_mstats_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no fused EM backward for device {dev}")
    return em_backward_kernel(*args)


# ---------------------------------------------------------------------------
# K5m: K5 with the states split over M ranks (the EM round on the state
# axis, parallel/statepar.py).  Rank m holds the states [m W, (m + 1) W), W
# = n / M: its (B, W) cut of the tables, the scaled model and W, its (T, B,
# W) slice of K4m's alphas, and what it publishes each step, at the step's
# parity t % 2: its maxima (the partial max of g = em + beta over its
# states, then its 3 partial masked maxima of the step before) and its
# record of block sums (sum4 of its W / 4 blocks of 4 states, their logs,
# sum16 of its W / 16 blocks of 16); and its per-step partial sums red (B,
# T, 12).
# ---------------------------------------------------------------------------

#: the columns of K5m's per-step record red (B, T, 12): the 6 post sums
#: over the rank's states, the 3 transition sums of exp(v - max) over them,
#: then the 3 masked maxima over all states
NRED_WAVE = 12
#: K5m's published maxima a read and step: the partial max of g, then the
#: 3 partial masked maxima of the step before
NMAX_WAVE = 4


def block_sums_width(W: int) -> int:
    """The width of a rank's record of block sums at slices of W states:
    W / 4 sums of 4, their logs, W / 16 sums of 16."""
    return 2 * (W // 4) + W // 16


class EMWaveRank(NamedTuple):
    """One rank of a data row of the EM backward, on the rank's device:
    its (B, W) cut of the grouped tables (gtf), the codebooks of the whole
    tables (books (B, 3, BWD_CODES), hmm.bwd_codebooks), its (B, W) scaled
    model, the row's (B, T) drift-corrected events and (B,) lengths,
    log Pr[data] lpd (B,), its slice of the alphas (T, B, W), its (B, 6, W)
    cut of the state weights W (None without train_scaling), the row's
    x_unc and t_start (B, T), valid (B,) bool, its (W,) cut of the
    transition-training subset, the row's p_stay_seq and p_skip_seq (B,);
    then its buffers: maxima (2, B, NMAX_WAVE), sums (2, B,
    block_sums_width(W)), red (B, T, NRED_WAVE) float32 and the step
    counters flags (B,) int32, zero before each launch; and scal (B, 14),
    st3 (B, 3), where the row's first rank puts the row's statistics
    (fused_bwd_mstats')."""

    gtf: hmm.GroupedTransFull
    books: torch.Tensor
    model: hmm.ModelArrays
    ev: dict
    lpd: torch.Tensor
    alphas: torch.Tensor
    W: torch.Tensor | None
    x_unc: torch.Tensor
    t_start: torch.Tensor
    valid: torch.Tensor
    subset: torch.Tensor
    p_stay_seq: torch.Tensor
    p_skip_seq: torch.Tensor
    maxima: torch.Tensor
    sums: torch.Tensor
    red: torch.Tensor
    flags: torch.Tensor
    scal: torch.Tensor
    st3: torch.Tensor


def rank_block_sums(G, record, with_logs: bool) -> None:
    """A rank's record of block sums (b, block_sums_width(W)) from its
    slice G (b, W) of exp(g - max): sum4 of its blocks of 4 states, their
    logs (with_logs; else left), sum16 of its blocks of 16, each added in
    state order as fused_bwd_mstats_plain's block_sum adds them (every
    block lies in one slice)."""
    U = G.shape[-1] // 4
    sum4 = hmm.block_sum(G, 4)
    record[:, :U] = sum4
    if with_logs:
        record[:, U:2 * U] = torch.log(sum4)
    record[:, 2 * U:] = hmm.block_sum(G, 16)


def slice_beta(gtf: hmm.GroupedTransFull, lengths, recs, g, m, t: int,
               lo: int) -> torch.Tensor:
    """A rank's beta of event t at its states [lo, lo + W): the step of
    hmm.fwbw_grouped_backward_plain for these states from g (b, W) = em(t +
    1) + beta, m (b, 1) the max over every rank's g, and recs the M ranks'
    records of block sums of G = exp(g - m) (rank_block_sums; on this
    rank's device): sum4[j % (n / 4)] and sum16[j % (n / 16)] of state j,
    n = M W.  0 from t = length - 1 on."""
    W = g.shape[-1]
    U, n = W // 4, len(recs) * W
    dev = g.device
    cols = slice(lo, lo + W)
    m_ = {k: v[cols] for k, v in hmm.correction_masks(gtf.K, dev).items()}
    e_stay, e_step_to, e_skip_to = hmm.bwd_exp_tables(gtf)
    j = torch.arange(lo, lo + W, device=dev)
    T4 = torch.cat([x[:, :U] for x in recs], dim=1)[:, j % (n // 4)]
    T16 = torch.cat([x[:, 2 * U:] for x in recs], dim=1)[:, j % (n // 16)]
    G = torch.exp(g - m)
    total = (e_stay * G + e_step_to * (T4 - m_["H"] * G)
             + e_skip_to * (T16 - m_["P2mH"] * G - m_["S5T"] * T4))
    return torch.where((t >= lengths - 1)[:, None], 0.0,
                       m + torch.log(total))


def em_backward_slice_plain(r: EMWaveRank, sums, g, m, t: int, lo: int,
                            train_scaling: bool, train_transitions: bool):
    """One rank's reverse step after both exchanges, the plain version of
    K5m's step for the states [lo, lo + W) of r (its (b, ...) rows, as
    em_backward_wave_plain cuts them): g (b, W) is its em(t + 1) + beta, m
    (b, 1) the max over every rank's partial max, sums the M ranks'
    records of block sums (b, block_sums_width(W)) of the step, on any
    devices, read in place where its states read them: sum4[j % (n / 4)]
    (and its log) and sum16[j % (n / 16)] of state j, n = M W.  Returns
    (beta (b, W) of event t; the 6 post sums (b, 6) over the rank's
    states, the pairwise tree of fused_bwd_mstats_plain's sums over them,
    or None without train_scaling; the masked transition values v (b, 3,
    W) whose log-sum-exp over all states _step_lse takes, or None without
    train_transitions)."""
    W = g.shape[-1]
    U, n = W // 4, len(sums) * W
    lengths = r.ev["length"]
    dev = r.ev["mean"].device
    _, _, _, log_p_stay, log_p_step4 = _bwd_tables(r.gtf, r.p_stay_seq,
                                                   r.p_skip_seq)
    lpd_c = r.lpd[:, None]
    recs = [x.to(dev) for x in sums]
    j = torch.arange(lo, lo + W, device=dev)
    beta = slice_beta(r.gtf, lengths, recs, g, m, t, lo)
    alpha_t = r.alphas[t]
    lp_j1 = alpha_t + beta - lpd_c
    sums_t = v = None
    if train_scaling:
        w_t = ((t < lengths) & r.valid)[:, None]
        sums_t = hmm.tree_sum((torch.exp(lp_j1) * w_t)[:, None, :] * r.W)
    if train_transitions:
        LS4 = torch.cat([x[:, U:2 * U] for x in recs],
                        dim=1)[:, j % (n // 4)]
        lp_stay = torch.minimum(alpha_t + log_p_stay[:, None] + g - lpd_c,
                                lp_j1)
        safe_m = torch.where(torch.isfinite(m), m, 0.0)
        lp_steps = alpha_t + log_p_step4[:, None] + (safe_m + LS4) - lpd_c
        lp_d01 = torch.minimum(torch.logaddexp(lp_stay, lp_steps), lp_j1)
        lp_d2 = torch.log(torch.clamp_min(torch.exp(lp_j1)
                                          - torch.exp(lp_d01), 0.0))
        w_tr = (((t < lengths - 1) & r.valid)[:, None]
                & r.subset[None, :])[:, None, :]
        v = torch.where(w_tr, torch.stack([lp_j1, lp_stay, lp_d2], dim=1),
                        _NEG_INF)
    return beta, sums_t, v


def _rank_rows(r: EMWaveRank, rows: slice) -> EMWaveRank:
    """r's rows [rows] of every per-read tensor (the alphas' second axis),
    its per-state tensors whole."""
    def cut(x):
        return None if x is None else x[rows]
    return r._replace(
        gtf=hmm.GroupedTransFull(*(x[rows] for x in r.gtf[:5]), K=r.gtf.K),
        books=r.books[rows],
        model=hmm.ModelArrays(*(x[rows] for x in r.model)),
        ev={k: v[rows] for k, v in r.ev.items()}, lpd=r.lpd[rows],
        alphas=r.alphas[:, rows], W=cut(r.W), x_unc=r.x_unc[rows],
        t_start=r.t_start[rows], valid=r.valid[rows],
        p_stay_seq=r.p_stay_seq[rows], p_skip_seq=r.p_skip_seq[rows],
        maxima=r.maxima[:, rows], sums=r.sums[:, rows], red=r.red[rows],
        flags=r.flags[rows], scal=r.scal[rows], st3=r.st3[rows])


def em_backward_fold_plain(first: EMWaveRank, reds, train_scaling: bool,
                           train_transitions: bool) -> None:
    """The row's statistics from the ranks' per-step records reds (M (b, T,
    NRED_WAVE) tensors) into first.scal and first.st3 (the row's first
    rank, its rows as cut): each step's partial sums combined pairwise in
    rank order (hmm.combine_rank_sums), then folded over the steps in
    fused_bwd_mstats_plain's order: the 14 moments from t = T - 1 down, the
    3 log totals by logaddexp from t = T - 2 down."""
    dev = first.scal.device
    b, T = first.x_unc.shape
    comb = hmm.combine_rank_sums([x[:, :, :9].to(dev) for x in reds])
    lengths, valid = first.ev["length"], first.valid
    scal = torch.zeros((b, 14), dtype=torch.float32, device=dev)
    st3 = torch.full((b, 3), _NEG_INF, dtype=torch.float32, device=dev)
    if train_scaling:
        for t in range(T - 1, -1, -1):
            w_t = ((t < lengths) & valid)[:, None]
            mom = _moments(comb[:, t, :6], first.x_unc[:, t],
                           first.t_start[:, t], first.ev["stdv"][:, t], w_t)
            scal = mom if t == T - 1 else scal + mom
    if train_transitions:
        for t in range(T - 2, -1, -1):
            mm = reds[0][:, t, 9:12].to(dev)
            safe = torch.where(torch.isfinite(mm), mm, 0.0)
            part = torch.where(torch.isfinite(mm),
                               safe + torch.log(comb[:, t, 6:9]), mm)
            st3 = hmm.logaddexp(st3, part)
    first.scal.copy_(scal)
    first.st3.copy_(st3)


def em_backward_wave_plain(ranks, lo: int, hi: int, train_scaling: bool,
                           train_transitions: bool) -> None:
    """Plain version of K5m: the reverse pass over the reads [lo, hi) for
    every rank of a data row (ranks: its M EMWaveRanks in rank order),
    publishing what the kernel publishes, each step t at parity t % 2:
    every rank's g = em(t + 1) + beta of its states, its partial max of g
    with its partial masked maxima of step t + 1 into maxima; from every
    rank's, m and step t + 1's masked maxima over all states (then each
    rank's sums of exp(v - max) of step t + 1 into red[:, t + 1, 6:9],
    the maxima beside them); every rank's block sums of G = exp(g - m) into
    sums; every rank's em_backward_slice_plain on the peers' records read
    in place, its post sums into red[:, t, :6].  The t = T - 1 term (beta
    = 0) comes first; after step 0 a last exchange of maxima brings step
    0's.  Then em_backward_fold_plain into the first rank's scal and st3.
    The counters are left as they are."""
    rows = slice(lo, hi)
    parts = [_rank_rows(r, rows) for r in ranks]
    T, W = parts[0].x_unc.shape[1], parts[0].alphas.shape[-1]
    dev0 = parts[0].maxima.device
    if train_scaling:
        for p in parts:
            w = ((T - 1 < p.ev["length"]) & p.valid)[:, None]
            post = torch.exp(p.alphas[T - 1] - p.lpd[:, None]) * w
            p.red[:, T - 1, :6] = hmm.tree_sum(post[:, None, :] * p.W)

    def exchange(slot: int, gs, held):
        """Every rank's maxima at `slot`: the partial max of its g (-inf
        after the last step) and its partial masked maxima of the held
        step's v (-inf where none is held); returns their max over the
        ranks (b, NMAX_WAVE) on the first rank's device."""
        for p, g, v in zip(parts, gs, held):
            p.maxima[slot, :, 0] = (_NEG_INF if g is None
                                    else torch.amax(g, dim=-1))
            p.maxima[slot, :, 1:] = (_NEG_INF if v is None
                                     else torch.amax(v, dim=-1))
        return hmm.ranks_amax([p.maxima[slot] for p in parts], dev0)

    def transition_sums(tp: int, held, mm) -> None:
        """Each rank's sums of exp(v - max) of step tp over its states,
        the masked maxima mm over all states beside them."""
        for p, v in zip(parts, held):
            mp = mm.to(p.red.device)
            safe = torch.where(torch.isfinite(mp), mp, 0.0)
            p.red[:, tp, 6:9] = hmm.tree_sum(torch.exp(v - safe[..., None]))
            p.red[:, tp, 9:] = mp

    M = len(parts)
    betas = [torch.zeros_like(p.alphas[0]) for p in parts]
    held = [None] * M
    for t in range(T - 2, -1, -1):
        slot = t % 2
        gs = [hmm.log_emission(p.model, p.ev["mean"][:, t + 1],
                               p.ev["stdv"][:, t + 1],
                               p.ev["log_stdv"][:, t + 1]) + beta
              for p, beta in zip(parts, betas)]
        mx = exchange(slot, gs, held)
        if held[0] is not None:
            transition_sums(t + 1, held, mx[:, 1:])
        ms = [mx[:, :1].to(p.sums.device) for p in parts]
        for p, g, m in zip(parts, gs, ms):
            rank_block_sums(torch.exp(g - m), p.sums[slot],
                            train_transitions)
        outs = [em_backward_slice_plain(p, [q.sums[slot] for q in parts],
                                        g, m, t, k * W, train_scaling,
                                        train_transitions)
                for k, (p, g, m) in enumerate(zip(parts, gs, ms))]
        betas = [o[0] for o in outs]
        if train_scaling:
            for p, o in zip(parts, outs):
                p.red[:, t, :6] = o[1]
        held = [o[2] for o in outs]
    mx = exchange(1, [None] * M, held)
    if held[0] is not None:
        transition_sums(0, held, mx[:, 1:])
    em_backward_fold_plain(parts[0], [p.red for p in parts], train_scaling,
                           train_transitions)


#: em_backward_wave_resident's answers, by (card index, sys, train_scaling,
#: W, cluster)
_wave_resident: dict = {}


def em_backward_wave_resident(dev, sys: bool, train_scaling: bool, W: int,
                              cluster: bool = False) -> int:
    """The most blocks of K5m's instance (sys: the exchange across cards;
    train_scaling, at slices of W states, whose shared memory it sets) that
    the CUDA device `dev` holds at once: a cooperative wave's grid, reads
    times the card's ranks, must not exceed it; cluster: the blocks of the
    most clusters of the cluster path it holds at once."""
    key = (torch.device(dev).index, bool(sys), bool(train_scaling), int(W),
           bool(cluster))
    if key not in _wave_resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_em_backward_wave_resident(
            int(sys), int(train_scaling), hmm._slice_shift(4096 // W, W),
            int(cluster), key[0], ctypes.byref(blocks)),
            "em_backward_wave occupancy")
        _wave_resident[key] = blocks.value
    return _wave_resident[key]


def _check_em_wave_rank(m: int, r: EMWaveRank, B: int, T: int, W: int,
                        train_scaling: bool) -> None:
    dev = r.ev["mean"].device
    if r.gtf.K != 6:
        raise ValueError(f"the CUDA EM backward kernel takes K=6, got "
                         f"K={r.gtf.K}")
    hmm._check_events(r.ev, B, T, dev)
    hmm._check_tables(tuple(r.model), B, W, dev)
    hmm._check(f"ranks[{m}].books", r.books, torch.float32,
               (B, 3, hmm.BWD_CODES), dev)
    if train_scaling:
        hmm._check(f"ranks[{m}].W", r.W, torch.float32, (B, 6, W), dev)
        hmm._check_aligned(f"ranks[{m}].W", r.W)
    hmm._check(f"ranks[{m}].alphas", r.alphas, torch.float32, (T, B, W), dev)
    hmm._check_aligned(f"ranks[{m}].alphas", r.alphas)
    for name in ("lpd", "p_stay_seq", "p_skip_seq"):
        hmm._check(f"ranks[{m}].{name}", getattr(r, name), torch.float32,
                   (B,), dev)
    for name in ("x_unc", "t_start"):
        hmm._check(f"ranks[{m}].{name}", getattr(r, name), torch.float32,
                   (B, T), dev)
    hmm._check(f"ranks[{m}].valid", r.valid, torch.bool, (B,), dev)
    hmm._check(f"ranks[{m}].subset", r.subset, torch.bool, (W,), dev)
    hmm._check(f"ranks[{m}].maxima", r.maxima, torch.float32,
               (2, B, NMAX_WAVE), dev)
    hmm._check(f"ranks[{m}].sums", r.sums, torch.float32,
               (2, B, block_sums_width(W)), dev)
    hmm._check(f"ranks[{m}].red", r.red, torch.float32, (B, T, NRED_WAVE),
               dev)
    hmm._check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)
    hmm._check(f"ranks[{m}].scal", r.scal, torch.float32, (B, 14), dev)
    hmm._check(f"ranks[{m}].st3", r.st3, torch.float32, (B, 3), dev)


def em_backward_wave_kernel(ranks, local, lo: int, hi: int,
                            train_scaling: bool, train_transitions: bool,
                            cluster: bool | None = None) -> None:
    """K5m on the card: em_backward_wave_plain's work for the ranks `local`
    (indices into `ranks`, all on one card; 2 to 64 ranks in all) over the
    reads [lo, hi), one launch on that card's current stream.  cluster (by
    default hmm.wave_cluster(M, sys) where `local` holds every rank): each
    read's M blocks one thread block cluster, any number of reads.  Else
    one cooperative launch, whose grid (hi - lo reads x len(local) ranks)
    must fit the card at once (em_backward_wave_resident), or the launch
    raises; the other ranks run their blocks of the same reads in a launch
    of their own card; their maxima, block sums, records and counters are
    read over peer access, and a block waits WAVE_TIMEOUT_S on a peer at
    most.  The row's first rank folds the row's statistics into its scal
    and st3 once every peer's record is in.  At least one train flag must
    be set."""
    if not (train_scaling or train_transitions):
        raise ValueError("K5m runs with a train flag set")
    B, T, W, shift, dev, sys = hmm._wave_setup(ranks, local, lo, hi, "K5m")
    cluster = hmm.cluster_path(len(ranks), sys, len(local), cluster)
    vals, keep = [], []
    for m, r in enumerate(ranks):
        _check_em_wave_rank(m, r, B, T, W, train_scaling)
        if m in local:
            # made on the launch's stream and held until it is enqueued
            pattern, flags = hmm.wave_state_bytes(dev, m, W, backward=True)
            keep += [pattern, flags | ((r.subset > 0).to(torch.uint8)
                                       << BWD_FLAG_BITS["subset"]),
                     *_log_rates(r.p_stay_seq, r.p_skip_seq)]
            own = [x.data_ptr() for x in keep[-4:]]
        else:  # a peer's inputs are never read by this launch
            own = [0] * 4
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 r.books.data_ptr(), own[0], own[1],
                 *(x.data_ptr() for x in r.model),
                 r.W.data_ptr() if train_scaling else 0,
                 r.alphas.data_ptr(), r.lpd.data_ptr(), r.x_unc.data_ptr(),
                 r.t_start.data_ptr(), r.valid.data_ptr(), own[2], own[3],
                 r.maxima.data_ptr(), r.sums.data_ptr(), r.red.data_ptr(),
                 r.flags.data_ptr(), r.scal.data_ptr(), r.st3.data_ptr()]
    table = hmm._rank_table(vals, local, dev)
    err = _cuda.load().nc_em_backward_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift,
        int(train_scaling), int(train_transitions), int(sys), int(cluster),
        LOG_2PI,
        int(hmm.WAVE_TIMEOUT_S * 1e9), hmm._timed_out.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "em_backward_wave kernel launch")
    _cuda.count_launch(em_backward_wave_kernel)


em_backward_wave_kernel.launches = 0


# ---------------------------------------------------------------------------
# K6dm: K6d (the grouped backward with the betas stored) with the states
# split over M ranks, the legacy EM round's grouped rows on the state axis
# (parallel/statepar.py).  K6d's step on the rank's slice
# (csrc/fwbw_backward_wave.cu): each step every rank publishes its partial
# max of g = em(t + 1) + beta, then its block sums of G = exp(g - max),
# and stores its slice of beta.
# ---------------------------------------------------------------------------


class BetaWaveRank(NamedTuple):
    """One rank of a data row of the grouped backward, on the rank's
    device: its (B, W) cut of the grouped tables (gtf), the codebooks of the
    whole tables (books (B, 3, BWD_CODES), hmm.bwd_codebooks), its (B, W)
    scaled model, the row's (B, T) events and (B,) lengths whole; betas
    (B, T, W) float32, its slice of K6d's betas; its exchange buffers
    maxima (2, B, NMAX_WAVE) and sums (2, B, block_sums_width(W)) float32
    and its step counters flags (B,) int32, zero before each launch."""

    gtf: hmm.GroupedTransFull
    books: torch.Tensor
    model: hmm.ModelArrays
    ev: dict
    betas: torch.Tensor
    maxima: torch.Tensor
    sums: torch.Tensor
    flags: torch.Tensor


def fwbw_backward_wave_plain(ranks, lo: int, hi: int) -> None:
    """Plain version of K6dm: hmm.fwbw_grouped_backward_plain's reverse
    pass over the reads [lo, hi) for every rank of a data row (ranks: its M
    BetaWaveRanks in rank order), publishing what the kernel publishes,
    each step t at parity t % 2: every rank's g = em(t + 1) + beta of its
    states and its partial max of g into maxima[..., 0]; from every rank's,
    m, the max over all states; every rank's block sums of exp(g - m) into
    sums (rank_block_sums, without the logs); every rank's slice_beta on
    the peers' records read in place, into betas[:, t] (0 at T - 1).  The
    counters are left as they are."""
    rows = slice(lo, hi)
    parts = [r._replace(
        gtf=hmm.GroupedTransFull(*(x[rows] for x in r.gtf[:5]), K=r.gtf.K),
        model=hmm.ModelArrays(*(x[rows] for x in r.model)),
        ev={k: v[rows] for k, v in r.ev.items()}, betas=r.betas[rows],
        maxima=r.maxima[:, rows], sums=r.sums[:, rows]) for r in ranks]
    T, W = parts[0].betas.shape[1:]
    for p in parts:
        p.betas[:, T - 1] = 0.0
    for t in range(T - 2, -1, -1):
        slot = t % 2
        gs = [hmm.log_emission(p.model, p.ev["mean"][:, t + 1],
                               p.ev["stdv"][:, t + 1],
                               p.ev["log_stdv"][:, t + 1]) + p.betas[:, t + 1]
              for p in parts]
        for p, g in zip(parts, gs):
            p.maxima[slot, :, 0] = torch.amax(g, dim=-1)
            p.maxima[slot, :, 1:] = _NEG_INF
        ms = [hmm.ranks_amax([q.maxima[slot, :, 0] for q in parts],
                             p.sums.device)[:, None] for p in parts]
        for p, g, m in zip(parts, gs, ms):
            rank_block_sums(torch.exp(g - m), p.sums[slot], False)
        for k, (p, g, m) in enumerate(zip(parts, gs, ms)):
            recs = [q.sums[slot].to(g.device) for q in parts]
            p.betas[:, t] = slice_beta(p.gtf, p.ev["length"], recs, g, m, t,
                                       k * W)


#: fwbw_backward_wave_resident's answers, by (card index, sys, W, cluster)
_beta_resident: dict = {}


def fwbw_backward_wave_resident(dev, sys: bool, W: int,
                                cluster: bool = False) -> int:
    """The most blocks of K6dm's instance (sys: the exchange across cards;
    slices of W states) that the CUDA device `dev` holds at once, as
    em_backward_wave_resident."""
    key = (torch.device(dev).index, bool(sys), int(W), bool(cluster))
    if key not in _beta_resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_fwbw_backward_wave_resident(
            int(sys), hmm._slice_shift(4096 // W, W), int(cluster), key[0],
            ctypes.byref(blocks)), "fwbw_backward_wave occupancy")
        _beta_resident[key] = blocks.value
    return _beta_resident[key]


def _check_beta_wave_rank(m: int, r: BetaWaveRank, B: int, T: int,
                          W: int) -> None:
    dev = r.ev["mean"].device
    if r.gtf.K != 6:
        raise ValueError(f"the CUDA grouped backward kernel takes K=6, got "
                         f"K={r.gtf.K}")
    hmm._check_events(r.ev, B, T, dev)
    hmm._check_tables(tuple(r.model), B, W, dev)
    hmm._check(f"ranks[{m}].books", r.books, torch.float32,
               (B, 3, hmm.BWD_CODES), dev)
    hmm._check(f"ranks[{m}].betas", r.betas, torch.float32, (B, T, W), dev)
    hmm._check_aligned(f"ranks[{m}].betas", r.betas)
    hmm._check(f"ranks[{m}].maxima", r.maxima, torch.float32,
               (2, B, NMAX_WAVE), dev)
    hmm._check(f"ranks[{m}].sums", r.sums, torch.float32,
               (2, B, block_sums_width(W)), dev)
    hmm._check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)


def fwbw_backward_wave_kernel(ranks, local, lo: int, hi: int,
                              cluster: bool | None = None) -> None:
    """K6dm on the card: fwbw_backward_wave_plain's work for the ranks
    `local` (indices into `ranks`, all on one card; 2 to 64 ranks in all)
    over the reads [lo, hi), one launch on that card's current stream
    (csrc/fwbw_backward_wave.cu), each rank storing its betas.  cluster,
    the waves and the peers as em_backward_wave_kernel; the cluster path
    pushes the maxima and sums into the blocks' shared memory and reads
    neither maxima, sums nor counters."""
    B, T, W, shift, dev, sys = hmm._wave_setup(ranks, local, lo, hi, "K6dm")
    cluster = hmm.cluster_path(len(ranks), sys, len(local), cluster)
    vals, keep = [], []
    for m, r in enumerate(ranks):
        _check_beta_wave_rank(m, r, B, T, W)
        if m in local:
            keep += hmm.wave_state_bytes(dev, m, W, backward=True)
            own = [x.data_ptr() for x in keep[-2:]]
        else:  # a peer's inputs are never read by this launch
            own = [0, 0]
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 r.books.data_ptr(), *own, *(x.data_ptr() for x in r.model),
                 r.betas.data_ptr(), r.maxima.data_ptr(),
                 r.sums.data_ptr(), r.flags.data_ptr()]
    table = hmm._rank_table(vals, local, dev)
    err = _cuda.load().nc_fwbw_backward_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift, int(sys),
        int(cluster), LOG_2PI, int(hmm.WAVE_TIMEOUT_S * 1e9),
        hmm._timed_out.data_ptr(), *_cuda.target(dev))
    _cuda.check(err, "fwbw_backward_wave kernel launch")
    _cuda.count_launch(fwbw_backward_wave_kernel)


fwbw_backward_wave_kernel.launches = 0
