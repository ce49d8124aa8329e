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
it after K4m): each rank's statistics are subtrees of K5's pairwise sums,
and the row's first rank folds the ranks' per-step partials.
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
# W) slice of K4m's alphas, a (2, B, W) buffer of g = em + beta at parity
# s % 2 of the s-th step, its (B, 3) partial maxima and its per-step
# partial sums red (B, T, 12).
# ---------------------------------------------------------------------------

#: the columns of K5m's per-step record red (B, T, 12): the 6 post sums
#: over the rank's states, the 3 transition sums of exp(v - max) over them,
#: then the 3 masked maxima over all states
NRED_WAVE = 12


class EMWaveRank(NamedTuple):
    """One rank of a data row of the EM backward, on the rank's device:
    its (B, W) cut of the grouped tables (gtf), the codebooks of the whole
    tables (books (B, 3, BWD_CODES), hmm.bwd_codebooks), its (B, W) scaled
    model, the row's (B, T) drift-corrected events and (B,) lengths,
    log Pr[data] lpd (B,), its slice of the alphas (T, B, W), its (B, 6, W)
    cut of the state weights W (None without train_scaling), the row's
    x_unc and t_start (B, T), valid (B,) bool, its (W,) cut of the
    transition-training subset, the row's p_stay_seq and p_skip_seq (B,);
    then its buffers: g (2, B, W), maxima (B, 3), red (B, T, NRED_WAVE)
    float32 and the step counters flags (B,) int32, zero before each
    launch; and scal (B, 14), st3 (B, 3), where the row's first rank puts
    the row's statistics (fused_bwd_mstats')."""

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
    g: torch.Tensor
    maxima: torch.Tensor
    red: torch.Tensor
    flags: torch.Tensor
    scal: torch.Tensor
    st3: torch.Tensor


def em_backward_slice_plain(r: EMWaveRank, column, t: int, lo: int,
                            train_scaling: bool, train_transitions: bool):
    """One rank's reverse step, the plain version of K5m's step for the
    states [lo, lo + W) of r (its (b, ...) rows, as em_backward_wave_plain
    cuts them): column is g = em(t + 1) + beta of every state, as its M
    (b, W) slices on any devices.  Returns (beta (b, W) of event t; the 6
    post sums (b, 6) over the rank's states, the pairwise tree of
    fused_bwd_mstats_plain's sums over them, or None without
    train_scaling; the masked transition values v (b, 3, W) whose
    log-sum-exp over all states _step_lse takes, or None without
    train_transitions)."""
    W = column[0].shape[-1]
    mean, lengths = r.ev["mean"], r.ev["length"]
    cols = slice(lo, lo + W)
    m_ = {k: v[cols] for k, v in
          hmm.correction_masks(r.gtf.K, mean.device).items()}
    e_stay, e_step_to, e_skip_to, log_p_stay, log_p_step4 = _bwd_tables(
        r.gtf, r.p_stay_seq, r.p_skip_seq)
    lpd_c = r.lpd[:, None]
    g = hmm.gather_column(column, mean.device)
    m = torch.amax(g, dim=-1, keepdim=True)
    G = torch.exp(g - m)
    sum4 = hmm.block_sum(G, 4)
    T4 = sum4.repeat(1, 4)[:, cols]
    T16 = hmm.block_sum(G, 16).repeat(1, 16)[:, cols]
    Gs = G[:, cols]
    total = (e_stay * Gs + e_step_to * (T4 - m_["H"] * Gs)
             + e_skip_to * (T16 - m_["P2mH"] * Gs - m_["S5T"] * T4))
    beta = torch.where((t >= lengths - 1)[:, None], 0.0,
                       m + torch.log(total))
    alpha_t = r.alphas[t]
    lp_j1 = alpha_t + beta - lpd_c
    sums = v = None
    if train_scaling:
        w_t = ((t < lengths) & r.valid)[:, None]
        sums = hmm.tree_sum((torch.exp(lp_j1) * w_t)[:, None, :] * r.W)
    if train_transitions:
        lp_stay = torch.minimum(alpha_t + log_p_stay[:, None] + g[:, cols]
                                - lpd_c, lp_j1)
        safe_m = torch.where(torch.isfinite(m), m, 0.0)
        lsum4 = safe_m + torch.log(sum4).repeat(1, 4)[:, cols]
        lp_steps = alpha_t + log_p_step4[:, None] + lsum4 - lpd_c
        lp_d01 = torch.minimum(torch.logaddexp(lp_stay, lp_steps), lp_j1)
        lp_d2 = torch.log(torch.clamp_min(torch.exp(lp_j1)
                                          - torch.exp(lp_d01), 0.0))
        w_tr = (((t < lengths - 1) & r.valid)[:, None]
                & r.subset[None, :])[:, None, :]
        v = torch.where(w_tr, torch.stack([lp_j1, lp_stay, lp_d2], dim=1),
                        _NEG_INF)
    return beta, sums, v


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
        g=r.g[:, rows], maxima=r.maxima[rows], red=r.red[rows],
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
    each step: every rank's g slice into g[s % 2] (s the step's number
    from 0), every rank's em_backward_slice_plain on the peers' slices read
    in place, its post sums into red[:, t, :6], and with train_transitions
    the masked maxima over every rank (its own into maxima, all of them in
    red[:, t, 9:]), then its sums of exp(v - max) into red[:, t, 6:9]; the
    t = T - 1 term (beta = 0) first.  Then em_backward_fold_plain into the
    first rank's scal and st3.  The counters are left as they are."""
    rows = slice(lo, hi)
    parts = [_rank_rows(r, rows) for r in ranks]
    T, W = parts[0].x_unc.shape[1], parts[0].alphas.shape[-1]
    if train_scaling:
        for p in parts:
            w = ((T - 1 < p.ev["length"]) & p.valid)[:, None]
            post = torch.exp(p.alphas[T - 1] - p.lpd[:, None]) * w
            p.red[:, T - 1, :6] = hmm.tree_sum(post[:, None, :] * p.W)
    betas = [torch.zeros_like(p.alphas[0]) for p in parts]
    for s, t in enumerate(range(T - 2, -1, -1)):
        for p, beta in zip(parts, betas):
            ev = p.ev
            p.g[s % 2] = hmm.log_emission(p.model, ev["mean"][:, t + 1],
                                          ev["stdv"][:, t + 1],
                                          ev["log_stdv"][:, t + 1]) + beta
        column = [p.g[s % 2] for p in parts]
        outs = [em_backward_slice_plain(p, column, t, m * W, train_scaling,
                                        train_transitions)
                for m, p in enumerate(parts)]
        betas = [o[0] for o in outs]
        if train_scaling:
            for p, o in zip(parts, outs):
                p.red[:, t, :6] = o[1]
        if train_transitions:
            for p, o in zip(parts, outs):
                p.maxima.copy_(torch.amax(o[2], dim=-1))
            mm = torch.amax(torch.stack(
                [p.maxima.to(parts[0].maxima.device) for p in parts], -1),
                dim=-1)
            for p, o in zip(parts, outs):
                mp = mm.to(p.maxima.device)
                safe = torch.where(torch.isfinite(mp), mp, 0.0)
                p.red[:, t, 6:9] = hmm.tree_sum(torch.exp(o[2]
                                                          - safe[..., None]))
                p.red[:, t, 9:] = mp
    em_backward_fold_plain(parts[0], [p.red for p in parts], train_scaling,
                           train_transitions)


#: em_backward_wave_resident's answers, by (card index, sys, train_scaling,
#: W)
_wave_resident: dict = {}


def em_backward_wave_resident(dev, sys: bool, train_scaling: bool,
                              W: int) -> int:
    """The most blocks of K5m's instance (sys: the exchange across cards;
    train_scaling, at slices of W states, whose shared memory it sets) that
    the CUDA device `dev` holds at once: a wave's grid, reads times the
    card's ranks, must not exceed it."""
    key = (torch.device(dev).index, bool(sys), bool(train_scaling), int(W))
    if key not in _wave_resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_em_backward_wave_resident(
            int(sys), int(train_scaling), hmm._slice_shift(4096 // W, W),
            key[0], ctypes.byref(blocks)), "em_backward_wave occupancy")
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
    hmm._check(f"ranks[{m}].g", r.g, torch.float32, (2, B, W), dev)
    hmm._check_aligned(f"ranks[{m}].g", r.g)
    hmm._check(f"ranks[{m}].maxima", r.maxima, torch.float32, (B, 3), dev)
    hmm._check(f"ranks[{m}].red", r.red, torch.float32, (B, T, NRED_WAVE),
               dev)
    hmm._check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)
    hmm._check(f"ranks[{m}].scal", r.scal, torch.float32, (B, 14), dev)
    hmm._check(f"ranks[{m}].st3", r.st3, torch.float32, (B, 3), dev)


def em_backward_wave_kernel(ranks, local, lo: int, hi: int,
                            train_scaling: bool,
                            train_transitions: bool) -> None:
    """K5m on the card: em_backward_wave_plain's work for the ranks `local`
    (indices into `ranks`, all on one card; 2 to 64 ranks in all) over the
    reads [lo, hi), one cooperative launch on that card's current stream,
    whose grid (hi - lo reads x len(local) ranks) must fit the card at once
    (em_backward_wave_resident), or the launch raises.  The other ranks run
    their blocks of the same reads in a launch of their own card; their g
    slices, maxima, records and counters are read over peer access.  The
    row's first rank waits for every peer's last step and folds the row's
    statistics into its scal and st3.  A block waits WAVE_TIMEOUT_S on a
    peer at most.  At least one train flag must be set."""
    if not (train_scaling or train_transitions):
        raise ValueError("K5m runs with a train flag set")
    B, T, W, shift, dev, sys = hmm._wave_setup(ranks, local, lo, hi, "K5m")
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
                 r.g.data_ptr(), r.maxima.data_ptr(), r.red.data_ptr(),
                 r.flags.data_ptr(), r.scal.data_ptr(), r.st3.data_ptr()]
    table = hmm._rank_table(vals, local, dev)
    err = _cuda.load().nc_em_backward_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift,
        int(train_scaling), int(train_transitions), int(sys), LOG_2PI,
        int(hmm.WAVE_TIMEOUT_S * 1e9), hmm._timed_out.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "em_backward_wave kernel launch")
    _cuda.count_launch(em_backward_wave_kernel)


em_backward_wave_kernel.launches = 0
