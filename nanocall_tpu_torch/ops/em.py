"""K5: the EM E-step's fused backward pass with both M-steps' sufficient
statistics (nanocall_tpu/train.py:159-320, `_fused_bwd_mstats`).

The reverse recursion keeps beta on chip and never stores it, recomputes
each emission, and folds the posteriors into 14 scaling moments and 3
log-space transition totals per row.  The plain PyTorch version runs on
CPU tensors; CUDA tensors go to the kernel of csrc/em_backward.cu.  K4, the
forward half whose alphas this pass reads, is in ops/hmm.py.
"""

from __future__ import annotations

import math

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
    return (*hmm.bwd_exp_tables(gtf), torch.log(p_stay_seq),
            torch.log(1.0 - p_stay_seq - p_skip_seq) - math.log(4.0))


def _post_stats(post, W, x, ts, y, w):
    """Scaling-M-step contributions of one event (hpp:265-296): post (B, n)
    contracted with W (B, 6, n), folded against the uncorrected mean x,
    the start ts and the stdv y into the 14 moments of SCAL_NAMES."""
    s0, s1, s2, l0, l1, l2 = hmm.tree_sum(post[:, None, :] * W).unbind(1)
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
            st3 = torch.logaddexp(st3, part)
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
    e_stay, e_step_to, e_skip_to, log_p_stay, log_p_step4 = _bwd_tables(
        gtf, p_stay_seq, p_skip_seq)
    tables = (e_stay, e_step_to, e_skip_to, *model)
    hmm._check_tables(tables, B, n, dev)
    if train_scaling:
        hmm._check("W", W, torch.float32, (B, 6, n), dev)
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
    scal = torch.empty((B, 14), dtype=torch.float32, device=dev)
    st3 = torch.empty((B, 3), dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_em_backward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, *(x.data_ptr() for x in tables),
        W.data_ptr() if train_scaling else None, alphas.data_ptr(),
        lpd.data_ptr(), x_unc.data_ptr(), t_start.data_ptr(),
        valid.data_ptr(), log_p_stay.data_ptr(), log_p_step4.data_ptr(),
        flags.data_ptr(), int(train_scaling), int(train_transitions), LOG_2PI,
        scal.data_ptr(), st3.data_ptr(), hmm._device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
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
