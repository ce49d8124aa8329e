"""Per-read EM training of pore-model scaling and transition parameters.

Port of nanocall_tpu/train.py's fused EM round and its driver loop.  One
training group is one (read, candidate model) pair with S = 4 training
subsequences; a batch of G groups trains at once as G*S rows:

  - E-step forward: K4 (hmm.fwbw_grouped_forward) stores the alphas,
    (T, B, n) float32, and log Pr[data] per row;
  - E-step backward + M-step statistics: K5 (ops/em.py, kernel
    csrc/em_backward.cu) runs the reverse recursion with beta kept on chip,
    recomputes each emission, and folds the posteriors into 14 scaling
    moments and 3 log-space transition totals per row;
  - M-steps in plain torch: the 3x3 weighted-least-squares solve with the
    reference's scaled partial pivoting, and the clamped transition update;
  - run_em: the per-group stopping rules of nanocall_tpu.train.run_em_device
    as masked tensor updates, one host read per round for the all-frozen
    exit.

Under a loaded transition table (`--trans`) a round is the legacy one
instead: the rows at the priors E-step under the table (K6c), the others by
the grouped kernels (K4 + K6d); both store alpha, beta and em, and the
statistics are reduced from those tensors in plain torch.

None of this imports nanocall_tpu.train (which imports jax); the numpy-only
helpers of that module are written out here.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import kmer
from .convert import BANK_FIELDS
from .ops import em, hmm

PIVOT_EPS = 1e-7  # Parameter_Trainer.hpp:355
ST_CLAMP_LO = 0.05  # Parameter_Trainer.hpp:518-525
ST_CLAMP_HI = 0.4

_NEG_INF = float("-inf")


@functools.lru_cache(maxsize=None)
def st_train_kmers(K: int) -> np.ndarray:
    """States used for transition training (Parameter_Trainer.hpp:30-57):
    self-overlap 0, and all 1-step successors have self-overlap <= 1."""
    mso = kmer.max_self_overlap(K)
    nl1 = kmer.neighbour_list(K, 1)
    good = (mso == 0) & (mso[nl1] <= 1).all(axis=1)
    return np.nonzero(good)[0].astype(np.int32)


@functools.lru_cache(maxsize=None)
def st_train_mask(K: int) -> np.ndarray:
    """(n_states,) float32 mask: 1 for transition-training k-mers, else 0."""
    m = np.zeros(kmer.n_states(K), dtype=np.float32)
    m[st_train_kmers(K)] = 1.0
    return m


def _solve3_pivoted(A: torch.Tensor, Bv: torch.Tensor, train_drift: bool):
    """Batched 3x3 Gaussian elimination with scaled partial pivoting
    (Parameter_Trainer.hpp:322-390; nanocall_tpu/train.py:89-147).

    A: (G, 3, 3), Bv: (G, 3) float32.  Returns (x (G, 3) = [shift, scale,
    drift], done (G,) bool singular flags).  A NaN pivot ratio (an all-zero
    row) counts as -inf, so the group is flagged singular rather than
    eliminated with a garbage pivot."""
    G = A.shape[0]
    dev = A.device
    C = torch.amax(A, dim=2)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    ar = torch.arange(3, device=dev)
    idx = ar.expand(G, 3)
    for i in range(3):
        vals = torch.abs(A[:, :, i]) / C
        vals = torch.where(torch.isnan(vals), _NEG_INF, vals)
        vals = torch.where(ar >= i, vals, _NEG_INF)
        p = torch.argmax(vals, dim=1)  # the first maximum, as hpp:346
        p_val = torch.gather(vals, 1, p[:, None])[:, 0]
        done = done | (p_val < PIVOT_EPS)
        p_col = p[:, None]
        swap_to = torch.where(idx == i, p_col, idx)
        swap_to = torch.where(idx == p_col, i, swap_to)
        A = torch.gather(A, 1, swap_to[:, :, None].expand(G, 3, 3))
        Bv = torch.gather(Bv, 1, swap_to)
        C = torch.gather(C, 1, swap_to)
        pivot = A[:, i, i]
        safe_pivot = torch.where(torch.abs(pivot) > 0, pivot, 1.0)
        for r in range(i + 1, 3):
            m = A[:, r, i] / safe_pivot
            newrow = A[:, r, :] - m[:, None] * A[:, i, :]
            newrow[:, i] = 0.0
            A = A.clone()
            A[:, r, :] = newrow
            Bv = Bv.clone()
            Bv[:, r] = Bv[:, r] - m * Bv[:, i]
    A22 = torch.where(torch.abs(A[:, 2, 2]) > 0, A[:, 2, 2], 1.0)
    c = Bv[:, 2] / A22
    A11 = torch.where(torch.abs(A[:, 1, 1]) > 0, A[:, 1, 1], 1.0)
    b = (Bv[:, 1] - A[:, 1, 2] * c) / A11
    A00 = torch.where(torch.abs(A[:, 0, 0]) > 0, A[:, 0, 0], 1.0)
    a = (Bv[:, 0] - A[:, 0, 1] * b - A[:, 0, 2] * c) / A00
    if not train_drift:
        c = torch.zeros_like(c)
    return torch.stack([a, b, c], dim=-1), done


def _masked_lse(x: torch.Tensor, mask: torch.Tensor, dim: int):
    """logsumexp of x where mask, over dim; -inf if empty."""
    x = torch.where(mask, x, _NEG_INF)
    m = torch.amax(x, dim=dim)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(torch.exp(x - safe.unsqueeze(dim)), dim=dim)
    return torch.where(torch.isfinite(m), safe + torch.log(s), m)


# ---------------------------------------------------------------------------
# one EM round
# ---------------------------------------------------------------------------


def _sum_seqs(v: torch.Tensor, G: int) -> torch.Tensor:
    """(G*S,) per-row values -> (G,) per-group sums, added in row order."""
    v = v.reshape(G, -1)
    s = v[:, 0]
    for i in range(1, v.shape[1]):
        s = s + v[:, i]
    return s


def round_inputs(ev: dict, models: dict, pm_params: torch.Tensor,
                 st_params: torch.Tensor, K: int = 6,
                 train_scaling: bool = True, states: slice | None = None
                 ) -> dict:
    """The per-row inputs of one EM round's kernels, built in plain torch
    from a batch of G groups (nanocall_tpu/train.py:374-477): the G*S rows'
    grouped tables `gtf` and scaled models `model` by strand, the
    drift-corrected events `ev` {mean, stdv, log_stdv, length}, and K5's
    extra inputs (W, x_unc, t_start, valid, subset, p_stay_seq,
    p_skip_seq); W (B, 6, n) is the unscaled models' state weights, None
    without train_scaling.  Arguments as train_one_round's.

    states: a rank's cut on the mesh's state axis, the states [lo, hi) of
    the 4^K: `models` then hold those states only ((G, 2, hi - lo) each),
    and the grouped tables and the subset, which depend on the global state
    index, are built whole and cut to them; "books" holds the whole tables'
    codebooks (hmm.bwd_codebooks), which K5m reads."""
    G, S, T = ev["mean"].shape
    if "model_idx" in models:
        idx = models["model_idx"].long()
        models = {k: models[k][idx] for k in BANK_FIELDS}
    n = models["level_mean"].shape[-1]
    cols = slice(None) if states is None else states

    # scaled models (fill_train_data, hpp:101-114; pore_model.scale_arrays)
    p = pm_params[:, None, :]
    lm_s = models["level_mean"] * p[..., 0:1] + p[..., 1:2]
    ls_s = models["level_stdv"] * p[..., 3:4]
    sm_s = models["sd_mean"] * p[..., 4:5]
    slam_s = models["sd_lambda"] * p[..., 5:6]
    # per-strand grouped tables (hpp:117-133), (G, 2, n) each
    stay_t, step_t, skip_t = hmm.grouped_tables(st_params[..., 0],
                                                st_params[..., 1], K)
    step_to_t, skip_to_t = hmm.grouped_tables_to(st_params[..., 0],
                                                 st_params[..., 1], K)

    strand = ev["strand"].long()  # (G, S)
    B = G * S

    def sel(a):  # (G, 2, n) -> (B, n) by each row's strand
        return torch.gather(a, 1, strand[:, :, None].expand(G, S, n)) \
            .reshape(B, n)

    def rows(x):  # (G, S, ...) -> (B, ...)
        return x.reshape(B, *x.shape[2:]).contiguous()

    # drift-corrected events (hpp:147-149)
    corrected = ev["mean"] - pm_params[:, 2][:, None, None] * ev["start"]
    ls_seq, slam_seq = sel(ls_s), sel(slam_s)
    if train_scaling:
        # state weights from the UNSCALED models (hpp:279-284)
        lm_u, ls_u = sel(models["level_mean"]), sel(models["level_stdv"])
        sm_u, slam_u = sel(models["sd_mean"]), sel(models["sd_lambda"])
        w_s0 = 1.0 / (ls_u * ls_u)
        w_s1 = w_s0 * lm_u
        w_s2 = w_s1 * lm_u
        w_l0 = slam_u
        w_l1 = w_l0 / sm_u
        w_l2 = w_l1 / sm_u
        W = torch.stack([w_s0, w_s1, w_s2, w_l0, w_l1, w_l2], dim=1)
    else:
        W = None
    whole = (stay_t, step_t, skip_t, step_to_t, skip_to_t)
    out = {
        "gtf": hmm.GroupedTransFull(*(sel(x[..., cols]) for x in whole),
                                    K=K),
        "model": hmm.ModelArrays(
            level_mean=sel(lm_s), level_stdv=ls_seq,
            log_level_stdv=torch.log(ls_seq), sd_mean=sel(sm_s),
            sd_lambda=slam_seq, log_sd_lambda=torch.log(slam_seq)),
        "ev": {"mean": rows(corrected), "stdv": rows(ev["stdv"]),
               "log_stdv": rows(ev["log_stdv"]),
               "length": rows(ev["length"]).to(torch.int32)},
        "W": W,
        "x_unc": rows(ev["mean"]),
        "t_start": rows(ev["start"]),
        "valid": rows(ev["valid"]),
        "subset": torch.from_numpy(st_train_mask(K)[cols] > 0).to(
            pm_params.device),
        "p_stay_seq": rows(torch.gather(st_params[..., 0], 1, strand)),
        "p_skip_seq": rows(torch.gather(st_params[..., 1], 1, strand)),
    }
    if states is not None:
        N = whole[0].shape[-1]

        def sel_all(a):  # (G, 2, N) -> (B, N)
            return torch.gather(a, 1, strand[:, :, None].expand(G, S, N)) \
                .reshape(B, N)

        out["books"] = hmm.bwd_codebooks(hmm.GroupedTransFull(
            *(sel_all(x) for x in whole), K=K))[1]
    return out


def em_backward_args(inp: dict, lpd, alphas, train_scaling: bool,
                     train_transitions: bool) -> tuple:
    """em.fused_bwd_mstats' arguments from round_inputs' dict and K4's
    outputs."""
    return (inp["gtf"], inp["model"], inp["ev"], lpd, alphas, inp["W"],
            inp["x_unc"], inp["t_start"], inp["valid"], inp["subset"],
            inp["p_stay_seq"], inp["p_skip_seq"], train_scaling,
            train_transitions)


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32: TF32 off for the call, as the JAX package's
    precision="highest" einsum (nanocall_tpu/train.py:609-612)."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _select_rows(inp: dict, rows: torch.Tensor) -> tuple:
    """round_inputs' E-step inputs (gtf, model, ev) of the given rows."""
    def sel(x):
        return x.index_select(0, rows)

    gtf = inp["gtf"]
    return (hmm.GroupedTransFull(*(sel(x) for x in gtf[:5]), K=gtf.K),
            hmm.ModelArrays(*(sel(x) for x in inp["model"])),
            {k: sel(v) for k, v in inp["ev"].items()})


def _legacy_estep(inp: dict, default_ops, default_priors) -> dict:
    """The E-step of a round under a loaded table (nanocall_tpu/train.py:
    566-580): a row whose strand's (p_stay, p_skip) equal the CLI priors in
    float32 takes the generic forward-backward over default_ops (K6c),
    every other row the grouped one (K4, K6d).  The JAX package runs both
    over every row and selects; rows are independent, so running each only
    over its own rows gives the same values.  Returns {alpha, beta, em
    (B, T, n), log_pr_data (B,)}."""
    pri_stay, pri_skip = (float(p) for p in np.float32(default_priors))
    use_seq = ((inp["p_stay_seq"] == pri_stay)
               & (inp["p_skip_seq"] == pri_skip))
    B, T = inp["x_unc"].shape
    n = inp["model"].level_mean.shape[-1]
    out = {k: torch.empty((B, T, n), dtype=torch.float32,
                          device=use_seq.device)
           for k in ("alpha", "beta", "em")}
    out["log_pr_data"] = torch.empty(B, dtype=torch.float32,
                                     device=use_seq.device)
    for generic in (True, False):
        rows = torch.nonzero(use_seq == generic)[:, 0]
        if not len(rows):
            continue
        gtf, model, ev = _select_rows(inp, rows)
        fb = (hmm.fwbw(default_ops, model, ev) if generic
              else hmm.fwbw_grouped(gtf, model, ev))
        for k, v in fb.items():
            out[k].index_copy_(0, rows, v)
        del fb
    return out


def _legacy_moments(fb: dict, inp: dict, G: int) -> dict:
    """The 14 per-group scaling moments of em.SCAL_NAMES from materialized
    posteriors (nanocall_tpu/train.py:591-640): exp(alpha + beta - lpd)
    over the valid events, contracted with the state weights W in full
    float32, then summed over each group's rows and events."""
    lengths, valid = inp["ev"]["length"], inp["valid"]
    B, T = inp["x_unc"].shape
    t_idx = torch.arange(T, device=lengths.device)
    w = (t_idx[None, :] < lengths[:, None]) & valid[:, None]  # (B, T)
    post = torch.exp(fb["alpha"] + fb["beta"]
                     - fb["log_pr_data"][:, None, None]) * w[:, :, None]
    stats = _matmul_fp32(post, inp["W"].transpose(1, 2))  # (B, T, 6)
    del post
    s0, s1, s2, l0, l1, l2 = stats.unbind(-1)
    x, ts, y = inp["x_unc"], inp["t_start"], inp["ev"]["stdv"]

    def acc(v):  # (B, T) -> (G,): each group's rows and events
        return v.reshape(G, -1).sum(dim=1)

    return {"A00": acc(s0), "A01": acc(s1), "A11": acc(s2),
            "A02": acc(s0 * ts), "A12": acc(s1 * ts), "A22": acc(s0 * ts * ts),
            "B0": acc(s0 * x), "B1": acc(s1 * x), "B2": acc(s0 * x * ts),
            "D": acc(s0 * x * x), "Vn": acc(l2 * y), "Vd": acc(l1),
            "Up": acc(l0 / y), "Ne": acc(w.to(torch.float32))}


def _legacy_st_totals(fb: dict, inp: dict, strand, G: int) -> list:
    """Per strand, the (denom, stay, skip) log totals of the transition
    update from materialized posteriors (nanocall_tpu/train.py:700-786,
    _train_st_params): the stay and step joints of each transition t in
    log space over all states, masked to the training k-mers and the valid
    transitions, each reduced over a group's rows, transitions and states.
    strand (G, S) is each row's strand.  Returns [(denom, stay, skip) of
    (G,) for strand 0, for strand 1]."""
    alpha, beta, em = fb["alpha"], fb["beta"], fb["em"]
    B, T, n = alpha.shape
    lpd_b = fb["log_pr_data"][:, None, None]
    a_i = alpha[:, :-1]
    lp_j1 = a_i + beta[:, :-1] - lpd_b  # log Pr[S_t = j1]
    p_stay, p_skip = inp["p_stay_seq"], inp["p_skip_seq"]
    log_p_stay = torch.log(p_stay)[:, None, None]
    log_p_step4 = (torch.log(1.0 - p_stay - p_skip)
                   - math.log(4.0))[:, None, None]
    g = em[:, 1:] + beta[:, 1:]
    lp_stay = torch.minimum(a_i + log_p_stay + g - lpd_b, lp_j1)
    # the 4 step successors of j1 are the contiguous 4-block at
    # suffix(j1, K-1) << 2: 4-block sums of exp(g), tiled over the states
    m_g = torch.amax(g, dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m_g), m_g, 0.0)
    eg4 = torch.exp(g - safe_m).reshape(B, T - 1, n // 4, 4).sum(dim=-1)
    lsum4 = safe_m + torch.log(eg4).repeat(1, 1, 4)
    lp_steps = a_i + log_p_step4 + lsum4 - lpd_b
    del g, eg4, lsum4
    lp_d01 = torch.minimum(torch.logaddexp(lp_stay, lp_steps), lp_j1)
    del lp_steps
    lp_d2 = torch.log(torch.clamp_min(torch.exp(lp_j1) - torch.exp(lp_d01),
                                      0.0))
    del lp_d01
    t_idx = torch.arange(T - 1, device=alpha.device)
    w_tr = ((t_idx[None, :] < inp["ev"]["length"][:, None] - 1)
            & inp["valid"][:, None])
    w_tr = w_tr[:, :, None] & inp["subset"][None, None, :]  # (B, T-1, n)
    totals = []
    for st in (0, 1):
        mask = ((strand == st).reshape(B)[:, None, None] & w_tr) \
            .reshape(G, -1)

        def red(x):
            return _masked_lse(x.reshape(G, -1), mask, 1)

        totals.append((red(lp_j1), red(lp_stay), red(lp_d2)))
    return totals


def _scaling_mstep(acc: dict, pm_params, train_drift: bool):
    """The scaling M-step from a group's moments (hpp:300-430): the 3x3
    weighted-least-squares solve for (shift, scale, drift) and the var,
    scale_sd and var_sd updates.  Returns (new pm_params (G, 6), done (G,)
    bool); a singular solve, or a non-finite or non-positive var or var_sd,
    keeps the group's current params and sets done, so NaN params never
    reach decode."""
    A00, A01, A11 = acc["A00"], acc["A01"], acc["A11"]
    B0, B1 = acc["B0"], acc["B1"]
    if train_drift:
        A02, A12, A22, B2 = acc["A02"], acc["A12"], acc["A22"], acc["B2"]
    else:
        Z = torch.zeros_like(A00)
        A02, A12, B2 = Z, Z, Z
        A22 = torch.ones_like(A00)  # hpp:318-321
    D = acc["D"]
    V_numer, V_denom = acc["Vn"], acc["Vd"]
    U_pos = acc["Up"]
    n_events_tot = acc["Ne"]
    A = torch.stack([
        torch.stack([A00, A01, A02], dim=-1),
        torch.stack([A01, A11, A12], dim=-1),
        torch.stack([A02, A12, A22], dim=-1),
    ], dim=-2)
    x_hat, done = _solve3_pivoted(A, torch.stack([B0, B1, B2], dim=-1),
                                  train_drift)
    a_hat, b_hat, c_hat = x_hat[:, 0], x_hat[:, 1], x_hat[:, 2]
    # var update (hpp:406-418)
    d_numer = (
        D
        + a_hat * a_hat * A00
        + b_hat * b_hat * A11
        + c_hat * c_hat * A22
        + 2.0 * a_hat * b_hat * A01
        + 2.0 * a_hat * c_hat * A02
        + 2.0 * b_hat * c_hat * A12
        - 2.0 * (a_hat * B0 + b_hat * B1 + c_hat * B2)
    )
    d_hat = torch.sqrt(torch.clamp_min(d_numer, 0.0) / n_events_tot)
    v_hat = V_numer / V_denom  # scale_sd (hpp:422)
    u_hat = n_events_tot / (U_pos - V_denom / v_hat)  # var_sd (hpp:426)
    new_pm = torch.stack([b_hat, a_hat, c_hat, d_hat, v_hat, u_hat], dim=-1)
    bad = (~torch.isfinite(new_pm).all(dim=-1) | (d_hat <= 0.0)
           | (u_hat <= 0.0))
    done = done | bad
    return torch.where(done[:, None], pm_params, new_pm), done


def _st_mstep(totals: list, ev: dict, st_params):
    """The transition M-step (hpp:514-530): per strand, p_stay and p_skip
    from the (denom, stay, skip) log totals, clamped to [0.05, 0.4]; a
    strand with no training rows in a group keeps its current params.
    Returns new st_params (G, 2, 2)."""
    strand = ev["strand"].long()
    has_rows = ev["valid"] & (ev["length"] > 1)
    new_st = []
    for st, (denom, num_stay, num_skip) in enumerate(totals):
        p_stay_new = torch.clamp(torch.exp(num_stay - denom), ST_CLAMP_LO,
                                 ST_CLAMP_HI)
        p_skip_new = torch.clamp(torch.exp(num_skip - denom), ST_CLAMP_LO,
                                 ST_CLAMP_HI)
        has_seqs = torch.any((strand == st) & has_rows, dim=1)
        p_stay_new = torch.where(has_seqs, p_stay_new, st_params[:, st, 0])
        p_skip_new = torch.where(has_seqs, p_skip_new, st_params[:, st, 1])
        new_st.append(torch.stack([p_stay_new, p_skip_new], dim=-1))
    return torch.stack(new_st, dim=1)


def train_one_round(ev: dict, models: dict, pm_params: torch.Tensor,
                    st_params: torch.Tensor, K: int = 6,
                    train_drift: bool = True, train_scaling: bool = True,
                    train_transitions: bool = True, default_ops=None,
                    default_priors=None) -> dict:
    """One EM round over a batch of training groups
    (Parameter_Trainer::train_one_round, hpp:541-579;
    nanocall_tpu/train.py:323-697).

    ev: (G, S, T) float32 {mean, stdv, log_stdv, start} with the
    UNCORRECTED means, and (G, S) int32 length / strand and bool valid.
    models: (G, 2, n) float32 {level_mean, level_stdv, sd_mean, sd_lambda},
    or a bank of (M, 2, n) tables plus a (G,) 'model_idx'.  pm_params
    (G, 6) scaling rows (scale, shift, drift, var, scale_sd, var_sd);
    st_params (G, 2, 2) (p_stay, p_skip) per strand.

    Without default_ops, the fused round: K4 stores the alphas and K5 folds
    the backward pass into the statistics; with neither train flag the
    round only scores (K4 stores no alphas, K5 does not run).

    default_ops / default_priors: a loaded table (`--trans`, a TransOps)
    and the (2,) CLI priors (p_stay, p_skip).  The reference E-steps under
    the loaded table while a strand's st params are still the priors,
    round 1 of every group included (Parameter_Trainer.hpp:117-133), so
    the round is the legacy one: each row E-steps under the loaded table
    while its strand is at the priors and by the grouped tables otherwise
    (_legacy_estep), and the statistics are reduced from the materialized
    alpha, beta and em.

    Returns {fit (G,), new_pm_params (G, 6), done (G,) bool,
    new_st_params (G, 2, 2)}; fit is the summed log Pr[data] of the valid
    rows under the current parameters."""
    G, S, T = ev["mean"].shape
    inp = round_inputs(ev, models, pm_params, st_params, K, train_scaling)
    train_any = train_scaling or train_transitions
    if default_ops is None:
        alphas, lpd = hmm.fwbw_grouped_forward(inp["gtf"], inp["model"],
                                               inp["ev"],
                                               with_alphas=train_any)
        scal = st3 = None
        if train_any:
            scal, st3 = em.fused_bwd_mstats(*em_backward_args(
                inp, lpd, alphas, train_scaling, train_transitions))
        del alphas
        return fused_round_outputs(ev, pm_params, st_params, inp["valid"],
                                   lpd, scal, st3, train_drift,
                                   train_scaling, train_transitions)
    fb = _legacy_estep(inp, default_ops, default_priors)
    out = _untrained_outputs(pm_params, st_params, _sum_seqs(
        torch.where(inp["valid"], fb["log_pr_data"], 0.0), G))
    acc = _legacy_moments(fb, inp, G) if train_scaling else None
    totals = (_legacy_st_totals(fb, inp, ev["strand"], G)
              if train_transitions else None)
    del fb
    return _msteps(out, acc, totals, ev, pm_params, st_params, train_drift)


def _untrained_outputs(pm_params, st_params, fit) -> dict:
    """A round's outputs before its M-steps: the parameters unchanged."""
    return {"new_pm_params": pm_params,
            "done": torch.zeros(pm_params.shape[0], dtype=torch.bool,
                                device=pm_params.device),
            "new_st_params": st_params, "fit": fit}


def _msteps(out: dict, acc, totals, ev, pm_params, st_params,
            train_drift: bool) -> dict:
    """out with the M-steps of the statistics given (acc: the scaling
    moments, totals: the transition log totals; None: not trained)."""
    if acc is not None:
        out["new_pm_params"], out["done"] = _scaling_mstep(acc, pm_params,
                                                           train_drift)
    if totals is not None:
        out["new_st_params"] = _st_mstep(totals, ev, st_params)
    return out


def fused_round_outputs(ev: dict, pm_params, st_params, valid, lpd, scal,
                        st3, train_drift: bool, train_scaling: bool,
                        train_transitions: bool) -> dict:
    """The fused round's outputs from its kernels' per-row results for G
    groups (ev, pm_params and st_params as train_one_round's): fit from
    log Pr[data] lpd (G*S,) of the valid rows, and the M-steps from K5's
    scal (G*S, 14) and st3 (G*S, 3) (None: the round only scores).  The
    placed round (parallel/statepar.py) runs it on each data row's
    groups."""
    G, S = ev["mean"].shape[:2]
    out = _untrained_outputs(pm_params, st_params,
                             _sum_seqs(torch.where(valid, lpd, 0.0), G))
    if scal is None:
        return out
    acc = ({k: _sum_seqs(scal[:, i], G) for i, k in enumerate(em.SCAL_NAMES)}
           if train_scaling else None)
    totals = ([tuple(_masked_lse(st3[:, q].reshape(G, S),
                                 ev["strand"] == st, 1) for q in range(3))
               for st in (0, 1)] if train_transitions else None)
    return _msteps(out, acc, totals, ev, pm_params, st_params, train_drift)


# ---------------------------------------------------------------------------
# the EM loop (stopping rules of nanocall.cpp:367-426)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EMConfig:
    max_rounds: int = 10  # --scaling-max-rounds
    min_progress: float = 1.0  # --scaling-min-progress
    train_drift: bool = True
    train_scaling: bool = True
    train_transitions: bool = True
    double_strand: bool = True  # doubles the round cap (nanocall.cpp:420)
    K: int = 6

    def caps(self, joint) -> np.ndarray:
        """Per-group round caps: (2 if joint else 1) * max_rounds
        (nanocall.cpp:420 vs :534: the cap is per candidate)."""
        joint = np.asarray(joint, bool)
        return np.where(joint, 2 * self.max_rounds,
                        self.max_rounds).astype(np.int32)


def run_em(ev: dict, models: dict, pm_params0: torch.Tensor,
           st_params0: torch.Tensor, cfg: EMConfig, caps=None,
           state0: tuple | None = None, round_limit: int | None = None,
           default_ops=None, default_priors=None):
    """The EM loop for a batch of G training groups on their device
    (nanocall_tpu/train.py:909-1036 with run_em_device's loop body).

    Per group and round: a singular solve freezes the group with its
    current params; a fit regression reverts the fit and freezes; otherwise
    the new params are accepted, and the group freezes at its round cap
    (`caps`, (G,) from EMConfig.caps; default cfg.double_strand's cap for
    all) or, after round 1, when the fit gained less than min_progress.
    The loop ends when every group is frozen (one host read per round) or
    after max(caps) rounds.

    state0 = (fit, frozen, rounds) resumes a previous call's per-group
    carry and round_limit caps this call's rounds without changing the
    caps: a run split that way follows the same trajectory as one
    uninterrupted run (two-phase EM).  default_ops / default_priors: a
    loaded table and the CLI priors, for train_one_round.

    Returns (pm_params (G, 6), st_params (G, 2, 2), fit (G,) float32,
    rounds (G,) int32, frozen (G,) bool), tensors on the batch's device."""
    dev = pm_params0.device
    G = pm_params0.shape[0]
    if caps is None:
        caps = np.full(G, (2 if cfg.double_strand else 1) * cfg.max_rounds,
                       np.int32)
    # the reference's cap check runs after ++round (nanocall.cpp:420,536),
    # so even --scaling-max-rounds 0 trains one round
    caps = np.maximum(np.asarray(caps, np.int32), 1)
    max_rounds = int(caps.max()) if G else 0
    if round_limit is not None:
        max_rounds = min(max_rounds, int(round_limit))
    caps_t = torch.as_tensor(caps, device=dev)
    if state0 is None:
        fit = torch.full((G,), _NEG_INF, dtype=torch.float32, device=dev)
        frozen = torch.zeros(G, dtype=torch.bool, device=dev)
        rounds = torch.zeros(G, dtype=torch.int32, device=dev)
    else:
        fit, frozen, rounds = (
            torch.as_tensor(x, dtype=dt, device=dev)
            for x, dt in zip(state0, (torch.float32, torch.bool,
                                      torch.int32)))
    pm = pm_params0.to(torch.float32)
    st = st_params0.to(torch.float32)
    min_progress = torch.tensor(cfg.min_progress, dtype=torch.float32,
                                device=dev)
    round_no = 0
    while round_no < max_rounds and not bool(frozen.all()):
        out = train_one_round(
            ev, models, pm, st, K=cfg.K, train_drift=cfg.train_drift,
            train_scaling=cfg.train_scaling,
            train_transitions=cfg.train_transitions,
            default_ops=default_ops, default_priors=default_priors)
        done = out["done"]
        active = ~frozen
        crt_fit = torch.where(active, out["fit"], fit)
        frozen2 = frozen | (active & done)
        regress = active & ~done & (crt_fit < fit)
        crt_fit = torch.where(regress, fit, crt_fit)
        frozen2 = frozen2 | regress
        advance = active & ~done & ~regress
        pm = torch.where(advance[:, None], out["new_pm_params"], pm)
        st = torch.where(advance[:, None, None], out["new_st_params"], st)
        rounds = torch.where(advance, rounds + 1, rounds)
        cap_hit = advance & (rounds >= caps_t)
        no_progress = advance & (rounds > 1) & (crt_fit < fit + min_progress)
        frozen = frozen2 | cap_hit | no_progress
        fit = crt_fit
        round_no += 1
    return pm, st, fit, rounds, frozen
