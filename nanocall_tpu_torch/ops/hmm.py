"""HMM kernels on PyTorch tensors, with hand-written CUDA kernels.

Port of nanocall_tpu/ops/hmm.py's Viterbi decode and forward-backward: the
grouped kernels of the default path, and the generic kernels that run under
a loaded transition table.  Every function takes tensors on one
device and dispatches by that device:

  - CPU tensors run the plain PyTorch version (a Python loop over events on
    (B, n) tensors, in the JAX scan body's op order);
  - CUDA tensors run the hand-written kernel (csrc/, built by ops/_cuda.py),
    or the call raises.  There is no fallback from a kernel to its plain
    version.

Kernels and their plain versions, side by side below:

  K1  viterbi_forward.cu    forward_path_kernel / forward_score_kernel
                            vs viterbi_forward_grouped_plain
  K2  viterbi_traceback.cu  traceback_kernel vs viterbi_traceback_grouped_plain
  K3  viterbi_forward.cu    forward_chunk_kernel
                            vs viterbi_forward_grouped_chunk_plain
      viterbi_traceback.cu  traceback_chunk_kernel
                            vs viterbi_traceback_grouped_chunk_plain
  K1m viterbi_forward.cu    forward_wave_kernel
                            vs viterbi_forward_wave_plain
  K2m viterbi_traceback.cu  traceback_slices_kernel (a ring stage by one
                            tensor copy, or by a bulk copy a row and rank
                            across cards: slices_walk_route; the stage
                            fill's plain twins tensor_stage_plain,
                            copies_stage_plain)
                            vs viterbi_traceback_slices_plain
      (parallel/statepar.py: K1 and K2 with the states split over ranks)
  K9  (parallel/seqpar.py, over K3's forward chunk)
      viterbi_traceback.cu  traceback_chunk_states_kernel vs
                            viterbi_traceback_grouped_chunk_plain
                            (compact=False)
  K4  fwbw_forward.cu       fwbw_forward_kernel vs fwbw_grouped_forward_plain
  K4m fwbw_forward.cu       fwbw_forward_wave_kernel
                            vs fwbw_forward_wave_plain
      (parallel/statepar.py: K4 with the states split over ranks; K5m,
      its backward half, is in ops/em.py)
  K6a viterbi_generic.cu    generic_forward_path_kernel /
                            generic_forward_score_kernel (streaming),
                            resident_forward_path_kernel /
                            resident_forward_score_kernel (the table in
                            shared memory; generic_forward_route picks)
                            vs viterbi_forward_plain
  K6b viterbi_generic.cu    generic_traceback_kernel (streaming),
      viterbi_traceback.cu  generic_traceback_ring_kernel (K2's row ring, the
                            from-state table in shared memory;
                            generic_traceback_route picks)
                            vs viterbi_traceback_plain
  K6am viterbi_generic.cu   generic_wave_resident_kernel /
                            generic_wave_streaming_kernel
                            vs viterbi_forward_generic_wave_plain
  K6bm viterbi_traceback.cu generic_traceback_slices_kernel (K2m's routes)
                            vs viterbi_traceback_generic_slices_plain
      (parallel/statepar.py: K6a and K6b with the states split over ranks)
  K6c fwbw_split.cu         fwbw_generic_kernel (streaming: a read's
                            states over a cluster of 8 blocks),
      fwbw_generic.cu       fwbw_resident_kernel (both sides' tables in
                            shared memory in turn; fwbw_route picks)
                            vs fwbw_plain
  K6cm fwbw_generic_wave.cu fwbw_wave_resident_kernel /
                            fwbw_wave_streaming_kernel
                            (fwbw_generic_wave_kernel picks)
                            vs fwbw_generic_wave_plain
      (parallel/statepar.py: K6c with the states split over ranks, the
      legacy EM round's rows at the priors; K6dm, K6d split so, is in
      ops/em.py)
  K6d fwbw_backward.cu      fwbw_backward_kernel
                            vs fwbw_grouped_backward_plain
  K6e fwbw_split.cu         fwbw_custom_kernel (streaming, as K6c's),
      fwbw_custom.cu        fwbw_custom_resident_kernel (K6c's resident
                            tables; fwbw_route picks) vs fwbw_custom_plain
  (K5, the fused EM backward, is in ops/em.py; ops/kernels.py lists them all.)

K6a-K6c and K6e run under a loaded transition table (TransOps, `--trans`,
and the dev tools): every state's in- and out-neighbours are gathered
through (deg, n) index tables.  K6a and K6b also take per-read structured
tables (make_trans_ops_batch).

Each kernel wrapper counts its launches in a plain int attribute
(`wrapper.launches`), incremented (by _cuda.count_launch, under a lock) only
where it launches the kernel.

Numerics: the kernels are built with -fmad=false, so on the same card they
are bit-identical to the plain versions.  Sums whose order torch leaves
undefined are written out in the plain versions in one fixed order that the
kernels follow: r-ordered 4- and 16-way sums, and full-width sums as a
pairwise tree (`tree_sum`).  Against the JAX package the port agrees to
float32 rounding: XLA fuses and reorders the jitted emission expression and
its sums, and jnp.log and torch.log differ in the last bit on some inputs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kmer, transitions
from ..pore_model import LOG_2PI
from . import _cuda

#: from-state sentinel for the lowest-from-state tie-break
_BIG = 2**31 - 1


class ModelArrays(NamedTuple):
    """Scaled pore-model tables, (..., n) float32, with the logs the
    emission needs precomputed (nanocall_tpu/ops/hmm.py:172)."""

    level_mean: torch.Tensor
    level_stdv: torch.Tensor
    log_level_stdv: torch.Tensor
    sd_mean: torch.Tensor
    sd_lambda: torch.Tensor
    log_sd_lambda: torch.Tensor


class GroupedTrans(NamedTuple):
    """Grouped (stay, step, skip) log-prob tables, (..., n) float32
    (nanocall_tpu/ops/hmm.py:258)."""

    stay_lp: torch.Tensor
    step_lp: torch.Tensor
    skip_lp: torch.Tensor
    K: int


class GroupedTransFull(NamedTuple):
    """Grouped tables for both recursion directions, (..., n) float32
    (nanocall_tpu/ops/hmm.py:866): the from-side (stay, step, skip) and the
    to-side (step_to, skip_to); the stay table serves both."""

    stay_lp: torch.Tensor
    step_lp: torch.Tensor
    skip_lp: torch.Tensor
    step_to_lp: torch.Tensor
    skip_to_lp: torch.Tensor
    K: int


class PackedSides(NamedTuple):
    """Both sides of a table in the resident K6c's layout (pack_slots with
    groups = FWBW_GROUPS): (deg, 4096) int16 entries and (deg, FWBW_GROUPS
    * RESIDENT_CODES) float32 codebooks a side; per-read tables
    (make_trans_ops_batch) carry a leading B, read b's layout its own."""

    from_packed: torch.Tensor
    from_codebook: torch.Tensor
    to_packed: torch.Tensor
    to_codebook: torch.Tensor


class TransOps(NamedTuple):
    """A transition table as (deg, n) slot tables on the device
    (nanocall_tpu/ops/hmm.py:42-79, one layout for the sparse and the
    structured form): destination j's slot k comes from state
    from_idx[k, j] (int32) with log-prob from_logp[k, j] (float32); source
    i's slot k goes to to_idx[k, i] with to_logp[k, i].  Padded slots have
    log-prob -inf and index 0.  from_packed / from_codebook: the from side
    in the resident K6a's layout (resident_layout: (deg, n) int16 entries
    and (G deg, RESIDENT_CODES) float32 codebooks, block-major, G of
    RESIDENT_GROUPS codebooks a slot, which resident_groups reads from the
    shapes), computed once per table, or None for a table without one;
    fwbw_packed: both sides in the resident K6c's and K6e's layout
    (FWBW_GROUPS codebooks a slot), or None unless both sides have it;
    from_states: the from-states as a (deg, n) uint16 table for K6b's ring
    kernel (from_state_table), or None for a table of more slots than fit
    beside its ring.  convert.trans_ops builds one.

    The per-read form (make_trans_ops_batch, JAX's make_trans_ops_batch:
    read b runs under its own structured table) has (B, deg, n) from_logp
    / to_logp and, where every read's table packs, a (B, deg, n)
    from_packed and (B, G deg, RESIDENT_CODES) from_codebook (one G for
    every read), and where every read's two sides pack, fwbw_packed of (B,
    deg, n) entries and (B, deg, FWBW_GROUPS * RESIDENT_CODES) codebooks a
    side; from_idx, to_idx and from_states stay (deg, n), the fixed slot
    map every read shares.  The Viterbi decode (K6a, K6b) and the
    forward-backward (K6c, K6e) take it; the forward-backward on the mesh's
    state axis (K6cm) raises (refuse_per_read)."""

    from_idx: torch.Tensor
    from_logp: torch.Tensor
    to_idx: torch.Tensor
    to_logp: torch.Tensor
    K: int
    from_packed: torch.Tensor | None = None
    from_codebook: torch.Tensor | None = None
    fwbw_packed: PackedSides | None = None
    from_states: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# tables and scaled models on the device (plain torch, no kernels: the
# JAX package leaves these to XLA)
# ---------------------------------------------------------------------------


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for an int y >= 1 by repeated squaring, in the multiplication
    order of jax.lax.integer_pow (which `jnp_array ** int` lowers to)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _grouped_tables(p_stay, p_skip, K: int, masks: dict, with_stay: bool):
    """The float32 pipeline of transitions.grouped_tables(..., xp=jnp) and
    grouped_tables_to(..., xp=jnp) over their condition masks: (stay_lp
    when with_stay,) step_lp, skip_lp, each (..., n)."""
    n = kmer.n_states(K)
    dev = p_stay.device

    def mask(name):
        return torch.from_numpy(masks[name]).to(dev)

    p_stay = p_stay.to(torch.float32)[..., None]
    p_skip = p_skip.to(torch.float32)[..., None]
    p_step = 1.0 - p_stay - p_skip
    p_skip_1 = p_skip / (p_skip + 1.0)
    bg = (_ipow(p_skip_1, K - 1) / (1.0 - p_skip_1)) / n

    def term(l):
        return _ipow(p_skip_1, l - 1) / (1 << (2 * l))

    out = []
    if with_stay:
        stay = p_stay + mask("stay_l1") * (p_step / 4.0) + bg
        for l in range(2, K):
            stay = stay + mask(f"stay_l{l}") * term(l)
        out.append(torch.log(stay))
    step = p_step / 4.0 + bg
    for l in range(2, K):
        step = step + mask(f"step_l{l}") * term(l)
    skip = term(2) + bg
    for l in range(3, K):
        skip = skip + mask(f"skip_l{l}") * term(l)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    return (*out, torch.log(step + zeros), torch.log(skip + zeros))


def grouped_tables(p_stay: torch.Tensor, p_skip: torch.Tensor, K: int):
    """(stay_lp, step_lp, skip_lp), each (..., n) float32: the float32
    pipeline of transitions.grouped_tables(..., xp=jnp)
    (nanocall_tpu/transitions.py:342-389) over the same condition masks."""
    return _grouped_tables(p_stay, p_skip, K,
                           transitions.grouped_condition_masks(K), True)


def make_grouped_trans_device(p_stay, p_skip, K: int = 6) -> GroupedTrans:
    """Per-task grouped tables from (B,) params, built on their device
    (nanocall_tpu/ops/hmm.py:199-206)."""
    stay, step, skip = grouped_tables(p_stay, p_skip, K)
    return GroupedTrans(stay_lp=stay, step_lp=step, skip_lp=skip, K=K)


def grouped_tables_to(p_stay: torch.Tensor, p_skip: torch.Tensor, K: int):
    """(step_to_lp, skip_to_lp), each (..., n) float32: the float32 pipeline
    of transitions.grouped_tables_to(..., xp=jnp)
    (nanocall_tpu/transitions.py:414-439)."""
    return _grouped_tables(p_stay, p_skip, K,
                           transitions.grouped_condition_masks_to(K), False)


def make_grouped_full_device(p_stay, p_skip, K: int = 6) -> GroupedTransFull:
    """Both directions' grouped tables from (...,) params, built on their
    device (nanocall_tpu/ops/hmm.py:878-887)."""
    stay, step, skip = grouped_tables(p_stay, p_skip, K)
    step_to, skip_to = grouped_tables_to(p_stay, p_skip, K)
    return GroupedTransFull(stay_lp=stay, step_lp=step, skip_lp=skip,
                            step_to_lp=step_to, skip_to_lp=skip_to, K=K)


def correction_masks(K: int, device) -> dict:
    """{H, P2mH, S5, S5T}: (n,) float32 0/1 tensors on `device`, the
    exceptional-state masks of the grouped log-sum-exp decomposition
    (transitions.grouped_correction_masks)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in transitions.grouped_correction_masks(K).items()}


def mask_flags(masks: dict, bits: dict) -> torch.Tensor:
    """(n,) uint8: bit `bits[name]` set where masks[name] is 1 — the masks
    as one byte per state, as the kernels read them."""
    flags = None
    for name, bit in bits.items():
        f = (masks[name] > 0).to(torch.uint8) << bit
        flags = f if flags is None else flags | f
    return flags.contiguous()


def make_model_arrays(level_mean, level_stdv, sd_mean, sd_lambda,
                      B: int = 1) -> ModelArrays:
    """One model's tables as the (B, n) rows the kernels read
    (nanocall_tpu/ops/hmm.py:184-196, whose (n,) arrays broadcast against
    the batch): the four (n,) tensors on one device as float32, with
    torch.log of level_stdv and sd_lambda, each repeated in B rows."""
    lm, ls, sm, slam = (x.to(torch.float32)
                        for x in (level_mean, level_stdv, sd_mean, sd_lambda))
    return ModelArrays(*(x.expand(B, -1).contiguous() for x in (
        lm, ls, torch.log(ls), sm, slam, torch.log(slam))))


def make_scaled_model_arrays(bank: dict, model_idx, params) -> ModelArrays:
    """Per-task scaled model tables (nanocall_tpu/ops/hmm.py:209-227, with
    pore_model.scale_arrays): bank is {level_mean, level_stdv, sd_mean,
    sd_lambda} of (M, n) float32; model_idx (B,) int; params (B, 6) rows of
    (scale, shift, drift, var, scale_sd, var_sd)."""
    idx = model_idx.long()
    lm = bank["level_mean"][idx] * params[:, 0:1] + params[:, 1:2]
    ls = bank["level_stdv"][idx] * params[:, 3:4]
    sm = bank["sd_mean"][idx] * params[:, 4:5]
    slam = bank["sd_lambda"][idx] * params[:, 5:6]
    return ModelArrays(
        level_mean=lm, level_stdv=ls, log_level_stdv=torch.log(ls),
        sd_mean=sm, sd_lambda=slam, log_sd_lambda=torch.log(slam),
    )


def log_emission(m: ModelArrays, ev_mean, ev_stdv, ev_log_stdv):
    """log Pr[event | state] over all states, in the op order of
    nanocall_tpu/ops/hmm.py:230-244 (K1 inlines the same sequence).

    ev_*: (...,) per batch element; model arrays (..., n).  Returns (..., n).
    """
    x = ev_mean[..., None]
    a = (x - m.level_mean) / m.level_stdv
    lnorm = -m.log_level_stdv - (LOG_2PI + a * a) * 0.5
    y = ev_stdv[..., None]
    b = (y - m.sd_mean) / m.sd_mean
    linv = (
        m.log_sd_lambda - LOG_2PI - 3.0 * ev_log_stdv[..., None]
        - m.sd_lambda * b * b / y
    ) * 0.5
    return lnorm + linv


# ---------------------------------------------------------------------------
# K1: grouped Viterbi forward
# ---------------------------------------------------------------------------


def _grouped_step_core(gt: GroupedTrans, alpha: torch.Tensor, lo: int = 0):
    """One grouped max-plus step (nanocall_tpu/ops/hmm.py:286-347):
    alpha (B, n) -> (best (B, W) pre-emission scores, bp (B, W) uint8) for
    the destination states [lo, lo + W) that gt's (B, W) tables hold (all
    n by default; K1m's ranks step their slice of the states from the whole
    column), bp = (group << 6) | within-group first argmax, ties to the
    lowest from-state."""
    B, n = alpha.shape
    W = gt.stay_lp.shape[-1]
    K = gt.K
    cols = slice(lo, lo + W)
    j = torch.arange(lo, lo + W, dtype=torch.int32, device=alpha.device)

    def colmax(a):  # (B, R, m) -> max, first argmax over R (strict > in r)
        m = a[:, 0]
        g = torch.zeros_like(m, dtype=torch.int32)
        for r in range(1, a.shape[1]):
            take = a[:, r] > m
            m = torch.where(take, a[:, r], m)
            g = torch.where(take, r, g)
        return m, g

    m4, g4 = colmax(alpha.view(B, 4, n // 4))
    m16, g16 = colmax(alpha.view(B, 16, n // 16))

    v0 = gt.stay_lp + alpha[:, cols]
    v1 = gt.step_lp + m4.repeat_interleave(4, dim=1)[:, cols]
    v2 = gt.skip_lp + m16.repeat_interleave(16, dim=1)[:, cols]
    best = torch.maximum(torch.maximum(v0, v1), v2)

    arg4 = g4.repeat_interleave(4, dim=1)[:, cols]
    arg16 = g16.repeat_interleave(16, dim=1)[:, cols]
    f1 = (arg4 << (2 * (K - 1))) | (j >> 2)
    f2 = (arg16 << (2 * (K - 2))) | (j >> 4)
    k0 = torch.where(v0 == best, j, _BIG)
    k1 = torch.where(v1 == best, f1, _BIG)
    k2 = torch.where(v2 == best, f2, _BIG)
    fmin = torch.minimum(torch.minimum(k0, k1), k2)
    bp = torch.where(k0 == fmin, 0,
                     torch.where(k1 == fmin, 64 + arg4, 128 + arg16))
    return best, bp.to(torch.uint8)


def viterbi_forward_grouped_plain(gt: GroupedTrans, model: ModelArrays,
                                  ev: dict, with_path: bool = True):
    """Plain version of K1 (nanocall_tpu/ops/hmm.py:350-386): a loop over
    events.  Returns (final_alpha (B, n) float32, bps (T-1, B, n) uint8, or
    None when with_path is False)."""
    n = model.level_mean.shape[-1]
    lengths = ev["length"]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    B, T = mean.shape
    alpha = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0]) \
        - math.log(n)
    bps = (torch.empty((max(T - 1, 0), B, n), dtype=torch.uint8,
                       device=mean.device) if with_path else None)
    for t in range(1, T):
        best, bp = _grouped_step_core(gt, alpha)
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        alpha = torch.where((t < lengths)[:, None], best + em, alpha)
        if with_path:
            bps[t - 1] = bp
    return alpha, bps


def _check(name, x: torch.Tensor, dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _check_tables(tables, B: int, n: int, dev) -> None:
    for i, x in enumerate(tables):
        _check(f"table {i}", x, torch.float32, (B, n), dev)
        if x.data_ptr() % 16:  # the kernels read the tables as float4
            raise ValueError(f"table {i} is not 16-byte aligned")


def _check_events(ev: dict, B: int, T: int, dev) -> None:
    for name in ("mean", "stdv", "log_stdv"):
        _check(f"ev[{name!r}]", ev[name], torch.float32, (B, T), dev)
    _check("ev['length']", ev["length"], torch.int32, (B,), dev)


def _require_cuda(dev, what: str) -> None:
    """Kernel wrappers launch on CUDA tensors only; a CPU tensor never
    reaches a plain version through them."""
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, got {dev}")


def _forward_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict,
                    with_path: bool):
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    n = 4096
    if gt.K != 6:
        raise ValueError(f"the CUDA forward kernel takes K=6, got K={gt.K}")
    if T < 1:
        raise ValueError("the forward pass needs at least one event column")
    _check_events(ev, B, T, dev)
    tables = (gt.stay_lp, gt.step_lp, gt.skip_lp, *model)
    _check_tables(tables, B, n, dev)
    _require_cuda(dev, "viterbi forward")
    final = torch.empty((B, n), dtype=torch.float32, device=dev)
    bps = (torch.empty((T - 1, B, n), dtype=torch.uint8, device=dev)
           if with_path else None)
    lib = _cuda.load()
    err = lib.nc_viterbi_forward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, *(x.data_ptr() for x in tables),
        LOG_2PI, math.log(n), final.data_ptr(),
        bps.data_ptr() if with_path and bps.numel() else None,
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_forward kernel launch")
    return final, bps


def forward_path_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict):
    """K1 on the card, with backpointers: (final_alpha, bps)."""
    out = _forward_kernel(gt, model, ev, with_path=True)
    _cuda.count_launch(forward_path_kernel)
    return out


def forward_score_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict):
    """K1 on the card, score-only (no backpointer stores): final_alpha."""
    final, _ = _forward_kernel(gt, model, ev, with_path=False)
    _cuda.count_launch(forward_score_kernel)
    return final


forward_path_kernel.launches = 0
forward_score_kernel.launches = 0


def viterbi_forward_grouped(gt: GroupedTrans, model: ModelArrays, ev: dict,
                            with_path: bool = True):
    """K1 on the tensors' device: (final_alpha (B, n), bps (T-1, B, n) uint8
    or None when with_path is False)."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return viterbi_forward_grouped_plain(gt, model, ev, with_path)
    if dev.type != "cuda":
        raise ValueError(f"no grouped Viterbi forward for device {dev}")
    if with_path:
        return forward_path_kernel(gt, model, ev)
    return forward_score_kernel(gt, model, ev), None


# ---------------------------------------------------------------------------
# K2: grouped traceback into bit-packed codes
# ---------------------------------------------------------------------------


def grouped_from_state(bp: torch.Tensor, j: torch.Tensor, K: int):
    """Decode grouped bp bytes (int tensor) into from-states
    (nanocall_tpu/ops/hmm.py:506-514)."""
    group = bp >> 6
    arg = bp & 63
    f_step = (arg << (2 * (K - 1))) | (j >> 2)
    f_skip = (arg << (2 * (K - 2))) | (j >> 4)
    return torch.where(group == 0, j, torch.where(group == 1, f_step, f_skip))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Bit-pack (Tm, B) six-bit codes four per three little-endian bytes ->
    (B, 3*ceil(Tm/4)) uint8 (nanocall_tpu/ops/hmm.py:565-577)."""
    Tm, B = codes.shape
    G = -(-Tm // 4)
    c = torch.zeros((4 * G, B), dtype=torch.int32, device=codes.device)
    c[:Tm] = codes.to(torch.int32)
    c = c.view(G, 4, B)
    w = c[:, 0] | (c[:, 1] << 6) | (c[:, 2] << 12) | (c[:, 3] << 18)
    packed = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], dim=1)
    return packed.to(torch.uint8).reshape(3 * G, B).t().contiguous()


def viterbi_traceback_grouped_plain(K: int, final_alpha, bps, lengths):
    """Plain version of K2 (nanocall_tpu/ops/hmm.py:517-562, compact=True):
    returns (path0 (B,) int32, codes (B, 3*ceil((T-1)/4)) uint8, logp (B,)).
    bps[t-1, b, s] is read directly in place of the two-stage one-hot
    lookup (same bytes)."""
    return _grouped_walk_plain(
        K, final_alpha, bps.shape[0],
        lambda i, rows, s: bps[i, rows, s.long()], lengths)


def _grouped_walk_plain(K: int, final_alpha, Tm: int, byte, lengths):
    """K2's plain walk over Tm backpointer rows: byte(i, rows, s) gives row
    i's bytes at states s (B,) of the reads `rows`."""
    B = final_alpha.shape[0]
    dev = final_alpha.device
    end_state = torch.argmax(final_alpha, dim=-1).to(torch.int32)
    logp = torch.amax(final_alpha, dim=-1)
    lengths = lengths.to(torch.int32)
    rows = torch.arange(B, device=dev)
    codes = torch.zeros((Tm, B), dtype=torch.uint8, device=dev)
    s = end_state
    for t in range(Tm, 0, -1):
        s_eff = torch.where(t == lengths - 1, end_state, s)
        k = byte(t - 1, rows, s_eff).to(torch.int32)
        real = t <= lengths - 1
        s = torch.where(real, grouped_from_state(k, s_eff, K), s_eff)
        codes[t - 1] = torch.where(real, ((k >> 6) << 4) | (s_eff & 15), 0)
    return s, pack_codes(codes), logp


def _check_rows_aligned(bps: torch.Tensor) -> None:
    """The traceback kernels copy whole backpointer rows to shared memory
    by cp.async.bulk, which takes 16-byte aligned addresses."""
    if bps.data_ptr() % 16:
        raise ValueError("bps is not 16-byte aligned")


def _traceback_kernel(K: int, final_alpha, bps, lengths):
    dev = final_alpha.device
    B, n = final_alpha.shape
    if K != 6 or n != 4096:
        raise ValueError(f"the CUDA traceback kernel takes K=6, n=4096; "
                         f"got K={K}, n={n}")
    Tm = bps.shape[0]
    _check("final_alpha", final_alpha, torch.float32, (B, n), dev)
    _check("bps", bps, torch.uint8, (Tm, B, n), dev)
    _check_rows_aligned(bps)
    _check("lengths", lengths, torch.int32, (B,), dev)
    _require_cuda(dev, "viterbi traceback")
    code_bytes = 3 * (-(-Tm // 4))
    path0 = torch.empty(B, dtype=torch.int32, device=dev)
    codes = torch.empty((B, code_bytes), dtype=torch.uint8, device=dev)
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_viterbi_traceback(
        final_alpha.data_ptr(), bps.data_ptr() if bps.numel() else None,
        lengths.data_ptr(), B, Tm + 1, code_bytes, path0.data_ptr(),
        codes.data_ptr() if codes.numel() else None, logp.data_ptr(),
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_traceback kernel launch")
    return path0, codes, logp


def traceback_kernel(K: int, final_alpha, bps, lengths):
    """K2 on the card: (path0, codes, logp)."""
    out = _traceback_kernel(K, final_alpha, bps, lengths)
    _cuda.count_launch(traceback_kernel)
    return out


traceback_kernel.launches = 0


def viterbi_traceback_grouped(K: int, final_alpha, bps, lengths):
    """K2 on the tensors' device: (path0, codes, logp)."""
    dev = final_alpha.device
    if dev.type == "cpu":
        return viterbi_traceback_grouped_plain(K, final_alpha, bps, lengths)
    if dev.type != "cuda":
        raise ValueError(f"no grouped traceback for device {dev}")
    return traceback_kernel(K, final_alpha, bps, lengths)


def viterbi_decode_grouped(gt: GroupedTrans, model: ModelArrays, ev: dict,
                           with_path: bool = True) -> dict:
    """Grouped Viterbi decode (nanocall_tpu/ops/hmm.py:580-606 with
    compact_path=True): {"logp"} when with_path is False, else {"path0",
    "codes", "logp"}; rebuild state paths on the host with
    native.path_from_packed_codes."""
    final_alpha, bps = viterbi_forward_grouped(gt, model, ev, with_path)
    if not with_path:
        return {"logp": torch.amax(final_alpha, dim=-1)}
    path0, codes, logp = viterbi_traceback_grouped(gt.K, final_alpha, bps,
                                                   ev["length"])
    return {"path0": path0, "codes": codes, "logp": logp}


# ---------------------------------------------------------------------------
# K1m, K2m: K1 and K2 with the states split over M ranks (the state axis of
# parallel/statepar.py).  Rank m holds the states [m W, (m + 1) W), W =
# n / M: its (B, W) tables, a (2, B, W) column buffer (its slice of the
# column of event t at parity t % 2), B step counters and its (T - 1, B, W)
# backpointer bytes.  A step reads the whole previous column in place from
# every rank's buffer.
# ---------------------------------------------------------------------------


class WaveRank(NamedTuple):
    """One rank of a data row, on the rank's device: its (B, W) tables and
    scaled model, the row's (B, T) events and (B,) lengths, its column
    buffer col (2, B, W) float32, its backpointers bps (T - 1, B, W) uint8
    (None: score-only) and its step counters flags (B,) int32, zero before
    the decode (K1m's exchange; the plain version leaves them)."""

    gt: GroupedTrans
    model: ModelArrays
    ev: dict
    col: torch.Tensor
    bps: torch.Tensor | None
    flags: torch.Tensor


def gather_column(column, device=None) -> torch.Tensor:
    """A column's M slices, an (M, B, W) tensor or M (B, W) tensors on any
    devices, as (B, M W) states in order, on `device` (the first slice's
    by default)."""
    device = column[0].device if device is None else device
    return torch.cat([c.to(device) for c in column], dim=1)


def viterbi_forward_slice_plain(gt: GroupedTrans, model: ModelArrays,
                                ev: dict, column, t: int, lo: int,
                                alpha_out, bp_out=None) -> None:
    """One rank's step, the plain version of K1m's step body: event t's
    alpha at the states [lo, lo + W) into alpha_out (B, W), and at t >= 1
    their backpointers into bp_out (B, W) uint8 (None: score-only).  gt
    and model hold the rank's (B, W) tables, ev the (B, T) events and
    lengths whole; column is the alpha of event t - 1 as its M slices (an
    (M, B, W) tensor or M (B, W) tensors on any devices, read in place;
    unread at t = 0).  The step of viterbi_forward_grouped_plain for these
    states: -log(n) at t = 0 takes n = M W, all the states."""
    M, W = len(column), column[0].shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    if t == 0:
        alpha_out.copy_(log_emission(model, mean[:, 0], stdv[:, 0],
                                     log_stdv[:, 0]) - math.log(M * W))
        return
    alpha = gather_column(column, mean.device)
    best, bp = _grouped_step_core(gt, alpha, lo)
    em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
    alpha_out.copy_(torch.where((t < ev["length"])[:, None], best + em,
                                alpha[:, lo:lo + W]))
    if bp_out is not None:
        bp_out.copy_(bp)


def viterbi_forward_wave_plain(ranks, lo: int, hi: int) -> None:
    """Plain version of K1m: events 0 .. T - 1 of the reads [lo, hi) for
    every rank of a data row (ranks: its M WaveRanks in rank order).  Each
    step, every rank runs viterbi_forward_slice_plain on the peers' slices
    of the previous column, read in place from their col[(t - 1) % 2], into
    its col[t % 2] and bps[t - 1].  The steps run one after another, so the
    counters are left as they are."""
    rows = slice(lo, hi)
    T, W = ranks[0].ev["mean"].shape[1], ranks[0].col.shape[-1]
    parts = [(GroupedTrans(*(x[rows] for x in r.gt[:3]), K=r.gt.K),
              ModelArrays(*(x[rows] for x in r.model)),
              {k: v[rows] for k, v in r.ev.items()}) for r in ranks]
    for t in range(T):
        column = [r.col[(t - 1) % 2, rows] for r in ranks]
        for m, (r, (gt, model, ev)) in enumerate(zip(ranks, parts)):
            viterbi_forward_slice_plain(
                gt, model, ev, column, t, m * W, r.col[t % 2, rows],
                r.bps[t - 1, rows] if r.bps is not None and t else None)


def _slice_shift(M: int, W: int) -> int:
    """log2 of the slice width W of M slices, for the kernels: 4096 states
    in slices of a power of two from 64 to 4096."""
    shift = W.bit_length() - 1
    if M * W != 4096 or W != 1 << shift or W < 64:
        raise ValueError(f"the CUDA kernels take 4096 states in 1 to 64 "
                         f"slices of a power of two; got {M} x {W}")
    return shift


#: seconds a K1m block waits on a peer's counter before it records the
#: wait (wave_timeout) and traps: a fault in the exchange fails the decode
WAVE_TIMEOUT_S = 10.0
#: the host-mapped record of a K1m wait that timed out, (t, read, rank,
#: peer), zero while none did; made at the first launch
_timed_out = None
#: forward_wave_resident's answers, by (card index, with_path, sys)
_resident: dict = {}


def wave_timeout():
    """(t, read, rank, peer) of the K1m wait that timed out in this process
    (the card's context is lost then), or None."""
    rec = _timed_out
    if rec is None or int(rec[0]) == 0:
        return None
    return tuple(int(x) for x in rec.tolist())


def forward_wave_resident(dev, with_path: bool, sys: bool = False) -> int:
    """The most blocks of K1m's instance (with_path; sys: the exchange
    across cards) that the CUDA device `dev` holds at once: a wave's grid,
    reads times the card's ranks, must not exceed it."""
    key = (torch.device(dev).index, bool(with_path), bool(sys))
    if key not in _resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_viterbi_forward_wave_resident(
            int(with_path), int(sys), key[0], ctypes.byref(blocks)),
            "viterbi_forward_wave occupancy")
        _resident[key] = blocks.value
    return _resident[key]


def _check_wave_rank(m: int, r: WaveRank, B: int, T: int, W: int,
                     with_path: bool) -> None:
    dev = r.ev["mean"].device
    if r.gt.K != 6:
        raise ValueError(f"the CUDA forward kernel takes K=6, got K={r.gt.K}")
    if (r.bps is not None) != with_path:
        raise ValueError("the ranks' backpointers are given for some ranks "
                         "only")
    _check_events(r.ev, B, T, dev)
    _check_tables((r.gt.stay_lp, r.gt.step_lp, r.gt.skip_lp, *r.model), B, W,
                  dev)
    _check(f"ranks[{m}].col", r.col, torch.float32, (2, B, W), dev)
    _check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)
    if with_path:
        _check(f"ranks[{m}].bps", r.bps, torch.uint8, (T - 1, B, W), dev)
        if r.bps.data_ptr() % 4:  # stored a 32-bit word a thread
            raise ValueError(f"ranks[{m}].bps is not 4-byte aligned")


def forward_wave_kernel(ranks, local, lo: int, hi: int) -> None:
    """K1m on the card: viterbi_forward_wave_plain's work for the ranks
    `local` (indices into `ranks`, all on one card; 2 to 64 ranks in all)
    over the reads [lo, hi), one cooperative launch on that card's current
    stream, whose grid (hi - lo reads x len(local) ranks) must fit the card
    at once (forward_wave_resident), or the launch raises.  The ranks not in
    `local` run their blocks of the same reads in a launch of their own
    card (statepar orders the cards' launches); their slices and counters
    are read over peer access.  A block waits WAVE_TIMEOUT_S on a peer at
    most.  Raises if a wave of this process timed out (wave_timeout)."""
    B, T, W, shift, dev, sys = _wave_setup(ranks, local, lo, hi, "K1m")
    with_path = ranks[0].bps is not None
    vals = []
    for m, r in enumerate(ranks):
        _check_wave_rank(m, r, B, T, W, with_path)
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 *(x.data_ptr() for x in (*r.gt[:3], *r.model)),
                 r.col.data_ptr(),
                 r.bps.data_ptr() if with_path and r.bps.numel() else 0,
                 r.flags.data_ptr()]
    table = _rank_table(vals, local, dev)
    err = _cuda.load().nc_viterbi_forward_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift,
        int(with_path), int(sys), LOG_2PI, math.log(len(ranks) * W),
        int(WAVE_TIMEOUT_S * 1e9), _timed_out.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "viterbi_forward_wave kernel launch")
    _cuda.count_launch(forward_wave_kernel)


forward_wave_kernel.launches = 0


def _slice_byte(bp_slices, W: int):
    """byte(i, rows, s) of _grouped_walk_plain over the ranks' slices: row
    i's byte at state s from the slice of rank s // W, on s's device."""
    def byte(i, rows, s):
        k = torch.zeros_like(s)
        for m, sl in enumerate(bp_slices):
            v = sl[i].to(s.device)[rows, (s - m * W).clamp(0, W - 1).long()]
            k = torch.where(s // W == m, v.to(k.dtype), k)
        return k
    return byte


def viterbi_traceback_slices_plain(K: int, column, bp_slices, lengths):
    """Plain version of K2m: K2's end argmax and walk over the M ranks'
    slices of the final column (an (M, B, W) tensor or M (B, W) tensors)
    and their backpointer slices bp_slices[m] (T - 1, B, W) uint8, rank m's
    holding the states [m W, (m + 1) W), on any devices: (path0, codes,
    logp) on lengths' device, K2's."""
    W = column[0].shape[-1]
    return _grouped_walk_plain(K, gather_column(column, lengths.device),
                               bp_slices[0].shape[0],
                               _slice_byte(bp_slices, W), lengths)


def slices_walk_route(bp_rows) -> str:
    """How K2m and K6bm fill their ring from data rows' backpointer slices
    (bp_rows: one list of M (T - 1, B, W) uint8 slices a row, in rank
    order): "tensor" when every slice lies on one device as the view [r, m]
    of one contiguous (R, M, T - 1, B, W) allocation, rows and ranks in
    order (statepar allocates a card's rows so), which one tensor copy a
    ring stage reads; else "copies", a bulk copy a row and rank (a row
    across cards reads its peers' slices over peer access)."""
    first = bp_rows[0][0]
    M, size = len(bp_rows[0]), first.numel()
    storage = first.untyped_storage().data_ptr()
    for r, row in enumerate(bp_rows):
        for m, x in enumerate(row):
            if (len(row) != M or x.device != first.device
                    or x.dtype != torch.uint8 or x.shape != first.shape
                    or not x.is_contiguous()
                    or x.untyped_storage().data_ptr() != storage
                    or x.data_ptr() != first.data_ptr() + (r * M + m) * size):
                return "copies"
    return "tensor"


def slices_box_coords(row: int, b: int, t_top: int, q: int) -> tuple:
    """The coordinates, innermost first (W / 8, M, B, T - 1, R), of the box
    that fills stage use q of read b's walk on the tensor route, as K2m and
    K6bm compute them: rows i0 .. i0 + RING_ROWS - 1 of every slice, i0 =
    t_top - 1 - RING_ROWS q - (RING_ROWS - 1), of the launch's row `row`;
    t_top is the walk's first event (min(length, T) - 1)."""
    return (0, 0, b, t_top - 1 - RING_ROWS * q - (RING_ROWS - 1), row)


def tensor_stage_plain(block: torch.Tensor, coords) -> torch.Tensor:
    """Plain twin of the tensor route's stage fill: the (RING_ROWS, M W)
    uint8 stage that the box at `coords` (slices_box_coords) of the (R, M,
    T - 1, B, W) allocation `block` lands as in shared memory: slot s holds
    row i0 + s of every slice, side by side in rank order; a row outside
    the tensor (i0 + s < 0: below event 1) is zeros."""
    _, _, b, i0, r = coords
    R, M, Tm, B, W = block.shape
    out = torch.zeros((RING_ROWS, M * W), dtype=torch.uint8)
    for s in range(RING_ROWS):
        if 0 <= i0 + s < Tm:
            out[s] = block[r, :, i0 + s, b].reshape(M * W).cpu()
    return out


def copies_stage_plain(bp_slices, b: int, t_top: int, q: int) -> tuple:
    """Plain twin of the copies route's stage fill (the 1-D ring): stage
    use q of read b's walk from event t_top down to event 1, (stage, cnt):
    slot r < cnt holds the backpointer row t_top - 1 - RING_ROWS q - r,
    assembled from the M slices in rank order; the other slots are left
    (zeros here)."""
    M, W = len(bp_slices), bp_slices[0].shape[-1]
    j0 = RING_ROWS * q
    cnt = min(RING_ROWS, t_top - j0)
    out = torch.zeros((RING_ROWS, M * W), dtype=torch.uint8)
    for r in range(cnt):
        out[r] = torch.cat([sl[t_top - 1 - j0 - r, b].cpu()
                            for sl in bp_slices])
    return out, cnt


def _slice_rows(column, bp_slices, lengths) -> tuple:
    """(columns, bp_rows, lengths, one): a slices walk's arguments as a list
    a row; one: a single row was given (lengths a tensor)."""
    if isinstance(lengths, torch.Tensor):
        return [column], [bp_slices], [lengths], True
    return list(column), list(bp_slices), list(lengths), False


def _slices_walk_args(columns, bp_rows, lengths, route, what: str) -> dict:
    """The checks of a slices walk (K2m, K6bm) over data rows of B reads on
    lengths' card, and its launch's arguments: {"dev", "R", "B", "Tm",
    "shift", "route", "table" (the final slices, the lengths and, on the
    copies route, the backpointer slices: device pointers, int64 on the
    card), "bps" (the allocation's pointer on the tensor route)}."""
    dev = lengths[0].device
    _require_cuda(dev, what)
    R = len(lengths)
    if not R or len(columns) != R or len(bp_rows) != R:
        raise ValueError(f"{len(columns)} columns and {len(bp_rows)} "
                         f"backpointer rows for {R} lengths")
    M, W = len(columns[0]), columns[0][0].shape[-1]
    shift = _slice_shift(M, W)
    B, Tm = columns[0][0].shape[0], bp_rows[0][0].shape[0]
    for r in range(R):
        _check(f"lengths[{r}]", lengths[r], torch.int32, (B,), dev)
        if len(columns[r]) != M or len(bp_rows[r]) != M:
            raise ValueError(f"row {r}: {len(columns[r])} column and "
                             f"{len(bp_rows[r])} backpointer slices for {M} "
                             f"ranks")
        for m, (c, sl) in enumerate(zip(columns[r], bp_rows[r])):
            _require_cuda(c.device, what)
            _require_cuda(sl.device, what)
            _check(f"column[{r}][{m}]", c, torch.float32, (B, W), c.device)
            _check(f"bp_slices[{r}][{m}]", sl, torch.uint8, (Tm, B, W),
                   sl.device)
            _check_rows_aligned(sl)
            _cuda.enable_peer_access(dev, c.device)
            _cuda.enable_peer_access(dev, sl.device)
    layout = slices_walk_route(bp_rows)
    route = layout if route is None else route
    if route not in ("tensor", "copies"):
        raise ValueError(f"no slices walk route {route!r}")
    if route == "tensor" and (layout != "tensor"
                              or bp_rows[0][0].device != dev):
        raise ValueError("the tensor route takes the rows' slices as views "
                         "of one (R, M, T - 1, B, W) allocation on the "
                         "launch card (slices_walk_route)")
    ptrs = ([c.data_ptr() for row in columns for c in row]
            + [ln.data_ptr() for ln in lengths])
    if route == "copies":
        ptrs += [sl.data_ptr() if sl.numel() else 0
                 for row in bp_rows for sl in row]
    # pinned, so that the copy does not wait on the card
    table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    return {"dev": dev, "R": R, "B": B, "Tm": Tm, "shift": shift,
            "route": route, "table": table,
            "bps": bp_rows[0][0].data_ptr() if route == "tensor" else None}


def traceback_slices_kernel(K: int, column, bp_slices, lengths,
                            route: str | None = None):
    """K2m on the card: as viterbi_traceback_slices_plain, launched on
    lengths' card (K2's row ring, each stage filled from the ranks'
    slices).  One data row: column its M (B, W) final slices, bp_slices
    its M (T - 1, B, W) backpointer slices, lengths (B,): returns (path0,
    codes, logp).  Several rows of B reads in one launch: each argument a
    list a row: returns a list of (path0, codes, logp).  route
    (slices_walk_route's by default): "tensor", one tensor copy a stage
    from the rows' one allocation on the launch card (a map the driver
    refuses raises), or "copies", a bulk copy a row and rank, which reads a
    slice on another card in place (peer access, or a RuntimeError)."""
    if K != 6:
        raise ValueError(f"the CUDA traceback kernel takes K=6, got K={K}")
    columns, bp_rows, lengths, one = _slice_rows(column, bp_slices, lengths)
    a = _slices_walk_args(columns, bp_rows, lengths, route,
                          "viterbi traceback slices")
    dev, R, B, Tm = a["dev"], a["R"], a["B"], a["Tm"]
    code_bytes = 3 * (-(-Tm // 4))
    path0 = torch.empty((R, B), dtype=torch.int32, device=dev)
    codes = torch.empty((R, B, code_bytes), dtype=torch.uint8, device=dev)
    logp = torch.empty((R, B), dtype=torch.float32, device=dev)
    err = _cuda.load().nc_viterbi_traceback_slices(
        a["table"].data_ptr(), a["bps"], int(a["route"] == "tensor"), R, B,
        Tm + 1, code_bytes, a["shift"], path0.data_ptr(),
        codes.data_ptr() if codes.numel() else None, logp.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "viterbi_traceback_slices kernel launch")
    _cuda.count_launch(traceback_slices_kernel, a["route"])
    out = list(zip(path0, codes, logp))
    return out[0] if one else out


traceback_slices_kernel.launches = 0
traceback_slices_kernel.routes = {"tensor": 0, "copies": 0}


# ---------------------------------------------------------------------------
# K3: the grouped decode chunk by chunk in time (long reads)
# ---------------------------------------------------------------------------


def viterbi_forward_grouped_chunk_plain(gt: GroupedTrans, model: ModelArrays,
                                        ev_chunk: dict, carry_alpha, t0: int):
    """Plain version of K3's forward half (nanocall_tpu/ops/hmm.py:389-434):
    ev_chunk holds the (B, Tc) events [t0, t0+Tc) and the global lengths;
    carry_alpha (B, n) is alpha at event t0-1 (unread when t0 == 0).
    Returns (alpha at event t0+Tc-1, bps (Tc, B, n) uint8): row i holds
    event t0+i's backpointers, and the row of event 0 is zeros.  Chunks
    scanned left to right reproduce viterbi_forward_grouped_plain."""
    n = model.level_mean.shape[-1]
    lengths = ev_chunk["length"]
    mean, stdv, log_stdv = (ev_chunk["mean"], ev_chunk["stdv"],
                            ev_chunk["log_stdv"])
    B, Tc = mean.shape
    alpha = carry_alpha
    bps = torch.empty((Tc, B, n), dtype=torch.uint8, device=mean.device)
    for i in range(Tc):
        t = t0 + i
        if t == 0:
            alpha = log_emission(model, mean[:, 0], stdv[:, 0],
                                 log_stdv[:, 0]) - math.log(n)
            bps[0] = 0
            continue
        best, bp = _grouped_step_core(gt, alpha)
        em = log_emission(model, mean[:, i], stdv[:, i], log_stdv[:, i])
        alpha = torch.where((t < lengths)[:, None], best + em, alpha)
        bps[i] = bp
    return alpha, bps


def forward_chunk_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict,
                         carry_alpha, t0: int, Tc: int, ev_t0: int = 0):
    """K3's forward half on the card: events [t0, min(t0+Tc, ev_t0+W)) of
    the (B, W) event rows, whose column 0 holds event ev_t0 (0: the whole
    read; K9's ranks pass their slice and its first event), read in place;
    (alpha, bps (rows, B, n))."""
    mean = ev["mean"]
    dev = mean.device
    B, W = mean.shape
    n = 4096
    t1 = min(t0 + Tc, ev_t0 + W)
    if gt.K != 6:
        raise ValueError(f"the CUDA forward kernel takes K=6, got K={gt.K}")
    if not 0 <= ev_t0 <= t0 < t1:
        raise ValueError(f"empty chunk [{t0}, {t1}) of events from {ev_t0}")
    _check_events(ev, B, W, dev)
    tables = (gt.stay_lp, gt.step_lp, gt.skip_lp, *model)
    _check_tables(tables, B, n, dev)
    if t0 > 0:
        _check_tables((carry_alpha,), B, n, dev)
    _require_cuda(dev, "viterbi forward chunk")
    final = torch.empty((B, n), dtype=torch.float32, device=dev)
    bps = torch.empty((t1 - t0, B, n), dtype=torch.uint8, device=dev)
    lib = _cuda.load()
    err = lib.nc_viterbi_forward_chunk(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, W, ev_t0, t0, t1,
        carry_alpha.data_ptr() if t0 > 0 else None,
        *(x.data_ptr() for x in tables), LOG_2PI, math.log(n),
        final.data_ptr(), bps.data_ptr(),
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_forward_chunk kernel launch")
    _cuda.count_launch(forward_chunk_kernel)
    return final, bps


forward_chunk_kernel.launches = 0


def viterbi_forward_grouped_chunk(gt: GroupedTrans, model: ModelArrays,
                                  ev: dict, carry_alpha, t0: int, Tc: int):
    """K3's forward half on the tensors' device over events [t0, t0+Tc) of
    the (B, T) events `ev` (the last chunk is shorter): (alpha, bps)."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        sl = slice(t0, t0 + Tc)
        ev_chunk = {k: ev[k][:, sl] for k in ("mean", "stdv", "log_stdv")}
        ev_chunk["length"] = ev["length"]
        return viterbi_forward_grouped_chunk_plain(gt, model, ev_chunk,
                                                   carry_alpha, t0)
    if dev.type != "cuda":
        raise ValueError(f"no grouped Viterbi forward chunk for device {dev}")
    return forward_chunk_kernel(gt, model, ev, carry_alpha, t0, Tc)


def viterbi_traceback_grouped_chunk_plain(K: int, end_state, carry_state,
                                          bps, t0: int, lengths,
                                          compact: bool = True):
    """Plain version of K3's traceback half (nanocall_tpu/ops/hmm.py:
    437-483): walks the chunk's rows bps (Tc, B, n) of events [t0, t0+Tc)
    backwards from carry_state (end_state for the last chunk).  Returns
    (the state for the chunk to the left — path0 after the chunk with
    t0 == 0 —, ys (Tc, B)): with compact, uint8 codes, row i the 6-bit code
    of event t0+i, 0 at event 0; else (K9's) uint16 states, row i the state
    s_eff of event t0+i."""
    Tc, B, _ = bps.shape
    rows = torch.arange(B, device=bps.device)
    lengths = lengths.to(torch.int32)
    ys = torch.zeros((Tc, B), dtype=torch.uint8 if compact else torch.int32,
                     device=bps.device)
    s = carry_state
    for i in range(Tc - 1, -1, -1):
        t = t0 + i
        s_eff = torch.where(t == lengths - 1, end_state, s)
        k = bps[i, rows, s_eff.long()].to(torch.int32)
        # event 0's row is filler: it passes s_eff through
        real = (t <= lengths - 1) & (t >= 1)
        s = torch.where(real, grouped_from_state(k, s_eff, K), s_eff)
        ys[i] = (torch.where(real, ((k >> 6) << 4) | (s_eff & 15), 0)
                 if compact else s_eff)
    return s, ys if compact else ys.to(torch.uint16)


def traceback_chunk_kernel(K: int, end_state, state, bps, t0: int, lengths,
                           codes):
    """K3's traceback half on the card: walks the chunk's rows of events
    [t0, t0+rows) from `state`, which it updates in place, and ORs the
    chunk's codes into the packed codes (B, 3*ceil((T-1)/4))."""
    dev = bps.device
    Tc, B, n = bps.shape
    if K != 6 or n != 4096:
        raise ValueError(f"the CUDA traceback kernel takes K=6, n=4096; "
                         f"got K={K}, n={n}")
    for name, x in (("end_state", end_state), ("state", state),
                    ("lengths", lengths)):
        _check(name, x, torch.int32, (B,), dev)
    _check("bps", bps, torch.uint8, (Tc, B, n), dev)
    _check_rows_aligned(bps)
    _check("codes", codes, torch.uint8, (B, codes.shape[1]), dev)
    if codes.shape[1] < 3 * -(-(t0 + Tc - 1) // 4):
        raise ValueError(f"codes of {codes.shape[1]} bytes per read cannot "
                         f"hold events up to {t0 + Tc}")
    _require_cuda(dev, "viterbi traceback chunk")
    lib = _cuda.load()
    err = lib.nc_viterbi_traceback_chunk(
        end_state.data_ptr(), state.data_ptr(), bps.data_ptr(),
        lengths.data_ptr(), B, t0, t0 + Tc, codes.shape[1],
        codes.data_ptr() if codes.numel() else None,
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_traceback_chunk kernel launch")
    _cuda.count_launch(traceback_chunk_kernel)
    return state


traceback_chunk_kernel.launches = 0


def traceback_chunk_states_kernel(K: int, end_state, state, bps, t0: int,
                                  lengths, states):
    """K9's traceback chunk on the card: walks the chunk's rows of events
    [t0, t0+Tc) from `state`, which it updates in place, and writes the
    state of event t0+i into row i of `states`, a (Tc, B) uint16 view whose
    rows may be strided (K9 writes a block's columns of a rank's (Tc, B_all)
    buffer)."""
    dev = bps.device
    Tc, B, n = bps.shape
    if K != 6 or n != 4096:
        raise ValueError(f"the CUDA traceback kernel takes K=6, n=4096; "
                         f"got K={K}, n={n}")
    for name, x in (("end_state", end_state), ("state", state),
                    ("lengths", lengths)):
        _check(name, x, torch.int32, (B,), dev)
    _check("bps", bps, torch.uint8, (Tc, B, n), dev)
    _check_rows_aligned(bps)
    if (states.dtype != torch.uint16 or tuple(states.shape) != (Tc, B)
            or states.device != dev or states.stride(1) != 1):
        raise ValueError(f"states: expected uint16 {(Tc, B)} rows on {dev}, "
                         f"got {states.dtype} {tuple(states.shape)} strides "
                         f"{states.stride()} on {states.device}")
    _require_cuda(dev, "viterbi traceback chunk (states)")
    lib = _cuda.load()
    err = lib.nc_viterbi_traceback_chunk_states(
        end_state.data_ptr(), state.data_ptr(), bps.data_ptr(),
        lengths.data_ptr(), B, t0, t0 + Tc, states.data_ptr(),
        states.stride(0), *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_traceback_chunk_states kernel launch")
    _cuda.count_launch(traceback_chunk_states_kernel)
    return state


traceback_chunk_states_kernel.launches = 0


def or_packed_codes(codes, chunk_codes, t0: int) -> None:
    """OR a chunk's (Tc, B) codes of events [t0, t0+Tc) into the packed
    codes (B, 3*ceil((T-1)/4)) at their global places (event t's code is
    code t-1 of the packed row), as the traceback chunk kernel does."""
    B, nbytes = codes.shape
    full = torch.zeros((nbytes // 3 * 4, B), dtype=torch.uint8,
                       device=codes.device)
    lo = max(t0, 1)
    full[lo - 1:t0 + chunk_codes.shape[0] - 1] = chunk_codes[lo - t0:]
    codes |= pack_codes(full)


def viterbi_traceback_grouped_chunk(K: int, end_state, state, bps, t0: int,
                                    lengths, codes):
    """K3's traceback half on the tensors' device: the state for the chunk
    to the left (in place on the card), with the chunk's codes ORed into
    the packed codes."""
    dev = bps.device
    if dev.type == "cpu":
        s, chunk_codes = viterbi_traceback_grouped_chunk_plain(
            K, end_state, state, bps, t0, lengths)
        or_packed_codes(codes, chunk_codes, t0)
        return s
    if dev.type != "cuda":
        raise ValueError(f"no grouped traceback chunk for device {dev}")
    return traceback_chunk_kernel(K, end_state, state, bps, t0, lengths,
                                  codes)


def viterbi_decode_grouped_tchunk(gt: GroupedTrans, model: ModelArrays,
                                  ev: dict, Tc: int,
                                  with_path: bool = True) -> dict:
    """Grouped Viterbi decode in chunks of Tc events (nanocall_tpu/ops/
    hmm.py:614-670, compact_path=True): C = ceil(T/Tc) forward chunks
    linked by their alpha carry, then C traceback chunks right to left
    linked by their state carry; the last chunk is shorter.  The output is
    bit-identical to viterbi_decode_grouped: {"logp"} when with_path is
    False, else {"path0", "codes", "logp"}.

    All chunks' backpointers live until their traceback, B * T * n bytes as
    in the full scan; each chunk's are freed as soon as it is traced back.
    The end state and logp come once, from the last chunk's alpha."""
    n = model.level_mean.shape[-1]
    lengths = ev["length"]
    B, T = ev["mean"].shape
    dev = ev["mean"].device
    t0s = range(0, T, Tc)
    alpha = torch.zeros((B, n), dtype=torch.float32, device=dev)
    bps = []
    for t0 in t0s:
        alpha, bps_c = viterbi_forward_grouped_chunk(gt, model, ev, alpha,
                                                     t0, Tc)
        bps.append(bps_c)
    logp = torch.amax(alpha, dim=-1)
    if not with_path:
        return {"logp": logp}
    end_state = torch.argmax(alpha, dim=-1).to(torch.int32)
    codes = torch.zeros((B, 3 * (-(-(T - 1) // 4))), dtype=torch.uint8,
                        device=dev)
    s = end_state.clone()
    for c in reversed(range(len(bps))):
        s = viterbi_traceback_grouped_chunk(gt.K, end_state, s, bps[c],
                                            t0s[c], lengths, codes)
        bps[c] = None
    return {"path0": s, "codes": codes, "logp": logp}


# ---------------------------------------------------------------------------
# K4: grouped log-sum-exp forward (the EM E-step's forward half)
# ---------------------------------------------------------------------------

#: bits of the forward kernel's per-state flag byte
FWD_FLAG_BITS = {"H": 0, "P2mH": 1, "S5": 2}


def strided_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, n) -> (B, n/r): out[c] = sum over k = 0, 1, .., r-1 (added in
    that order) of x[k * n/r + c] — the strided column sums of the forward
    pass (`x.reshape(B, r, n/r).sum(1)`)."""
    xs = x.view(x.shape[0], r, -1)
    s = xs[:, 0]
    for k in range(1, r):
        s = s + xs[:, k]
    return s


def block_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, n) -> (B, n/r): out[c] = sum over k = 0, 1, .., r-1 (added in
    that order) of x[r * c + k] — the contiguous block sums of the backward
    pass (`x.reshape(B, n/r, r).sum(-1)`)."""
    xs = x.view(x.shape[0], -1, r)
    s = xs[..., 0]
    for k in range(1, r):
        s = s + xs[..., k]
    return s


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) as a pairwise tree: adjacent
    pairs first, x[2i] + x[2i+1], level by level.  The kernels reduce a row
    in exactly this pairing (each thread's 4 states, then warp shuffles,
    then the warps' partial sums)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _fwd_exp_tables(gtf: GroupedTransFull):
    return (torch.exp(gtf.stay_lp), torch.exp(gtf.step_lp),
            torch.exp(gtf.skip_lp))


def fwbw_grouped_forward_plain(gtf: GroupedTransFull, model: ModelArrays,
                               ev: dict, with_alphas: bool = True):
    """Plain version of K4 (nanocall_tpu/ops/hmm.py:890-953): a loop over
    events, in the scan body's op order.  Returns (alphas (T, B, n) float32
    — row t holds the carry after event t, frozen where t >= length — or
    None when with_alphas is False, log_pr_data (B,) float32, the
    log-sum-exp of the final alpha)."""
    n = model.level_mean.shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    m_ = correction_masks(gtf.K, mean.device)
    mH, mP2, mS5 = m_["H"], m_["P2mH"], m_["S5"]
    e_stay, e_step, e_skip = _fwd_exp_tables(gtf)
    alphas = (torch.empty((T, B, n), dtype=torch.float32, device=mean.device)
              if with_alphas else None)
    alpha = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0]) \
        - math.log(n)
    if with_alphas:
        alphas[0] = alpha
    for t in range(1, T):
        m = torch.amax(alpha, dim=-1, keepdim=True)
        E = torch.exp(alpha - m)
        S4 = strided_sum(E, 4).repeat_interleave(4, dim=1)
        S16 = strided_sum(E, 16).repeat_interleave(16, dim=1)
        total = (e_stay * E + e_step * (S4 - mH * E)
                 + e_skip * (S16 - mP2 * E - mS5 * S4))
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        new_alpha = em + m + torch.log(total)
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
        if with_alphas:
            alphas[t] = alpha
    mfin = torch.amax(alpha, dim=-1)
    lpd = mfin + torch.log(tree_sum(torch.exp(alpha - mfin[:, None])))
    return alphas, lpd


def fwbw_forward_kernel(gtf: GroupedTransFull, model: ModelArrays, ev: dict,
                        with_alphas: bool = True):
    """K4 on the card: (alphas (T, B, n) or None, log_pr_data (B,)); without
    alphas the kernel stores nothing per step (the fit-only round)."""
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    n = 4096
    if gtf.K != 6:
        raise ValueError(f"the CUDA fwbw forward kernel takes K=6, got "
                         f"K={gtf.K}")
    if T < 1:
        raise ValueError("the forward pass needs at least one event column")
    _check_events(ev, B, T, dev)
    tables = (*_fwd_exp_tables(gtf), *model)
    _check_tables(tables, B, n, dev)
    _require_cuda(dev, "fwbw forward")
    flags = mask_flags(correction_masks(6, dev), FWD_FLAG_BITS)
    alphas = (torch.empty((T, B, n), dtype=torch.float32, device=dev)
              if with_alphas else None)
    lpd = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_fwbw_forward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, *(x.data_ptr() for x in tables),
        flags.data_ptr(), LOG_2PI, math.log(n),
        alphas.data_ptr() if with_alphas else None, lpd.data_ptr(),
        *_cuda.target(dev),
    )
    _cuda.check(err, "fwbw_forward kernel launch")
    _cuda.count_launch(fwbw_forward_kernel)
    return alphas, lpd


fwbw_forward_kernel.launches = 0


def fwbw_grouped_forward(gtf: GroupedTransFull, model: ModelArrays, ev: dict,
                         with_alphas: bool = True):
    """K4 on the tensors' device: (alphas (T, B, n) or None,
    log_pr_data (B,))."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return fwbw_grouped_forward_plain(gtf, model, ev, with_alphas)
    if dev.type != "cuda":
        raise ValueError(f"no grouped fwbw forward for device {dev}")
    return fwbw_forward_kernel(gtf, model, ev, with_alphas)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.logaddexp of two tensors of one shape.  On the CPU its kernel
    takes the last elements of a tensor (past a multiple of two vectors) by
    a scalar path that may differ from its vector path in the last bit, so
    that a row's bits would depend on where the row lies in its batch, and
    a state-parallel round's on how the batch is cut; there both are
    padded to a multiple of 64 elements first, so that every element takes
    the vector path."""
    if a.device.type != "cpu":
        return torch.logaddexp(a, b)
    n = a.numel()
    pad = -n % 64
    out = torch.logaddexp(*(torch.cat([x.reshape(-1), x.new_zeros(pad)])
                            for x in (a, b)))
    return out[:n].reshape(a.shape)


def combine_rank_sums(parts) -> torch.Tensor:
    """The M ranks' partial sums (M tensors of one shape, M a power of
    two) added pairwise in rank order, adjacent pairs first, as tree_sum
    adds over a row: where part m is the tree_sum of the contiguous states
    [m W, (m + 1) W), a whole subtree of the row's tree, the result is the
    row's tree_sum bit for bit."""
    return tree_sum(torch.stack(list(parts), dim=-1))


# ---------------------------------------------------------------------------
# K4m: K4 with the states split over M ranks (the EM round on the state
# axis, parallel/statepar.py).  Rank m holds the states [m W, (m + 1) W), W
# = n / M: its (B, W) tables, its (T, B, W) slice of the alphas (or, storing
# none, a (2, B, W) column buffer), its (3, B) partials, B step counters and
# its copy of log Pr[data].  A step publishes the rank's slice of the
# previous column with the slice's partial max; the max over all n states
# is the max of the M partials, and each rank reads only the rows of the
# strided sums S4 and S16 that its states read.
# ---------------------------------------------------------------------------


class FwdWaveRank(NamedTuple):
    """One rank of a data row of the EM forward, on the rank's device: its
    (B, W) cut of the grouped tables (GroupedTransFull; K4m reads the from
    side) and of the scaled model, the row's (B, T) events and (B,)
    lengths whole, alphas (T, B, W) float32 (its slice of K4's alphas) or
    None, col (2, B, W) float32 (the column of event t at parity t % 2)
    when alphas is None, part (3, B) float32 (the partial max of its slice
    of column t at parity t % 2, then its partial sum for log Pr[data]),
    lpd (B,) float32 (log Pr[data], every rank's copy), its step counters
    flags (B,) int32, zero before each launch (K4m's exchange; the plain
    version leaves them)."""

    gtf: GroupedTransFull
    model: ModelArrays
    ev: dict
    alphas: torch.Tensor | None
    col: torch.Tensor | None
    part: torch.Tensor
    lpd: torch.Tensor
    flags: torch.Tensor


def _column_of(r: FwdWaveRank, t: int) -> torch.Tensor:
    """A rank's (B, W) slice of the alpha column of event t."""
    return r.alphas[t] if r.alphas is not None else r.col[t % 2]


def ranks_amax(parts, device) -> torch.Tensor:
    """torch.amax over the M ranks' partial maxima (M tensors of one shape,
    on any devices), on `device`: the max over all the states, exact.  It
    reduces the last axis, as torch.amax over a row does: on the CPU a
    reduction over the first axis may give another NaN's bits."""
    return torch.amax(torch.stack([x.to(device) for x in parts], dim=-1),
                      dim=-1)


def strided_rows(column, start: int, width: int, device) -> torch.Tensor:
    """The (B, width) states [start, start + width) of a column given as its
    M (B, W) slices, read in place from the one slice that holds them
    (width divides W, start a multiple of width)."""
    W = column[0].shape[-1]
    off = start % W
    return column[start // W][:, off:off + width].to(device)


def fwbw_forward_slice_plain(gtf: GroupedTransFull, model: ModelArrays,
                             ev: dict, column, maxima, t: int, lo: int,
                             alpha_out) -> None:
    """One rank's step, the plain version of K4m's step: event t's alpha at
    the states [lo, lo + W) into alpha_out (B, W).  gtf and model hold the
    rank's (B, W) cut, ev the (B, T) events and lengths whole; column is
    the alpha of event t - 1 as its M slices and maxima the M ranks'
    partial maxima (B,) of them (on any devices, read in place; unread at
    t = 0).  The step of fwbw_grouped_forward_plain for these states: the
    max over all n = M W states from the partial maxima; S4[c] of the
    states' c = j // 4 from the rows r 1024 + c (r < 4) and S16[c16] from
    the rows r16 256 + c16 (r16 < 16), each row's W / 4 or W / 16 values
    read from the slice that holds them, exp(alpha - max) of each, summed
    in r order; -log(n) at t = 0."""
    M, W = len(column), column[0].shape[-1]
    n = M * W
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    dev = mean.device
    if t == 0:
        alpha_out.copy_(log_emission(model, mean[:, 0], stdv[:, 0],
                                     log_stdv[:, 0]) - math.log(n))
        return
    cols = slice(lo, lo + W)
    m_ = {k: v[cols] for k, v in correction_masks(gtf.K, dev).items()}
    e_stay, e_step, e_skip = _fwd_exp_tables(gtf)
    m = ranks_amax(maxima, dev)[:, None]

    def strided(r: int, width: int):
        s = None
        for k in range(r):
            e = torch.exp(strided_rows(column, k * (n // r) + lo * width // W,
                                       width, dev) - m)
            s = e if s is None else s + e
        return s.repeat_interleave(W // width, dim=1)

    S4, S16 = strided(4, W // 4), strided(16, W // 16)
    alpha = column[lo // W].to(dev)
    E = torch.exp(alpha - m)
    total = (e_stay * E + e_step * (S4 - m_["H"] * E)
             + e_skip * (S16 - m_["P2mH"] * E - m_["S5"] * S4))
    em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
    alpha_out.copy_(torch.where((t < ev["length"])[:, None],
                                em + m + torch.log(total), alpha))


def fwbw_forward_wave_plain(ranks, lo: int, hi: int) -> None:
    """Plain version of K4m: events 0 .. T - 1 of the reads [lo, hi) for
    every rank of a data row (ranks: its M FwdWaveRanks in rank order).
    Each step, every rank publishes its slice of the previous column's
    partial max into part[(t - 1) % 2], then runs fwbw_forward_slice_plain
    on the peers' slices and partial maxima, read in place, into its slice
    of column t (alphas[t], or col[t % 2]); after the last, every rank
    publishes its final partial max and its partial sum (part[2]: its
    slice's tree sum of exp(alpha - max), a whole subtree of
    fwbw_grouped_forward_plain's), and its lpd takes log Pr[data] from the
    M partials (the sums combined by combine_rank_sums).  The counters are
    left as they are."""
    rows = slice(lo, hi)
    T = ranks[0].ev["mean"].shape[1]
    W = ranks[0].model.level_mean.shape[-1]
    parts = [(GroupedTransFull(*(x[rows] for x in r.gtf[:5]), K=r.gtf.K),
              ModelArrays(*(x[rows] for x in r.model)),
              {k: v[rows] for k, v in r.ev.items()}) for r in ranks]

    def publish_max(tc: int) -> list:
        for r in ranks:
            r.part[tc % 2, rows] = torch.amax(_column_of(r, tc)[rows], dim=-1)
        return [r.part[tc % 2, rows] for r in ranks]

    for t in range(T):
        column = [_column_of(r, max(t - 1, 0))[rows] for r in ranks]
        maxima = publish_max(t - 1) if t else None
        for m, (r, (gtf, model, ev)) in enumerate(zip(ranks, parts)):
            fwbw_forward_slice_plain(gtf, model, ev, column, maxima, t,
                                     m * W, _column_of(r, t)[rows])
    maxima = publish_max(T - 1)
    for r in ranks:
        mfin = ranks_amax(maxima, r.part.device)
        r.part[2, rows] = tree_sum(torch.exp(_column_of(r, T - 1)[rows]
                                             - mfin[:, None]))
    for r in ranks:
        dev = r.lpd.device
        mfin = ranks_amax(maxima, dev)
        r.lpd[rows] = mfin + torch.log(combine_rank_sums(
            [x.part[2, rows].to(dev) for x in ranks]))


#: the most ranks of a data row that K4m, K5m and K6am run as one thread
#: block cluster (csrc/wave_exchange.cuh MAX_CLUSTER)
MAX_CLUSTER = 8


def wave_cluster(M: int, sys: bool) -> bool:
    """Whether K4m's, K5m's and K6am's launches over a data row of M ranks
    take the cluster path by default: every rank on the launch's card (not
    sys) and M <= MAX_CLUSTER.  Then a read's M blocks are one cluster,
    exchanging through their shared memory, and a launch may hold any
    number of reads; else the blocks exchange through global memory behind
    counters in a cooperative grid that must fit the card at once."""
    return not sys and M <= MAX_CLUSTER


def cluster_path(M: int, sys: bool, n_local: int,
                 cluster: bool | None) -> bool:
    """Whether a wave launch of K4m, K5m or K6am over n_local of a data
    row's M ranks (sys: a rank lies on another card) takes the cluster
    path: by default (None) where wave_cluster(M, sys) says and the launch
    holds every rank.  cluster=True where that path cannot run (a launch
    of some of the ranks, more than MAX_CLUSTER ranks, or across cards)
    raises ValueError."""
    if cluster is None:
        return wave_cluster(M, sys) and n_local == M
    if cluster and (n_local != M or not wave_cluster(M, sys)):
        raise ValueError(
            f"the cluster path takes one launch of every rank of a row of "
            f"at most {MAX_CLUSTER} ranks on one card; got {n_local} of {M}"
            f" ranks{' across cards' if sys else ''}")
    return bool(cluster)


#: fwbw_forward_wave_resident's answers, by (card index, sys, W, cluster)
_fwd_resident: dict = {}


def fwbw_forward_wave_resident(dev, sys: bool, W: int,
                               cluster: bool = False) -> int:
    """The most blocks of K4m's instance (sys: the exchange across cards)
    at slices of W states that the
    CUDA device `dev` holds at once: a cooperative wave's grid, reads times
    the card's ranks, must not exceed it; cluster: the blocks of the most
    clusters of the cluster path it holds at once."""
    key = (torch.device(dev).index, bool(sys), int(W), bool(cluster))
    if key not in _fwd_resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_fwbw_forward_wave_resident(
            int(sys), _slice_shift(4096 // W, W),
            int(cluster), key[0], ctypes.byref(blocks)),
            "fwbw_forward_wave occupancy")
        _fwd_resident[key] = blocks.value
    return _fwd_resident[key]


def _check_fwd_wave_rank(m: int, r: FwdWaveRank, B: int, T: int,
                         W: int, stored: bool) -> None:
    dev = r.ev["mean"].device
    if r.gtf.K != 6:
        raise ValueError(f"the CUDA fwbw forward kernel takes K=6, got "
                         f"K={r.gtf.K}")
    if (r.alphas is not None) != stored:
        raise ValueError("the ranks' alphas are given for some ranks only")
    _check_events(r.ev, B, T, dev)
    _check_tables((*r.gtf[:3], *r.model), B, W, dev)
    if stored:
        _check(f"ranks[{m}].alphas", r.alphas, torch.float32, (T, B, W), dev)
        _check_aligned(f"ranks[{m}].alphas", r.alphas)
    else:
        _check(f"ranks[{m}].col", r.col, torch.float32, (2, B, W), dev)
        _check_aligned(f"ranks[{m}].col", r.col)
    _check(f"ranks[{m}].part", r.part, torch.float32, (3, B), dev)
    _check(f"ranks[{m}].lpd", r.lpd, torch.float32, (B,), dev)
    _check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)


def _wave_setup(ranks, local, lo: int, hi: int, what: str):
    """The checks every wave wrapper (K1m, K6am, K4m, K5m: `what`) makes
    before its launch: 2 to 64 ranks, the launch's ranks on one CUDA card,
    every rank on a CUDA card, a wave of reads, no earlier wave timed out.
    Returns (B, T, W, slice shift, the launch's card, sys: whether a rank
    lies on another card), with the host-mapped timeout record made."""
    global _timed_out
    M = len(ranks)
    if not 2 <= M <= 64:
        raise ValueError(f"the CUDA {what} takes 2 to 64 ranks; got {M}")
    if not local:
        raise ValueError("no ranks to launch")
    B, T = ranks[0].ev["mean"].shape
    W = ranks[0].model.level_mean.shape[-1]
    shift = _slice_shift(M, W)
    dev = ranks[local[0]].ev["mean"].device
    _require_cuda(dev, what)
    for r in ranks:
        _require_cuda(r.ev["mean"].device, what)
    if any(ranks[m].ev["mean"].device != dev for m in local):
        raise ValueError("the launch's ranks lie on more than one card")
    if not 0 <= lo < hi <= B:
        raise ValueError(f"no wave of reads [{lo}, {hi}) of {B}")
    if T < 1:
        raise ValueError("the pass needs at least one event column")
    if wave_timeout() is not None:
        raise RuntimeError(f"a wave timed out: (t, read, rank, peer) = "
                           f"{wave_timeout()}")
    if _timed_out is None:
        _timed_out = torch.zeros(4, dtype=torch.int32).pin_memory()
    sys = any(r.ev["mean"].device != dev for r in ranks)
    return B, T, W, shift, dev, sys


#: wave_state_bytes' answers, by (card index, backward, rank, W)
_state_bytes: dict = {}


def wave_state_bytes(dev, m: int, W: int, backward: bool):
    """The per-state bytes of rank m's states [m W, (m + 1) W) on the CUDA
    device `dev`, made once there, so that a wave launch copies nothing
    from the host: K4m's flag bytes (FWD_FLAG_BITS), or for K5m (pattern,
    flag bytes of GROUPED_BWD_FLAG_BITS, to which the wrapper adds the
    rank's transition-training subset)."""
    key = (torch.device(dev).index, bool(backward), int(m), int(W))
    if key not in _state_bytes:
        cols = slice(m * W, (m + 1) * W)
        masks = {k: v[cols] for k, v in correction_masks(6, dev).items()}
        if backward:
            _state_bytes[key] = (
                torch.from_numpy(bwd_patterns(6)[0][cols].copy()).to(dev),
                mask_flags(masks, GROUPED_BWD_FLAG_BITS))
        else:
            _state_bytes[key] = mask_flags(masks, FWD_FLAG_BITS)
    return _state_bytes[key]


def _rank_table(vals: list, local, dev) -> torch.Tensor:
    """The launch's rank entries and local ranks as int64 on `dev`, copied
    from pinned memory, so that the copy does not wait on the card."""
    return torch.tensor([*vals, *local], dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)


def fwbw_forward_wave_kernel(ranks, local, lo: int, hi: int,
                             cluster: bool | None = None) -> None:
    """K4m on the card: fwbw_forward_wave_plain's work for the ranks
    `local` (indices into `ranks`, all on one card; 2 to 64 ranks in all)
    over the reads [lo, hi), one launch on that card's current stream.
    cluster (by default wave_cluster(M, sys) where `local` holds every
    rank): each read's M blocks one thread block cluster, any number of
    reads.  Else one cooperative launch, whose grid (hi - lo reads x
    len(local) ranks) must fit the card at once
    (fwbw_forward_wave_resident), or the launch raises; the other ranks run
    their blocks of the same reads in a launch of their own card; their
    slices, partials and counters are read over peer access, and a block
    waits WAVE_TIMEOUT_S on a peer at most.  Raises if a wave of this
    process timed out (wave_timeout)."""
    B, T, W, shift, dev, sys = _wave_setup(ranks, local, lo, hi, "K4m")
    cluster = cluster_path(len(ranks), sys, len(local), cluster)
    stored = ranks[0].alphas is not None
    vals, keep = [], []
    for m, r in enumerate(ranks):
        _check_fwd_wave_rank(m, r, B, T, W, stored)
        if m in local:
            # made on the launch's stream and held until it is enqueued
            keep += [*_fwd_exp_tables(r.gtf), *r.model,
                     wave_state_bytes(dev, m, W, backward=False)]
            tables = [x.data_ptr() for x in keep[-10:]]
        else:  # a peer's tables are never read by this launch
            tables = [0] * 10
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 *tables, (r.alphas if stored else r.col).data_ptr(),
                 r.part.data_ptr(), r.lpd.data_ptr(), r.flags.data_ptr()]
    table = _rank_table(vals, local, dev)
    err = _cuda.load().nc_fwbw_forward_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift, int(stored),
        int(sys), int(cluster), LOG_2PI,
        math.log(len(ranks) * W),
        int(WAVE_TIMEOUT_S * 1e9), _timed_out.data_ptr(), *_cuda.target(dev))
    _cuda.check(err, "fwbw_forward_wave kernel launch")
    _cuda.count_launch(fwbw_forward_wave_kernel)


fwbw_forward_wave_kernel.launches = 0


# ---------------------------------------------------------------------------
# K6: the generic kernels under a loaded transition table (TransOps)
# ---------------------------------------------------------------------------


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, deg, n) -> (B, n): the sum over the slot axis, added in slot
    order k = 0, 1, .., deg-1 (the kernels' order)."""
    s = x[:, 0]
    for k in range(1, x.shape[1]):
        s = s + x[:, k]
    return s


def gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, n) values gathered through a (deg, n) slot table: out[b, k, j] =
    x[b, idx[k, j]], as (B, deg, n)."""
    return torch.index_select(x, 1, idx.reshape(-1)).view(x.shape[0],
                                                           *idx.shape)


def logsumexp_slots(vals: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the slot axis of vals (B, deg, n), -inf-safe
    (nanocall_tpu/ops/hmm.py:776-781): m = max over slots (NaN-propagating),
    s = the slot-order sum of exp(vals - safe_m), m where m is not finite."""
    m = torch.amax(vals, dim=1)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, 0.0)
    s = slot_sum(torch.exp(vals - safe_m[:, None]))
    return torch.where(finite, safe_m + torch.log(s), m)


def per_read(ops: TransOps) -> bool:
    """Whether `ops` holds a table a read (make_trans_ops_batch)."""
    return ops.from_logp.dim() == 3


def refuse_per_read(ops: TransOps, what: str) -> None:
    """Raise ValueError for per-read tables where `what` takes one shared
    table: the forward-backward on the mesh's state axis (K6cm), which
    JAX runs only in the legacy EM round, under one loaded table."""
    if per_read(ops):
        raise ValueError(f"{what} takes one (deg, n) table for every read, "
                         f"not per-read (B, deg, n) tables")


def _check_ops(ops: TransOps, dev, B: int) -> None:
    """The kernels take K=6 tables of at most 256 slots, as contiguous
    int32 / float32 (deg, 4096) tensors on the launch device; per-read
    log-probs (B, deg, 4096) of the events' B."""
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    for side in ("from", "to"):
        idx, logp = getattr(ops, f"{side}_idx"), getattr(ops, f"{side}_logp")
        deg = idx.shape[0]
        if not 1 <= deg <= MAX_SLOTS:
            raise ValueError(f"{side} table: {deg} slots, the kernels take "
                             f"1 to {MAX_SLOTS}")
        _check(f"{side}_idx", idx, torch.int32, (deg, 4096), dev)
        _check(f"{side}_logp", logp, torch.float32,
               (B, deg, 4096) if per_read(ops) else (deg, 4096), dev)


# K6a: generic Viterbi forward ------------------------------------------------


def viterbi_forward_plain(ops: TransOps, model: ModelArrays, ev: dict,
                          with_path: bool = True):
    """Plain version of K6a (nanocall_tpu/ops/hmm.py:673-711): a loop over
    events.  Per state, the max over slots of from_logp + alpha[from_idx];
    the backpointer is the slot of the lowest from-state among the maxima,
    the lowest slot among equal from-states.  Per-read (B, deg, n)
    log-probs broadcast as JAX's do.  Returns (final_alpha (B, n)
    float32, bps (T-1, B, n) uint8 slot ids, or None when with_path is
    False)."""
    n = model.level_mean.shape[-1]
    lengths = ev["length"]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    B, T = mean.shape
    alpha = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0]) \
        - math.log(n)
    bps = (torch.empty((max(T - 1, 0), B, n), dtype=torch.uint8,
                       device=mean.device) if with_path else None)
    for t in range(1, T):
        vals = ops.from_logp + gather_slots(alpha, ops.from_idx)
        best = torch.amax(vals, dim=1)
        if with_path:
            masked = torch.where(vals == best[:, None], ops.from_idx, _BIG)
            bps[t - 1] = torch.argmin(masked, dim=1).to(torch.uint8)
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        alpha = torch.where((t < lengths)[:, None], best + em, alpha)
    return alpha, bps


#: codes per slot of the resident layout: a 4-bit code into the slot's
#: codebook of float32 log-probs
RESIDENT_CODES = 16
#: codebooks per slot of K6c's resident layout, one per block of 1024
#: states: the fewest for which both sides of the loaded tables of the CLI
#: priors (0.1, 0.3) and of (0.14, 0.21) pack (tests/test_torch_packed.py)
FWBW_GROUPS = 4
#: the codebooks a slot K6a's resident layout may take, in the order tried:
#: one, else FWBW_GROUPS (the loaded table of the CLI priors and 5 more of
#: the 15 `--fast` tables of tests/test_torch_packed_groups.py need 4)
RESIDENT_GROUPS = (1, FWBW_GROUPS)
#: shared memory one block may use on Hopper (bytes)
SMEM_PER_BLOCK = 232448
#: shared memory of one SM of Hopper (bytes)
SMEM_PER_SM = 233472
#: the resident kernel's static shared memory: its mbarrier
_RESIDENT_STATIC_SMEM = 8


def resident_smem_bytes(deg: int, n: int = 4096, groups: int = 1) -> int:
    """The resident K6a's dynamic shared memory at `deg` slots of `groups`
    codebooks: two float32 alpha buffers, the codebooks and the 16-bit
    table."""
    return 2 * 4 * n + deg * (4 * groups * RESIDENT_CODES + 2 * n)


def max_resident_slots(groups: int = 1) -> int:
    """The most slots whose resident K6a layout of `groups` codebooks a slot
    fits one block's shared memory: 24 at one, 23 at FWBW_GROUPS."""
    per_slot = (resident_smem_bytes(1, groups=groups)
                - resident_smem_bytes(0, groups=groups))
    return ((SMEM_PER_BLOCK - _RESIDENT_STATIC_SMEM - resident_smem_bytes(0))
            // per_slot)


#: the most slots of the one-codebook layout: 24
MAX_RESIDENT_SLOTS = max_resident_slots(1)


def pack_slots(idx, logp, groups: int = 1,
               max_slots: int = MAX_RESIDENT_SLOTS):
    """A (deg, 4096) slot table (host arrays: the state of each entry and its
    log-prob) in the resident kernels' layout, or None when it has none:
    (packed (deg, 4096) int16, codebook (deg, groups * RESIDENT_CODES)
    float32), as numpy arrays, with `groups` codebooks per slot, one per
    block of 4096 / groups states.  Entry [k, j] holds idx[k, j] in its low
    12 bits and in its high 4 the code c with codebook[k, g * RESIDENT_CODES
    + c] == logp[k, j] bit for bit, g = j's block (-inf and NaN kept as
    their bit patterns; a codebook's codes in the ascending order of its bit
    patterns as int32, unused entries 0).  Slot order is kept: K6a's
    backpointers are slot ids.  None unless the table is 4096 wide, has 1 to
    `max_slots` slots and states in [0, 4096), and every (slot, block) holds
    at most RESIDENT_CODES distinct bit patterns.  groups = 1 is K6a's
    one-codebook layout, FWBW_GROUPS K6c's (resident_layout orders K6a's
    codebooks by block)."""
    idx = np.asarray(idx).astype(np.int64)
    bits = np.ascontiguousarray(logp, np.float32).view(np.int32)
    deg, n = idx.shape
    if n != 4096 or not 1 <= deg <= max_slots \
            or idx.min() < 0 or idx.max() >= n:
        return None
    w = n // groups
    packed = np.empty((deg, n), np.uint16)
    book = np.zeros((deg, groups, RESIDENT_CODES), np.int32)
    for k in range(deg):
        for g in range(groups):
            blk = slice(g * w, (g + 1) * w)
            vals, codes = np.unique(bits[k, blk], return_inverse=True)
            if len(vals) > RESIDENT_CODES:
                return None
            book[k, g, :len(vals)] = vals
            packed[k, blk] = (codes.reshape(w) << 12) | idx[k, blk]
    return (packed.view(np.int16),
            book.reshape(deg, groups * RESIDENT_CODES).view(np.float32))


def resident_layout(idx, logp, groups: int | None = None):
    """K6a's resident layout of a (deg, 4096) slot table (host arrays), or
    None: pack_slots at the fewest codebooks a slot of RESIDENT_GROUPS that
    packs the table, within max_resident_slots of that count (`groups`
    forces one count), as (packed (deg, 4096) int16, codebook (G deg,
    RESIDENT_CODES) float32) numpy arrays, the codebooks block-major: row
    g deg + k is slot k's codebook of the block of states [g 4096 / G, (g +
    1) 4096 / G).  A thread's states lie in one block, so the kernels move
    its codebook base once and keep slot k's codebook k RESIDENT_CODES on.
    At G = 1 these are pack_slots' arrays, byte for byte."""
    for g in ((groups,) if groups else RESIDENT_GROUPS):
        layout = pack_slots(idx, logp, g, max_resident_slots(g))
        if layout is not None:
            packed, book = layout
            deg = packed.shape[0]
            return packed, np.ascontiguousarray(
                book.reshape(deg, g, RESIDENT_CODES).transpose(1, 0, 2)
            ).reshape(g * deg, RESIDENT_CODES)
    return None


def resident_groups(ops: TransOps) -> int:
    """The codebooks a slot of `ops`' resident K6a layout (or of a rank's
    cut of it): the codebook's rows over the packed table's slots."""
    return ops.from_codebook.shape[-2] // ops.from_packed.shape[-2]


def resident_book_rows(groups: int, deg: int, cols: slice,
                       n: int = 4096) -> slice:
    """The codebook rows of K6a's resident layout (`groups` codebooks of
    `deg` slots, block-major) that the states `cols` read: those of the
    blocks the states lie in, one block when they lie in one."""
    g0 = cols.start * groups // n
    g1 = -(-cols.stop * groups // n)
    return slice(g0 * deg, g1 * deg)


def generic_forward_route(ops: TransOps) -> str:
    """Which K6a kernel runs on the card under `ops`, fixed by the table:
    "resident" (the table in shared memory) when it has the packed layout,
    which convert.trans_ops gives every table that fits (resident_layout),
    else "streaming" (the table read from L2 at every step)."""
    return "streaming" if ops.from_packed is None else "resident"


def _check_resident(ops: TransOps, dev, B: int | None = None) -> None:
    """The resident kernel takes a K=6 table's packed layout at G of
    RESIDENT_GROUPS codebooks a slot and 1 to max_resident_slots(G) slots,
    contiguous and 16-byte aligned (its bulk copies) on the launch device:
    (deg, 4096) and (G deg, RESIDENT_CODES), or per read (B, deg, 4096)
    and (B, G deg, RESIDENT_CODES)."""
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    if ops.from_packed is None:
        raise ValueError("the resident generic forward needs the table's "
                         "packed layout (hmm.resident_layout)")
    lead = (B,) if ops.from_packed.dim() == 3 else ()
    deg = ops.from_packed.shape[len(lead)]
    groups = resident_groups(ops)
    if groups not in RESIDENT_GROUPS:
        raise ValueError(f"packed table: codebooks of shape "
                         f"{tuple(ops.from_codebook.shape)} for {deg} slots, "
                         f"the resident kernel takes {RESIDENT_GROUPS} a slot")
    if not 1 <= deg <= max_resident_slots(groups):
        raise ValueError(f"packed table: {deg} slots, the resident kernel "
                         f"takes 1 to {max_resident_slots(groups)} at "
                         f"{groups} codebooks a slot")
    _check("from_packed", ops.from_packed, torch.int16, (*lead, deg, 4096),
           dev)
    _check("from_codebook", ops.from_codebook, torch.float32,
           (*lead, groups * deg, RESIDENT_CODES), dev)
    for name in ("from_packed", "from_codebook"):
        if getattr(ops, name).data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _generic_forward_kernel(ops: TransOps, model: ModelArrays, ev: dict,
                            with_path: bool, resident: bool):
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    n = 4096
    if T < 1:
        raise ValueError("the forward pass needs at least one event column")
    _check_events(ev, B, T, dev)
    if resident:
        _check_resident(ops, dev, B)
        table = (ops.from_packed, ops.from_codebook)
        groups = (resident_groups(ops),)
    else:
        _check_ops(ops, dev, B)
        table = (ops.from_idx, ops.from_logp)
        groups = ()
    _check_tables(tuple(model), B, n, dev)
    _require_cuda(dev, "generic viterbi forward")
    final = torch.empty((B, n), dtype=torch.float32, device=dev)
    bps = (torch.empty((T - 1, B, n), dtype=torch.uint8, device=dev)
           if with_path else None)
    lib = _cuda.load()
    entry = (lib.nc_viterbi_resident_forward if resident
             else lib.nc_viterbi_generic_forward)
    err = entry(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, table[0].shape[-2], *groups,
        *(x.data_ptr() for x in table),
        *(x.data_ptr() for x in model), LOG_2PI, math.log(n),
        final.data_ptr(),
        bps.data_ptr() if with_path and bps.numel() else None,
        int(per_read(ops)), *_cuda.target(dev),
    )
    _cuda.check(err, f"viterbi_{'resident' if resident else 'generic'}"
                     f"_forward kernel launch")
    return final, bps


def generic_forward_path_kernel(ops: TransOps, model: ModelArrays, ev: dict):
    """K6a on the card, the streaming kernel, with backpointers:
    (final_alpha, bps)."""
    out = _generic_forward_kernel(ops, model, ev, True, resident=False)
    _cuda.count_launch(generic_forward_path_kernel)
    return out


def generic_forward_score_kernel(ops: TransOps, model: ModelArrays,
                                 ev: dict):
    """K6a on the card, the streaming kernel, score-only (no backpointer
    stores): final_alpha."""
    final, _ = _generic_forward_kernel(ops, model, ev, False, resident=False)
    _cuda.count_launch(generic_forward_score_kernel)
    return final


def resident_forward_path_kernel(ops: TransOps, model: ModelArrays,
                                 ev: dict):
    """K6a on the card, the resident kernel (the packed table in shared
    memory), with backpointers: (final_alpha, bps)."""
    out = _generic_forward_kernel(ops, model, ev, True, resident=True)
    _cuda.count_launch(resident_forward_path_kernel)
    return out


def resident_forward_score_kernel(ops: TransOps, model: ModelArrays,
                                  ev: dict):
    """K6a on the card, the resident kernel, score-only: final_alpha."""
    final, _ = _generic_forward_kernel(ops, model, ev, False, resident=True)
    _cuda.count_launch(resident_forward_score_kernel)
    return final


generic_forward_path_kernel.launches = 0
generic_forward_score_kernel.launches = 0
resident_forward_path_kernel.launches = 0
resident_forward_score_kernel.launches = 0


def viterbi_forward(ops: TransOps, model: ModelArrays, ev: dict,
                    with_path: bool = True):
    """K6a on the tensors' device: (final_alpha (B, n), bps (T-1, B, n)
    uint8 slot ids or None when with_path is False), under one table or
    per-read tables.  On the card the table picks the kernel
    (generic_forward_route); both give the plain version's bits."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return viterbi_forward_plain(ops, model, ev, with_path)
    if dev.type != "cuda":
        raise ValueError(f"no generic Viterbi forward for device {dev}")
    resident = generic_forward_route(ops) == "resident"
    if with_path:
        return (resident_forward_path_kernel if resident
                else generic_forward_path_kernel)(ops, model, ev)
    return (resident_forward_score_kernel if resident
            else generic_forward_score_kernel)(ops, model, ev), None


# K6b: generic traceback ------------------------------------------------------


def viterbi_traceback_plain(ops: TransOps, final_alpha, bps, lengths):
    """Plain version of K6b (nanocall_tpu/ops/hmm.py:714-753): returns
    (path (B, T) uint16, logp (B,) float32).  The walk starts at the first
    argmax of the final alpha; at t = length-1 it restarts there, so the
    path past a read's length repeats that state."""
    Tm, B, _ = bps.shape
    dev = final_alpha.device
    end_state = torch.argmax(final_alpha, dim=-1).to(torch.int32)
    logp = torch.amax(final_alpha, dim=-1)
    lengths = lengths.to(torch.int32)
    rows = torch.arange(B, device=dev)
    path = torch.empty((B, Tm + 1), dtype=torch.int32, device=dev)
    s = end_state
    for t in range(Tm, 0, -1):
        s_eff = torch.where(t == lengths - 1, end_state, s)
        k = bps[t - 1, rows, s_eff.long()].long()
        s_prev = ops.from_idx[k, s_eff.long()]
        s = torch.where(t <= lengths - 1, s_prev, s_eff)
        path[:, t] = s_eff
    path[:, 0] = s
    return path.to(torch.uint16), logp


def generic_traceback_kernel(ops: TransOps, final_alpha, bps, lengths):
    """K6b on the card, the streaming kernel (one thread walks by dependent
    loads of the backpointer byte and from_idx): (path (B, T) uint16, logp
    (B,))."""
    dev = final_alpha.device
    B, n = final_alpha.shape
    if n != 4096:
        raise ValueError(f"the CUDA generic traceback takes n=4096, got {n}")
    Tm = bps.shape[0]
    _check("final_alpha", final_alpha, torch.float32, (B, n), dev)
    _check("bps", bps, torch.uint8, (Tm, B, n), dev)
    _check("lengths", lengths, torch.int32, (B,), dev)
    _check_ops(ops, dev, B)
    _require_cuda(dev, "generic viterbi traceback")
    path = torch.empty((B, Tm + 1), dtype=torch.uint16, device=dev)
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_viterbi_generic_traceback(
        final_alpha.data_ptr(), bps.data_ptr() if bps.numel() else None,
        lengths.data_ptr(), B, Tm + 1, ops.from_idx.data_ptr(),
        path.data_ptr(), logp.data_ptr(),
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_generic_traceback kernel launch")
    _cuda.count_launch(generic_traceback_kernel)
    return path, logp


generic_traceback_kernel.launches = 0

#: backpointer rows a stage of the traceback walks' ring holds, the fewest
#: stages a walk takes, and the shared memory that K6b's ring kernel leaves
#: to its static arrays (csrc/viterbi_traceback.cu RING_ROWS, MIN_STAGES,
#: TABLE_RING_STATIC)
RING_ROWS = 4
MIN_RING_STAGES = 2
_TABLE_RING_STATIC_SMEM = 512


def traceback_ring_smem_bytes(deg: int, stages: int = MIN_RING_STAGES,
                              n: int = 4096) -> int:
    """K6b's ring kernel's dynamic shared memory: `stages` ring stages of
    RING_ROWS backpointer rows of n bytes, then the (deg, n) uint16
    from-state table."""
    return stages * RING_ROWS * n + deg * 2 * n


#: the most slots whose from-state table fits beside MIN_RING_STAGES
#: stages in one block's shared memory: 24
MAX_TRACEBACK_RING_SLOTS = (
    (SMEM_PER_BLOCK - _TABLE_RING_STATIC_SMEM - traceback_ring_smem_bytes(0))
    // (traceback_ring_smem_bytes(1) - traceback_ring_smem_bytes(0)))


def from_state_table(idx):
    """The from-states of a (deg, 4096) slot table (host array) as K6b's
    ring kernel reads them: a (deg, 4096) uint16 numpy array equal to idx,
    or None unless the table is 4096 wide, has 1 to
    MAX_TRACEBACK_RING_SLOTS slots and states in [0, 4096).  It holds no
    log-prob: every table that small has it, whatever its log-probs."""
    idx = np.asarray(idx)
    deg, n = idx.shape
    if n != 4096 or not 1 <= deg <= MAX_TRACEBACK_RING_SLOTS \
            or idx.min() < 0 or idx.max() >= n:
        return None
    return np.ascontiguousarray(idx, np.uint16)


def make_trans_ops_batch(from_logp, to_logp, K: int) -> TransOps:
    """Per-read structured tables as a TransOps on from_logp's device
    (nanocall_tpu/ops/hmm.py:82-90): from_logp / to_logp (B, 21, n)
    float32 tensors (transitions.build_structured_batch), read b's table
    its own; the slot maps are the fixed 21-slot layout every read shares
    (transitions.slot_from_state; nanocall_tpu/ops/hmm.py:153-157), with
    K6b's from-state table where it fits (from_state_table), each read's
    resident K6a layout where every read's table packs (resident_layout
    at one count of codebooks a slot for every read, the fewest at which
    all pack: the most any read needs; stacked) and each read's resident
    K6c / K6e layout of both sides where every read's two sides pack
    (pack_fwbw_sides, stacked)."""
    dev = from_logp.device
    from_idx, to_idx, _, _ = transitions._slot_maps(K)
    flp = from_logp.detach().cpu().numpy()
    tlp = to_logp.detach().cpu().numpy()

    def stacked(layouts):
        """Each array of the reads' layouts stacked on `dev`, or Nones
        unless every read has one (and there is a read)."""
        if not layouts or None in layouts:
            return None
        return [torch.from_numpy(np.stack(x)).to(dev) for x in zip(*layouts)]

    packed = next((p for p in (
        stacked([resident_layout(from_idx, t, g) for t in flp])
        for g in RESIDENT_GROUPS) if p), (None, None))
    sides = stacked([pack_fwbw_sides(from_idx, f, to_idx, t)
                     for f, t in zip(flp, tlp)])
    states = from_state_table(from_idx)
    return TransOps(
        from_idx=torch.from_numpy(from_idx).to(dev),
        from_logp=from_logp.to(torch.float32).contiguous(),
        to_idx=torch.from_numpy(to_idx).to(dev),
        to_logp=to_logp.to(dev, torch.float32).contiguous(), K=K,
        from_packed=packed[0], from_codebook=packed[1],
        fwbw_packed=None if sides is None else PackedSides(*sides),
        from_states=None if states is None
        else torch.from_numpy(states).to(dev))


def generic_traceback_route(ops: TransOps) -> str:
    """Which K6b kernel runs on the card under `ops`, fixed by the table:
    "ring" (K2's row ring, the from-state table in shared memory) when it
    has from_states, which convert.trans_ops gives every table of at most
    MAX_TRACEBACK_RING_SLOTS slots, else "streaming"."""
    return "streaming" if ops.from_states is None else "ring"


def _check_traceback_ring(ops: TransOps, dev) -> None:
    """The ring kernel takes a K=6 table's from-state table of 1 to
    MAX_TRACEBACK_RING_SLOTS slots, contiguous uint16 and 16-byte aligned
    (its bulk copies) on the launch device."""
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    if ops.from_states is None:
        raise ValueError("the ring traceback needs the table's from-state "
                         "table (hmm.from_state_table)")
    deg = ops.from_states.shape[0]
    if not 1 <= deg <= MAX_TRACEBACK_RING_SLOTS:
        raise ValueError(f"from-state table: {deg} slots, the ring traceback "
                         f"takes 1 to {MAX_TRACEBACK_RING_SLOTS}")
    _check("from_states", ops.from_states, torch.uint16, (deg, 4096), dev)
    if ops.from_states.data_ptr() % 16:
        raise ValueError("from_states is not 16-byte aligned")


def generic_traceback_ring_kernel(ops: TransOps, final_alpha, bps, lengths):
    """K6b on the card, the ring kernel (K2's row ring, the from-state
    table in shared memory): (path (B, T) uint16, logp (B,))."""
    dev = final_alpha.device
    B, n = final_alpha.shape
    if n != 4096:
        raise ValueError(f"the CUDA generic traceback takes n=4096, got {n}")
    Tm = bps.shape[0]
    _check("final_alpha", final_alpha, torch.float32, (B, n), dev)
    _check("bps", bps, torch.uint8, (Tm, B, n), dev)
    _check_rows_aligned(bps)
    _check("lengths", lengths, torch.int32, (B,), dev)
    _check_traceback_ring(ops, dev)
    _require_cuda(dev, "ring generic viterbi traceback")
    path = torch.empty((B, Tm + 1), dtype=torch.uint16, device=dev)
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_viterbi_generic_traceback_ring(
        final_alpha.data_ptr(), bps.data_ptr() if bps.numel() else None,
        lengths.data_ptr(), B, Tm + 1, ops.from_states.shape[0],
        ops.from_states.data_ptr(), path.data_ptr(), logp.data_ptr(),
        *_cuda.target(dev),
    )
    _cuda.check(err, "viterbi_generic_traceback_ring kernel launch")
    _cuda.count_launch(generic_traceback_ring_kernel)
    return path, logp


generic_traceback_ring_kernel.launches = 0


def viterbi_traceback(ops: TransOps, final_alpha, bps, lengths):
    """K6b on the tensors' device: (path (B, T) uint16, logp (B,)).  On the
    card the table picks the kernel (generic_traceback_route); both give
    the plain version's bits."""
    dev = final_alpha.device
    if dev.type == "cpu":
        return viterbi_traceback_plain(ops, final_alpha, bps, lengths)
    if dev.type != "cuda":
        raise ValueError(f"no generic traceback for device {dev}")
    if generic_traceback_route(ops) == "ring":
        return generic_traceback_ring_kernel(ops, final_alpha, bps, lengths)
    return generic_traceback_kernel(ops, final_alpha, bps, lengths)


def viterbi_decode(ops: TransOps, model: ModelArrays, ev: dict,
                   with_path: bool = True) -> dict:
    """Viterbi decode under a loaded table (nanocall_tpu/ops/hmm.py:759-768):
    {"logp"} when with_path is False, else {"path" (B, T) uint16, "logp"}."""
    final_alpha, bps = viterbi_forward(ops, model, ev, with_path)
    if not with_path:
        return {"logp": torch.amax(final_alpha, dim=-1)}
    path, logp = viterbi_traceback(ops, final_alpha, bps, ev["length"])
    return {"path": path, "logp": logp}


# K6am / K6bm: the generic decode with the states split over ranks ----------
#
# The generic decode (K6a + K6b) under nanocall_tpu/parallel/mesh.py:75
# shard_decode_inputs (parallel/statepar.py drives it, on K1m's schedule).
# Rank m holds the states [m W, (m + 1) W), W = n / M: the (deg, W) cut of
# the table's from side (per read (B, deg, W) log-probs; the cut of the
# resident layout where the table has one: its entries at the rank's
# states and the codebooks of the blocks they lie in), its (B, W) scaled
# model, a (2, B, W) column buffer, B step counters and its (T - 1, B, W)
# backpointer bytes.  A step needs the whole previous column, since a
# loaded table's from-states lie anywhere: on the cluster path every rank
# pushes its slice into its peers' shared memory, and stores only the last
# two columns into its buffer; on the cooperative path it reads every
# rank's buffer.


class GenericWaveRank(NamedTuple):
    """One rank of a data row of the generic decode, on the rank's device:
    ops, its cut of the table (from_idx (deg, W) int32, from_logp (deg, W)
    or per read (B, deg, W) float32, from_packed / from_codebook the cut of
    the resident layout or None: the (deg, W) entries and the codebook rows
    of the blocks its states lie in, resident_book_rows; the to side
    unused), its (B, W) scaled model, the row's (B, T) events and (B,)
    lengths, its column buffer col (2, B, W) float32, its backpointers bps
    (T - 1, B, W) uint8 (None: score-only) and its step counters flags
    (B,) int32, zero before the decode (K6am's exchange; the plain version
    leaves them)."""

    ops: TransOps
    model: ModelArrays
    ev: dict
    col: torch.Tensor
    bps: torch.Tensor | None
    flags: torch.Tensor


def viterbi_forward_generic_slice_plain(ops: TransOps, model: ModelArrays,
                                        ev: dict, column, t: int, lo: int,
                                        alpha_out, bp_out=None) -> None:
    """One rank's step, the plain version of K6am's step: event t's alpha at
    the states [lo, lo + W) into alpha_out (B, W), and at t >= 1 their slot
    backpointers into bp_out (B, W) uint8 (None: score-only).  ops and
    model hold the rank's cut (GenericWaveRank), ev the (B, T) events and
    lengths whole; column is the alpha of event t - 1 as its M slices (an
    (M, B, W) tensor or M (B, W) tensors on any devices; unread at t = 0).
    The step of viterbi_forward_plain for these states: every state's max
    and slot run over its own slots, from the whole column."""
    M, W = len(column), column[0].shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    if t == 0:
        alpha_out.copy_(log_emission(model, mean[:, 0], stdv[:, 0],
                                     log_stdv[:, 0]) - math.log(M * W))
        return
    alpha = gather_column(column, mean.device)
    vals = ops.from_logp + gather_slots(alpha, ops.from_idx)
    best = torch.amax(vals, dim=1)
    if bp_out is not None:
        masked = torch.where(vals == best[:, None], ops.from_idx, _BIG)
        bp_out.copy_(torch.argmin(masked, dim=1).to(torch.uint8))
    em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
    alpha_out.copy_(torch.where((t < ev["length"])[:, None], best + em,
                                alpha[:, lo:lo + W]))


def viterbi_forward_generic_wave_plain(ranks, lo: int, hi: int) -> None:
    """Plain version of K6am: events 0 .. T - 1 of the reads [lo, hi) for
    every rank of a data row (ranks: its M GenericWaveRanks in rank order),
    each step every rank's viterbi_forward_generic_slice_plain on the
    peers' slices of the previous column, read in place from their
    col[(t - 1) % 2], into its col[t % 2] and bps[t - 1].  The counters are
    left as they are."""
    rows = slice(lo, hi)
    T, W = ranks[0].ev["mean"].shape[1], ranks[0].col.shape[-1]
    parts = [(r.ops._replace(from_logp=r.ops.from_logp[rows])
              if per_read(r.ops) else r.ops,
              ModelArrays(*(x[rows] for x in r.model)),
              {k: v[rows] for k, v in r.ev.items()}) for r in ranks]
    for t in range(T):
        column = [r.col[(t - 1) % 2, rows] for r in ranks]
        for m, (r, (ops, model, ev)) in enumerate(zip(ranks, parts)):
            viterbi_forward_generic_slice_plain(
                ops, model, ev, column, t, m * W, r.col[t % 2, rows],
                r.bps[t - 1, rows] if r.bps is not None and t else None)


#: generic_wave_resident's answers, by (card index, with_path, sys,
#: resident, deg, W, cluster, groups)
_generic_resident: dict = {}


def generic_wave_resident(dev, with_path: bool, sys: bool, resident: bool,
                          deg: int, W: int, cluster: bool = False,
                          groups: int = 1) -> int:
    """The most blocks of K6am's instance (with_path; sys: the exchange
    across cards; resident, at deg slots, `groups` codebook rows a slot in
    the rank's cut and slices of W states, whose shared memory it sets)
    that the CUDA device `dev` holds at once: a cooperative wave's grid,
    reads times the card's ranks, must not exceed it; cluster: the blocks
    of the most clusters of the cluster path it holds at once."""
    key = (torch.device(dev).index, bool(with_path), bool(sys),
           bool(resident), int(deg), int(W), bool(cluster), int(groups))
    if key not in _generic_resident:
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_viterbi_generic_wave_resident(
            int(with_path), int(sys), int(resident), int(deg), int(groups),
            _slice_shift(4096 // W, W), int(cluster), key[0],
            ctypes.byref(blocks)), "viterbi_generic_wave occupancy")
        _generic_resident[key] = blocks.value
    return _generic_resident[key]


def _check_aligned(name: str, x: torch.Tensor) -> None:
    if x.data_ptr() % 16:  # read as 16-byte vectors or bulk copies
        raise ValueError(f"{name} is not 16-byte aligned")


def cut_groups(W: int) -> tuple:
    """The codebook rows a slot that a rank's cut of K6a's resident layout
    holds at slices of W states (resident_book_rows), for each count of
    RESIDENT_GROUPS: one block's, or the W / 1024 blocks of a slice that
    spans several."""
    return tuple(sorted({max(1, W * g // 4096) for g in RESIDENT_GROUPS}))


def _check_generic_wave_rank(m: int, r: GenericWaveRank, B: int, T: int,
                             W: int, with_path: bool, resident: bool) -> tuple:
    """A rank's part as K6am takes it; returns its slot count and (resident)
    its cut's codebook rows a slot (else 1)."""
    dev = r.ev["mean"].device
    ops = r.ops
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    if (r.bps is not None) != with_path:
        raise ValueError("the ranks' backpointers are given for some ranks "
                         "only")
    if (generic_forward_route(ops) == "resident") != resident:
        raise ValueError("the ranks' cuts differ in their layout")
    _check_events(r.ev, B, T, dev)
    _check_tables(tuple(r.model), B, W, dev)
    lead = (B,) if per_read(ops) else ()
    groups = 1
    if resident:
        deg = ops.from_packed.shape[-2]
        if not 1 <= deg <= MAX_RESIDENT_SLOTS:
            raise ValueError(f"packed table: {deg} slots, the resident K6am "
                             f"takes 1 to {MAX_RESIDENT_SLOTS}")
        groups = resident_groups(ops)
        if groups not in cut_groups(W):
            raise ValueError(
                f"ranks[{m}]: codebooks of shape "
                f"{tuple(ops.from_codebook.shape)} for {deg} slots; a cut "
                f"of {W} states holds {cut_groups(W)} codebooks a slot")
        _check(f"ranks[{m}].ops.from_packed", ops.from_packed, torch.int16,
               (*lead, deg, W), dev)
        _check(f"ranks[{m}].ops.from_codebook", ops.from_codebook,
               torch.float32, (*lead, groups * deg, RESIDENT_CODES), dev)
        tables = (ops.from_packed, ops.from_codebook)
    else:
        deg = ops.from_idx.shape[0]
        if not 1 <= deg <= MAX_SLOTS:
            raise ValueError(f"table: {deg} slots, the kernels take 1 to "
                             f"{MAX_SLOTS}")
        _check(f"ranks[{m}].ops.from_idx", ops.from_idx, torch.int32,
               (deg, W), dev)
        _check(f"ranks[{m}].ops.from_logp", ops.from_logp, torch.float32,
               (*lead, deg, W), dev)
        tables = (ops.from_idx, ops.from_logp)
    for name, x in zip(("table", "values"), tables):
        _check_aligned(f"ranks[{m}].{name}", x)
    _check(f"ranks[{m}].col", r.col, torch.float32, (2, B, W), dev)
    _check_aligned(f"ranks[{m}].col", r.col)
    _check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)
    if with_path:
        _check(f"ranks[{m}].bps", r.bps, torch.uint8, (T - 1, B, W), dev)
        if r.bps.data_ptr() % 4:  # stored a 32-bit word a thread
            raise ValueError(f"ranks[{m}].bps is not 4-byte aligned")
    return deg, groups


def _generic_wave_kernel(ranks, local, lo: int, hi: int, resident: bool,
                         cluster: bool | None) -> None:
    devices = [r.ev["mean"].device for r in ranks]
    cluster = cluster_path(len(ranks), len(set(devices)) > 1, len(local),
                           cluster)
    B, T, W, shift, dev, sys = _wave_setup(ranks, local, lo, hi, "K6am")
    with_path = ranks[0].bps is not None
    degs, modes = set(), set()
    for m, r in enumerate(ranks):
        degs.add(_check_generic_wave_rank(m, r, B, T, W, with_path,
                                          resident))
        modes.add(per_read(r.ops))
    if len(degs) != 1 or len(modes) != 1:
        raise ValueError(f"the ranks' cuts differ: (slots, codebooks a "
                         f"slot) {degs}, per-read {modes}")
    deg, groups = degs.pop()
    vals = []
    for r in ranks:
        tables = ((r.ops.from_packed, r.ops.from_codebook) if resident
                  else (r.ops.from_idx, r.ops.from_logp))
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 *(x.data_ptr() for x in tables),
                 *(x.data_ptr() for x in r.model), r.col.data_ptr(),
                 r.bps.data_ptr() if with_path and r.bps.numel() else 0,
                 r.flags.data_ptr()]
    table = _rank_table(vals, local, dev)
    err = _cuda.load().nc_viterbi_generic_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift, deg, groups,
        int(modes.pop()), int(with_path), int(sys), int(resident),
        int(cluster), LOG_2PI, math.log(len(ranks) * W),
        int(WAVE_TIMEOUT_S * 1e9), _timed_out.data_ptr(),
        *_cuda.target(dev))
    _cuda.check(err, "viterbi_generic_wave kernel launch")


def generic_wave_resident_kernel(ranks, local, lo: int, hi: int,
                                 cluster: bool | None = None) -> None:
    """K6am on the card, the resident form (each rank's packed cut and its
    codebooks in shared memory): viterbi_forward_generic_wave_plain's work
    for the ranks `local` (indices into `ranks`, all on one card; 2 to 64
    ranks in all) over the reads [lo, hi), one launch on that card's
    current stream, blocks of W / 2 threads.  cluster (cluster_path: by
    default where wave_cluster(M, sys) says and `local` holds every rank):
    each read's M blocks one thread block cluster, exchanging through their
    shared memory, any number of reads.  Else one cooperative launch, whose
    grid (hi - lo reads x len(local) ranks) must fit the card at once
    (generic_wave_resident), or the launch raises; the other ranks run
    their blocks of the same reads in a launch of their own card; their
    slices and counters are read over peer access, and a block waits
    WAVE_TIMEOUT_S on a peer at most.  Raises if a wave of this process
    timed out (wave_timeout)."""
    _generic_wave_kernel(ranks, local, lo, hi, True, cluster)
    _cuda.count_launch(generic_wave_resident_kernel)


def generic_wave_streaming_kernel(ranks, local, lo: int, hi: int,
                                  cluster: bool | None = None) -> None:
    """K6am on the card, the streaming form (each rank's int32 / float32
    cut read from L2 at every step): as generic_wave_resident_kernel."""
    _generic_wave_kernel(ranks, local, lo, hi, False, cluster)
    _cuda.count_launch(generic_wave_streaming_kernel)


generic_wave_resident_kernel.launches = 0
generic_wave_streaming_kernel.launches = 0


def forward_generic_wave_kernel(ranks, local, lo: int, hi: int,
                                cluster: bool | None = None) -> None:
    """K6am on the card in the form the ranks' cuts take
    (generic_forward_route: the resident one where the cut has the packed
    layout), on the exchange path `cluster` chooses (cluster_path)."""
    if generic_forward_route(ranks[0].ops) == "resident":
        generic_wave_resident_kernel(ranks, local, lo, hi, cluster)
    else:
        generic_wave_streaming_kernel(ranks, local, lo, hi, cluster)


def viterbi_traceback_generic_slices_plain(ops: TransOps, column, bp_slices,
                                           lengths):
    """Plain version of K6bm: K6b's end argmax and walk
    (viterbi_traceback_plain) over the M ranks' slices of the final column
    (an (M, B, W) tensor or M (B, W) tensors) and their backpointer slices
    bp_slices[m] (T - 1, B, W) uint8, on any devices; ops holds the whole
    from side (from_idx (deg, n)) on lengths' device.  (path (B, T)
    uint16, logp (B,)) on lengths' device."""
    dev = lengths.device
    return viterbi_traceback_plain(
        ops, gather_column(column, dev),
        torch.cat([sl.to(dev) for sl in bp_slices], dim=2), lengths)


def generic_traceback_slices_kernel(ops: TransOps, column, bp_slices,
                                    lengths, route: str | None = None):
    """K6bm on the card: as viterbi_traceback_generic_slices_plain,
    launched on lengths' card (K6b's ring kernel, each stage filled from
    the ranks' slices), with the table's from-state table in shared memory
    where it has one (ops.from_states, K6b's ring rule), else from_idx read
    from global memory.  One data row: column its M (B, W) final slices,
    bp_slices its M (T - 1, B, W) backpointer slices, lengths (B,):
    returns (path (B, T) uint16, logp (B,)).  Several rows of B reads in
    one launch under the same table: each argument a list a row: returns a
    list of (path, logp).  route as traceback_slices_kernel's."""
    columns, bp_rows, lengths, one = _slice_rows(column, bp_slices, lengths)
    dev = lengths[0].device
    _require_cuda(dev, "generic viterbi traceback slices")
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    if ops.from_states is not None:
        _check_traceback_ring(ops, dev)
        from_t, rule = ops.from_states, 1
    else:
        from_t, rule = ops.from_idx, 0
        if not 1 <= from_t.shape[0] <= MAX_SLOTS:
            raise ValueError(f"table: {from_t.shape[0]} slots, the kernels "
                             f"take 1 to {MAX_SLOTS}")
        _check("from_idx", from_t, torch.int32, (from_t.shape[0], 4096), dev)
    a = _slices_walk_args(columns, bp_rows, lengths, route,
                          "generic viterbi traceback slices")
    R, B, Tm = a["R"], a["B"], a["Tm"]
    path = torch.empty((R, B, Tm + 1), dtype=torch.uint16, device=dev)
    logp = torch.empty((R, B), dtype=torch.float32, device=dev)
    err = _cuda.load().nc_viterbi_generic_traceback_slices(
        a["table"].data_ptr(), a["bps"], int(a["route"] == "tensor"), R, B,
        Tm + 1, a["shift"], from_t.shape[0], from_t.data_ptr(), rule,
        path.data_ptr(), logp.data_ptr(), *_cuda.target(dev))
    _cuda.check(err, "viterbi_generic_traceback_slices kernel launch")
    _cuda.count_launch(generic_traceback_slices_kernel, a["route"])
    out = list(zip(path, logp))
    return out[0] if one else out


generic_traceback_slices_kernel.launches = 0
generic_traceback_slices_kernel.routes = {"tensor": 0, "copies": 0}


# K6c: generic forward-backward -----------------------------------------------


def fwbw_plain(ops: TransOps, model: ModelArrays, ev: dict) -> dict:
    """Plain version of K6c (nanocall_tpu/ops/hmm.py:784-849, with
    keep_emissions): exact log-space forward and backward over the slot
    tables, loops over events.  Returns {alpha, beta, em: (B, T, n)
    float32, log_pr_data: (B,)}; alpha rows past a read's length repeat its
    last alpha, beta is 0 from t = length-1 on.  Per-read (B, deg, n)
    log-probs broadcast as JAX's do."""
    n = model.level_mean.shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    dev = mean.device
    alphas = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    betas = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    ems = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    em = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0])
    alpha = em - math.log(n)
    alphas[:, 0], ems[:, 0] = alpha, em
    for t in range(1, T):
        vals = ops.from_logp + gather_slots(alpha, ops.from_idx)
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        new_alpha = em + logsumexp_slots(vals)
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
        alphas[:, t], ems[:, t] = alpha, em
    mfin = torch.amax(alpha, dim=-1)
    lpd = mfin + torch.log(tree_sum(torch.exp(alpha - mfin[:, None])))
    beta = torch.zeros((B, n), dtype=torch.float32, device=dev)
    betas[:, T - 1] = beta
    for t in range(T - 2, -1, -1):
        g = ems[:, t + 1] + beta
        cand = logsumexp_slots(ops.to_logp + gather_slots(g, ops.to_idx))
        beta = torch.where((t >= lengths - 1)[:, None], 0.0, cand)
        betas[:, t] = beta
    return {"alpha": alphas, "beta": betas, "em": ems, "log_pr_data": lpd}


#: the resident K6c's static shared memory: its mbarrier and two (32,)
#: float32 arrays of per-warp partials
_FWBW_RESIDENT_STATIC_SMEM = 8 + 2 * 4 * 32


def fwbw_resident_smem_bytes(deg: int, n: int = 4096) -> int:
    """The resident K6c's dynamic shared memory at `deg` slots (the larger
    side's): two float32 buffers of the gathered vector, one side's
    codebooks and 16-bit table."""
    return 2 * 4 * n + deg * (4 * FWBW_GROUPS * RESIDENT_CODES + 2 * n)


#: the most slots a side of the resident K6c's layout may have: 23
MAX_FWBW_RESIDENT_SLOTS = ((SMEM_PER_BLOCK - _FWBW_RESIDENT_STATIC_SMEM
                            - fwbw_resident_smem_bytes(0))
                           // (fwbw_resident_smem_bytes(1)
                               - fwbw_resident_smem_bytes(0)))


def pack_fwbw_sides(from_idx, from_logp, to_idx, to_logp):
    """Both sides of a table in the resident K6c's layout, as four numpy
    arrays (from_packed, from_codebook, to_packed, to_codebook), or None
    unless both sides have it (pack_slots with groups = FWBW_GROUPS and at
    most MAX_FWBW_RESIDENT_SLOTS slots)."""
    sides = [pack_slots(idx, lp, FWBW_GROUPS, MAX_FWBW_RESIDENT_SLOTS)
             for idx, lp in ((from_idx, from_logp), (to_idx, to_logp))]
    if None in sides:
        return None
    return (*sides[0], *sides[1])


def fwbw_route(ops: TransOps) -> str:
    """Which K6c (and K6e) kernel runs on the card under `ops`, fixed by
    the table:
    "resident" (a side's table in shared memory at a time) when it has both
    sides' packed layout, which convert.trans_ops gives every table that
    fits (make_trans_ops_batch per-read tables whose reads all fit), else
    "streaming" (the tables read from L2 at every step, by the one-card
    split)."""
    return "streaming" if ops.fwbw_packed is None else "resident"


def _fwbw_outputs(B: int, T: int, n: int, dev) -> dict:
    out = {k: torch.empty((B, T, n), dtype=torch.float32, device=dev)
           for k in ("alpha", "beta", "em")}
    out["log_pr_data"] = torch.empty(B, dtype=torch.float32, device=dev)
    return out


def _check_fwbw_resident(ops: TransOps, dev, B: int) -> None:
    """The resident K6c and K6e take a K=6 table's packed layout of both
    sides, 1 to MAX_FWBW_RESIDENT_SLOTS slots a side, contiguous and
    16-byte aligned (their bulk copies) on the launch device: (deg, 4096)
    int16 entries and (deg, FWBW_GROUPS * RESIDENT_CODES) codebooks a side,
    or per read (B, deg, 4096) and (B, deg, FWBW_GROUPS * RESIDENT_CODES)
    of the events' B (each read's slice then starts 16-byte aligned too:
    deg 8192 and deg 256 bytes on)."""
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    if ops.fwbw_packed is None:
        raise ValueError("the resident generic fwbw needs the table's "
                         "packed layout of both sides (hmm.pack_fwbw_sides)")
    width = FWBW_GROUPS * RESIDENT_CODES
    lead = (B,) if per_read(ops) else ()
    for side in ("from", "to"):
        packed = getattr(ops.fwbw_packed, f"{side}_packed")
        book = getattr(ops.fwbw_packed, f"{side}_codebook")
        deg = packed.shape[-2]
        if not 1 <= deg <= MAX_FWBW_RESIDENT_SLOTS:
            raise ValueError(f"packed {side} table: {deg} slots, the "
                             f"resident fwbw takes 1 to "
                             f"{MAX_FWBW_RESIDENT_SLOTS}")
        _check(f"{side}_packed", packed, torch.int16, (*lead, deg, 4096),
               dev)
        _check(f"{side}_codebook", book, torch.float32, (*lead, deg, width),
               dev)
        for name, x in ((f"{side}_packed", packed),
                        (f"{side}_codebook", book)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned")


#: the C entries of K6c's and K6e's resident kernels by custom, and what
#: their wrappers call them
_FWBW_ENTRIES = {
    False: ("nc_fwbw_resident", "resident generic fwbw"),
    True: ("nc_fwbw_custom_resident", "resident custom fwbw"),
}


def _check_fwbw(ops: TransOps, model: ModelArrays, ev: dict,
                resident: bool, what: str) -> tuple:
    """The checks of every K6c and K6e launch (what: the kernel's name
    for the error): events, the table (its packed layout, resident), the
    model rows, a CUDA device.  Returns (B, T, the four table tensors)."""
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    if T < 1:
        raise ValueError("forward-backward needs at least one event column")
    _check_events(ev, B, T, dev)
    if resident:
        _check_fwbw_resident(ops, dev, B)
        table = tuple(ops.fwbw_packed)
    else:
        _check_ops(ops, dev, B)
        table = (ops.from_idx, ops.from_logp, ops.to_idx, ops.to_logp)
    _check_tables(tuple(model), B, 4096, dev)
    _require_cuda(dev, what)
    return B, T, table


def _fwbw_resident_launch(ops: TransOps, model: ModelArrays, ev: dict,
                          custom: bool) -> dict:
    """One launch of K6c's (custom: K6e's) resident kernel on the card,
    under one table or per-read tables (the kernel's per-read instance),
    once every shape is checked: K6c's {alpha, beta, em (B, T, n),
    log_pr_data (B,)} or K6e's {alpha, beta, gamma}, as the plain version.
    The wrappers below call it and count the launch."""
    mean = ev["mean"]
    dev = mean.device
    n = 4096
    entry, what = _FWBW_ENTRIES[custom]
    B, T, table = _check_fwbw(ops, model, ev, True, what)
    if custom:
        out, keys = _custom_outputs(B, T, n, dev), ("alpha", "beta", "gamma")
    else:
        out, keys = (_fwbw_outputs(B, T, n, dev),
                     ("alpha", "beta", "em", "log_pr_data"))
    err = getattr(_cuda.load(), entry)(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, table[0].shape[-2],
        table[0].data_ptr(), table[1].data_ptr(), table[2].shape[-2],
        table[2].data_ptr(), table[3].data_ptr(),
        *(x.data_ptr() for x in model), LOG_2PI, math.log(n),
        *(out[k].data_ptr() for k in keys),
        int(per_read(ops)), *_cuda.target(dev),
    )
    _cuda.check(err, f"{entry[3:]} kernel launch")
    return out


def _require_per_read(ops: TransOps, what: str) -> None:
    if not per_read(ops):
        raise ValueError(f"{what} takes per-read (B, deg, n) tables "
                         f"(make_trans_ops_batch), not one (deg, n) table")


def fwbw_generic_kernel(ops: TransOps, model: ModelArrays, ev: dict,
                        states: int | None = None) -> dict:
    """K6c on the card under a table that streams, the one-card split
    (csrc/fwbw_split.cu) with `states` a thread (by default
    fwbw_stream_split's): the forward and the backward pass in one launch,
    {alpha, beta, em (B, T, n), log_pr_data (B,)} as the plain version.
    Per-read tables take the per-read instance
    (fwbw_generic_per_read_kernel)."""
    if per_read(ops):
        return fwbw_generic_per_read_kernel(ops, model, ev, states)
    out = _fwbw_split_launch(ops, model, ev, states, custom=False)
    _cuda.count_launch(fwbw_generic_kernel)
    return out


def fwbw_generic_per_read_kernel(ops: TransOps, model: ModelArrays,
                                 ev: dict, states: int | None = None) -> dict:
    """fwbw_generic_kernel under per-read tables (its per-read instance:
    read b's (deg, n) log-probs of both sides, every read's from_idx and
    to_idx)."""
    _require_per_read(ops, "the per-read streaming fwbw")
    out = _fwbw_split_launch(ops, model, ev, states, custom=False)
    _cuda.count_launch(fwbw_generic_per_read_kernel)
    return out


def fwbw_resident_kernel(ops: TransOps, model: ModelArrays,
                         ev: dict) -> dict:
    """K6c on the card, the resident kernel (each side's packed table in
    shared memory in turn): {alpha, beta, em (B, T, n), log_pr_data (B,)}
    as the plain version.  Per-read tables take the per-read instance
    (fwbw_resident_per_read_kernel)."""
    if per_read(ops):
        return fwbw_resident_per_read_kernel(ops, model, ev)
    out = _fwbw_resident_launch(ops, model, ev, custom=False)
    _cuda.count_launch(fwbw_resident_kernel)
    return out


def fwbw_resident_per_read_kernel(ops: TransOps, model: ModelArrays,
                                  ev: dict) -> dict:
    """K6c's resident kernel under per-read tables (its per-read instance:
    block b copies read b's packed layout of each side)."""
    _require_per_read(ops, "the per-read resident fwbw")
    out = _fwbw_resident_launch(ops, model, ev, custom=False)
    _cuda.count_launch(fwbw_resident_per_read_kernel)
    return out


fwbw_generic_kernel.launches = 0
fwbw_generic_per_read_kernel.launches = 0
fwbw_resident_kernel.launches = 0
fwbw_resident_per_read_kernel.launches = 0


def fwbw(ops: TransOps, model: ModelArrays, ev: dict) -> dict:
    """K6c on the tensors' device: {alpha, beta, em (B, T, n),
    log_pr_data (B,)}, under one table or per-read tables.  On the card
    the table picks the kernel (fwbw_route), and per-read tables its
    per-read instance; all give the plain version's bits."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return fwbw_plain(ops, model, ev)
    if dev.type != "cuda":
        raise ValueError(f"no generic fwbw for device {dev}")
    if fwbw_route(ops) == "resident":
        return fwbw_resident_kernel(ops, model, ev)
    return fwbw_generic_kernel(ops, model, ev)


# K6cm: K6c with the states split over M ranks (the legacy EM round on the
# state axis, parallel/statepar.py).  Rank m holds the states [m W, (m +
# 1) W), W = n / M: its (deg, W) cut of both sides' slot tables (and of
# the resident layout), its (B, W) scaled model and its (B, T, W) slices of
# alpha, beta and em.  A loaded table's from- and to-states lie anywhere,
# so every step, forward and backward, each rank needs the whole column
# (alpha of event t - 1; g = em(t + 1) + beta).  A block takes
# fwbw_wave_reads reads of the row under its rank's one cut; the ranks
# exchange the columns on one card of at most MAX_CLUSTER ranks as a
# thread block cluster a read group, each rank pushing its values into its
# peers' shared memory onto their mbarriers; else a cooperative grid
# behind counters, the slices in the ranks' (2, B, W) buffers.

#: the most reads a K6cm block takes (csrc/fwbw_generic_wave.cu MAX_READS)
FWBW_WAVE_MAX_READS = 8
#: K6cm's static shared memory, rounded up: the cooperative exchange's
#: pointer tables, its mbarriers, the per-warp partials of 8 reads
_FWBW_WAVE_STATIC_SMEM = 6144
#: the dynamic shared memory a K6cm block may take
FWBW_WAVE_SMEM = SMEM_PER_BLOCK - _FWBW_WAVE_STATIC_SMEM


def fwbw_wave_smem(reads: int, W: int, deg: int, resident: bool,
                   cluster: bool) -> int:
    """K6cm's dynamic shared memory for `reads` reads a block at slices of
    W states (csrc/fwbw_generic_wave.cu fwbw_wave_smem): each read's
    column of n float32 and 32 / reads more, a bank shift (both parities
    on the cluster path), the vote words (cluster and resident: 32 a read
    and parity), each thread's two buffers of its 4 states' em, and
    resident the codebooks and cut of the larger side's deg slots."""
    cols = (2 if cluster else 1) * reads * (4096 + 32 // reads) * 4
    votes = 2 * 32 * reads * 4 if cluster and resident else 0
    ems = 2 * 4 * 4 * reads * W // 4
    cut = deg * (4 * FWBW_GROUPS * RESIDENT_CODES + 2 * W) if resident else 0
    return cols + votes + ems + cut


def fwbw_wave_reads(W: int, deg: int, resident: bool, cluster: bool) -> int:
    """K6cm's reads a block, R, at slices of W states and deg slots (the
    larger side's), in its resident or streaming form on the cluster or
    the cooperative path, a block holding R W / 4 threads (at least a
    warp).  The cooperative path: the most reads, a power of two up to
    FWBW_WAVE_MAX_READS and n / W, whose fwbw_wave_smem fits FWBW_WAVE_SMEM
    (one rendezvous behind the counters a step serves them all).  The
    cluster path: the fewest where two such blocks share an SM's shared
    memory (SMEM_PER_SM, each with its static share and the runtime's 1
    KiB), so that the SMs take whole clusters and the blocks hide each
    other's waits; else (a block of one read fills its SM, as the resident
    cut of 2048 states does) the most, so that the one cut serves them
    all.  0 when no block fits (the wrappers then refuse the cut)."""
    def fits(R):
        return fwbw_wave_smem(R, W, deg, resident, cluster) <= FWBW_WAVE_SMEM

    R = 1
    while R * W // 4 < 32:
        R *= 2
    if not fits(R):
        return 0
    share = fwbw_wave_smem(R, W, deg, resident, cluster) \
        + _FWBW_WAVE_STATIC_SMEM + 1024
    if cluster and 2 * share <= SMEM_PER_SM:
        return R
    while (2 * R <= min(FWBW_WAVE_MAX_READS, 4096 // W)
           and fits(2 * R)):
        R *= 2
    return R


def fwbw_wave_grid(n_reads: int, M: int, reads: int, cluster: bool,
                   n_local: int | None = None) -> dict:
    """The shape of a K6cm launch over n_reads reads of a row of M ranks
    at `reads` reads a block, as the launch takes it (nc_fwbw_generic_wave
    refuses any other): {"grid": (x, y), "block": threads, "cluster":
    blocks a cluster or None}: on the cluster path (M, read groups),
    clusters of the group's M ranks; else a cooperative grid (read groups,
    the n_local ranks of the launch's card)."""
    groups = -(-n_reads // reads)
    block = reads * (4096 // M) // 4
    if cluster:
        return {"grid": (M, groups), "block": block, "cluster": M}
    return {"grid": (groups, M if n_local is None else n_local),
            "block": block, "cluster": None}


class FwbwWaveRank(NamedTuple):
    """One rank of a data row of the generic forward-backward, on the
    rank's device: ops, its cut of the table (from_idx, from_logp, to_idx,
    to_logp (deg, W) at its states, and fwbw_packed the cut of K6c's
    resident layout, each side's (deg, W) entries with its codebooks whole,
    or None), its (B, W) scaled model, the row's (B, T) events and (B,)
    lengths whole; its outputs alpha, beta, em (B, T, W) float32 (its
    slices of K6c's) and lpd (B,) (log Pr[data], every rank's copy); its
    exchange buffers col (2, B, W) float32 (its slice of the exchanged
    column at the exchange's parity) and part (2, B) float32 (its partial
    max and partial sum of the final alpha), and its step counters flags
    (B,) int32, zero before each launch (K6cm's exchange; the plain
    version leaves them)."""

    ops: TransOps
    model: ModelArrays
    ev: dict
    alpha: torch.Tensor
    beta: torch.Tensor
    em: torch.Tensor
    lpd: torch.Tensor
    col: torch.Tensor
    part: torch.Tensor
    flags: torch.Tensor


def cut_fwbw_table(ops: TransOps, cols: slice, dev) -> TransOps:
    """A rank's cut of a table for K6cm: both sides' slot tables and their
    resident layout at the states `cols`, the codebooks whole, on `dev`."""
    refuse_per_read(ops, "the generic forward-backward on the state axis")

    def cut(x):
        return x[..., cols].contiguous().to(dev)

    p = ops.fwbw_packed
    return TransOps(
        from_idx=cut(ops.from_idx), from_logp=cut(ops.from_logp),
        to_idx=cut(ops.to_idx), to_logp=cut(ops.to_logp), K=ops.K,
        fwbw_packed=None if p is None else PackedSides(
            cut(p.from_packed), p.from_codebook.contiguous().to(dev),
            cut(p.to_packed), p.to_codebook.contiguous().to(dev)))


def fwbw_generic_wave_plain(ranks, lo: int, hi: int) -> None:
    """Plain version of K6cm: fwbw_plain's forward and backward over the
    reads [lo, hi) for every rank of a data row (ranks: its M
    FwbwWaveRanks in rank order), each rank stepping its own states from
    the whole column gathered from the ranks' slices: forward, em(t) and
    alpha(t) = em + the slot log-sum-exp of from_logp + alpha(t - 1)
    [from_idx] (alpha(t - 1) kept from t = length on; em(0) - log n at t =
    0); log Pr[data] from the ranks' partial maxima of the final alpha and
    their tree sums of exp(alpha - max), combined by combine_rank_sums
    (part[0], part[1]); backward, beta = 0 at T - 1 and from t = length - 1
    on, else the slot log-sum-exp of to_logp + g[to_idx], g = em(t + 1) +
    beta(t + 1) of every rank.  The counters and col are left as they
    are."""
    rows = slice(lo, hi)
    T = ranks[0].ev["mean"].shape[1]
    W = ranks[0].col.shape[-1]
    n = len(ranks) * W
    parts = [(r.ops, ModelArrays(*(x[rows] for x in r.model)),
              {k: v[rows] for k, v in r.ev.items()}) for r in ranks]
    for t in range(T):
        column = [r.alpha[rows, t - 1] for r in ranks] if t else None
        for m, (r, (ops, model, ev)) in enumerate(zip(ranks, parts)):
            dev = ev["mean"].device
            em = log_emission(model, ev["mean"][:, t], ev["stdv"][:, t],
                              ev["log_stdv"][:, t])
            if t == 0:
                alpha = em - math.log(n)
            else:
                col = gather_column(column, dev)
                vals = ops.from_logp + gather_slots(col, ops.from_idx)
                alpha = torch.where((t < ev["length"])[:, None],
                                    em + logsumexp_slots(vals),
                                    col[:, m * W:(m + 1) * W])
            r.alpha[rows, t] = alpha
            r.em[rows, t] = em
    for r in ranks:
        r.part[0, rows] = torch.amax(r.alpha[rows, T - 1], dim=-1)
    for r in ranks:
        mfin = ranks_amax([x.part[0, rows] for x in ranks], r.part.device)
        r.part[1, rows] = tree_sum(torch.exp(r.alpha[rows, T - 1]
                                             - mfin[:, None]))
    for r in ranks:
        dev = r.lpd.device
        mfin = ranks_amax([x.part[0, rows] for x in ranks], dev)
        r.lpd[rows] = mfin + torch.log(combine_rank_sums(
            [x.part[1, rows].to(dev) for x in ranks]))
    for r in ranks:
        r.beta[rows, T - 1] = 0.0
    for t in range(T - 2, -1, -1):
        g = [r.em[rows, t + 1] + r.beta[rows, t + 1] for r in ranks]
        for r, (ops, _, ev) in zip(ranks, parts):
            col = gather_column(g, ev["mean"].device)
            cand = logsumexp_slots(ops.to_logp + gather_slots(col,
                                                              ops.to_idx))
            r.beta[rows, t] = torch.where(
                (t >= ev["length"] - 1)[:, None], 0.0, cand)


#: fwbw_wave_resident's answers, by (card index, sys, resident, deg, W,
#: cluster, reads a block)
_fwbw_wave_resident: dict = {}


def fwbw_wave_resident(dev, sys: bool, resident: bool, deg: int, W: int,
                       cluster: bool = False) -> int:
    """The most blocks of K6cm's instance (sys: the exchange across cards;
    resident, at deg slots, the larger side's, and slices of W states,
    at fwbw_wave_reads reads a block, whose shared memory it sets) that the
    CUDA device `dev` holds at once: a cooperative wave's grid, read
    groups times the card's ranks, must not exceed it; cluster: the blocks
    of the most clusters of the cluster path it holds at once."""
    reads = _fwbw_wave_fit(W, deg, resident, cluster)
    key = (torch.device(dev).index, bool(sys), bool(resident), int(deg),
           int(W), bool(cluster), reads)
    if key not in _fwbw_wave_resident:
        blocks = ctypes.c_int(0)
        M = 4096 // W
        shape = fwbw_wave_grid(reads, M, reads, cluster)
        _cuda.check(_cuda.load().nc_fwbw_generic_wave_resident(
            int(sys), int(resident), int(deg), _slice_shift(M, W),
            reads.bit_length() - 1, *shape["grid"], shape["block"],
            int(cluster), key[0], ctypes.byref(blocks)),
            "fwbw_generic_wave occupancy")
        _fwbw_wave_resident[key] = blocks.value
    return _fwbw_wave_resident[key]


def _fwbw_wave_fit(W: int, deg: int, resident: bool, cluster: bool) -> int:
    """fwbw_wave_reads, or ValueError where no block fits the cut."""
    reads = fwbw_wave_reads(W, deg, resident, cluster)
    if not reads:
        raise ValueError(
            f"K6cm: a {'resident' if resident else 'streaming'} cut of "
            f"{deg} slots at slices of {W} states does not fit a block's "
            f"shared memory on the {'cluster' if cluster else 'cooperative'}"
            f" path")
    return reads


def _check_fwbw_wave_rank(m: int, r: FwbwWaveRank, B: int, T: int, W: int,
                          resident: bool) -> tuple:
    """A rank's part as K6cm takes it; returns its (from, to) slot
    counts."""
    dev = r.ev["mean"].device
    ops = r.ops
    if ops.K != 6:
        raise ValueError(f"the CUDA generic kernels take K=6, got K={ops.K}")
    refuse_per_read(ops, "the generic forward-backward on the state axis")
    if (fwbw_route(ops) == "resident") != resident:
        raise ValueError("the ranks' cuts differ in their layout")
    _check_events(r.ev, B, T, dev)
    _check_tables(tuple(r.model), B, W, dev)
    degs = []
    for side in ("from", "to"):
        if resident:
            packed = getattr(ops.fwbw_packed, f"{side}_packed")
            book = getattr(ops.fwbw_packed, f"{side}_codebook")
            deg = packed.shape[0]
            if not 1 <= deg <= MAX_FWBW_RESIDENT_SLOTS:
                raise ValueError(f"packed {side} table: {deg} slots, the "
                                 f"resident K6cm takes 1 to "
                                 f"{MAX_FWBW_RESIDENT_SLOTS}")
            _check(f"ranks[{m}].{side}_packed", packed, torch.int16,
                   (deg, W), dev)
            _check(f"ranks[{m}].{side}_codebook", book, torch.float32,
                   (deg, FWBW_GROUPS * RESIDENT_CODES), dev)
            tables = (packed, book)
        else:
            idx, logp = (getattr(ops, f"{side}_idx"),
                         getattr(ops, f"{side}_logp"))
            deg = idx.shape[0]
            if not 1 <= deg <= MAX_SLOTS:
                raise ValueError(f"{side} table: {deg} slots, the kernels "
                                 f"take 1 to {MAX_SLOTS}")
            _check(f"ranks[{m}].{side}_idx", idx, torch.int32, (deg, W), dev)
            _check(f"ranks[{m}].{side}_logp", logp, torch.float32, (deg, W),
                   dev)
            tables = (idx, logp)
        for x in tables:
            _check_aligned(f"ranks[{m}].{side} table", x)
        degs.append(deg)
    for name in ("alpha", "beta", "em"):
        _check(f"ranks[{m}].{name}", getattr(r, name), torch.float32,
               (B, T, W), dev)
    _check(f"ranks[{m}].lpd", r.lpd, torch.float32, (B,), dev)
    _check(f"ranks[{m}].col", r.col, torch.float32, (2, B, W), dev)
    _check_aligned(f"ranks[{m}].col", r.col)
    _check(f"ranks[{m}].part", r.part, torch.float32, (2, B), dev)
    _check(f"ranks[{m}].flags", r.flags, torch.int32, (B,), dev)
    return tuple(degs)


def _fwbw_wave_kernel(ranks, local, lo: int, hi: int, resident: bool,
                      cluster: bool | None) -> None:
    B, T, W, shift, dev, sys = _wave_setup(ranks, local, lo, hi, "K6cm")
    cluster = cluster_path(len(ranks), sys, len(local), cluster)
    degs = {_check_fwbw_wave_rank(m, r, B, T, W, resident)
            for m, r in enumerate(ranks)}
    if len(degs) != 1:
        raise ValueError(f"the ranks' cuts differ in their slots: {degs}")
    deg_from, deg_to = degs.pop()
    reads = _fwbw_wave_fit(W, max(deg_from, deg_to), resident, cluster)
    shape = fwbw_wave_grid(hi - lo, len(ranks), reads, cluster, len(local))
    vals = []
    for r in ranks:
        p = r.ops.fwbw_packed
        tables = ((p.from_packed, p.from_codebook, p.to_packed,
                   p.to_codebook) if resident
                  else (r.ops.from_idx, r.ops.from_logp, r.ops.to_idx,
                        r.ops.to_logp))
        vals += [r.ev["mean"].data_ptr(), r.ev["stdv"].data_ptr(),
                 r.ev["log_stdv"].data_ptr(), r.ev["length"].data_ptr(),
                 *(x.data_ptr() for x in tables),
                 *(x.data_ptr() for x in r.model),
                 *(x.data_ptr() for x in (r.alpha, r.beta, r.em, r.col,
                                          r.part, r.lpd, r.flags))]
    table = _rank_table(vals, local, dev)
    err = _cuda.load().nc_fwbw_generic_wave(
        table.data_ptr(), len(local), B, T, lo, hi - lo, shift,
        reads.bit_length() - 1, *shape["grid"], shape["block"], deg_from,
        deg_to, int(sys), int(resident), int(cluster), LOG_2PI,
        math.log(len(ranks) * W), int(WAVE_TIMEOUT_S * 1e9),
        _timed_out.data_ptr(), *_cuda.target(dev))
    _cuda.check(err, "fwbw_generic_wave kernel launch")


def fwbw_wave_resident_kernel(ranks, local, lo: int, hi: int,
                              cluster: bool | None = None) -> None:
    """K6cm on the card, the resident form (each side's packed cut and its
    codebooks in shared memory in turn): fwbw_generic_wave_plain's work
    for the ranks `local` (indices into `ranks`, all on one card; 2 to 64
    ranks in all) over the reads [lo, hi), one launch on that card's
    current stream, R = fwbw_wave_reads reads a block of R W / 4 threads
    (fwbw_wave_grid); a cut that fits no block raises ValueError.  cluster
    (cluster_path: by default where wave_cluster(M, sys) says and `local`
    holds every rank): each read group's M blocks one thread block
    cluster, pushing into each other's shared memory, any number of reads.
    Else one cooperative launch, whose grid (read groups x len(local)
    ranks) must fit the card at once (fwbw_wave_resident), or the launch
    raises; the other ranks run their blocks of the same reads in a launch
    of their own card; their slices, partials and counters are read over
    peer access, and a block waits WAVE_TIMEOUT_S on a peer at most.
    Raises if a wave of this process timed out (wave_timeout)."""
    _fwbw_wave_kernel(ranks, local, lo, hi, True, cluster)
    _cuda.count_launch(fwbw_wave_resident_kernel)


def fwbw_wave_streaming_kernel(ranks, local, lo: int, hi: int,
                               cluster: bool | None = None) -> None:
    """K6cm on the card, the streaming form (each rank's int32 / float32
    cut of both sides read from L2 at every step): as
    fwbw_wave_resident_kernel."""
    _fwbw_wave_kernel(ranks, local, lo, hi, False, cluster)
    _cuda.count_launch(fwbw_wave_streaming_kernel)


fwbw_wave_resident_kernel.launches = 0
fwbw_wave_streaming_kernel.launches = 0


def fwbw_generic_wave_kernel(ranks, local, lo: int, hi: int,
                             cluster: bool | None = None) -> None:
    """K6cm on the card in the form the ranks' cuts take (fwbw_route: the
    resident one where the cut has K6c's packed layout), on the exchange
    path `cluster` chooses (cluster_path)."""
    if fwbw_route(ranks[0].ops) == "resident":
        fwbw_wave_resident_kernel(ranks, local, lo, hi, cluster)
    else:
        fwbw_wave_streaming_kernel(ranks, local, lo, hi, cluster)


# K6c and K6e streaming on one card: a read's states cut over a cluster ------
# (csrc/fwbw_split.cu).  Block c of a read's cluster of C steps the states
# [c W, (c + 1) W), W = n / C, S states a thread, reading its cut of the
# table and of the model in place at column offset c W and writing its
# columns of the (B, T, n) outputs through their row stride; the gathered
# column is exchanged every step as K6cm's cluster path exchanges it.  The
# plain versions below compute the same arithmetic over C cuts (and S
# subtrees of a cut's sums); fwbw_stream_split picks S.

#: the blocks a read (C) of the kernel, and the states a thread (S) it
#: takes.  Chosen by the times of C = 2, 4, 8, S = 1, 2, 4 and 1, 2, 4 reads
#: a block against the kernel of one block of 1024 threads a read, in
#: turns (tools/torch_decode_times.py --stream, NVIDIA H100 80GB HBM3,
#: 700 W): C = 8 with S = 1 the fastest up to 48 reads (3.9-7.8x the kernel
#: of one block a read), S = 2 from 96 reads (at 512 x 128 the best form or
#: within 3% of it); more reads a block lost everywhere (1.15-1.51x)
FWBW_SPLIT_CUTS = 8
FWBW_SPLIT_STATES = (1, 2)
#: the most reads fwbw_stream_split gives one state a thread
FWBW_SPLIT_FEW_READS = 48


def fwbw_stream_split(B: int) -> int:
    """The states a thread (S of FWBW_SPLIT_STATES) of the one-card split
    for a streaming K6c or K6e launch over B reads: one up to
    FWBW_SPLIT_FEW_READS reads (eight SMs a read, each thread one state),
    else two."""
    return 1 if B <= FWBW_SPLIT_FEW_READS else 2


def _split_cuts(ops: TransOps, model: ModelArrays, C: int) -> list:
    """The C cuts of a table and of the scaled model: ((deg, W) slot tables,
    per-read (B, deg, W) log-probs as they are, no packed layout), (B, W)
    model rows."""
    W = 4096 // C
    out = []
    for c in range(C):
        cols = slice(c * W, (c + 1) * W)
        out.append((TransOps(from_idx=ops.from_idx[:, cols],
                             from_logp=ops.from_logp[..., cols],
                             to_idx=ops.to_idx[:, cols],
                             to_logp=ops.to_logp[..., cols], K=ops.K),
                    ModelArrays(*(x[:, cols] for x in model))))
    return out


def split_sum(x: torch.Tensor, C: int, S: int) -> torch.Tensor:
    """tree_sum over the last dim of (B, n) as the one-card split adds it:
    each of the C cuts' S subtrees of n / (C S) states by tree_sum, a cut's
    S sums pairwise ((s0 + s1) + (s2 + s3) at S = 4), then the C cuts'
    sums by combine_rank_sums: tree_sum's bits, since each is a subtree."""
    n = x.shape[-1]
    Q = n // (C * S)
    parts = []
    for c in range(C):
        sub = [tree_sum(x[..., (c * S + i) * Q:(c * S + i + 1) * Q])
               for i in range(S)]
        while len(sub) > 1:
            sub = [sub[i] + sub[i + 1] for i in range(0, len(sub), 2)]
        parts.append(sub[0])
    return combine_rank_sums(parts)


def fwbw_split_plain(ops: TransOps, model: ModelArrays, ev: dict, C: int,
                     S: int = 4) -> dict:
    """Plain version of the one-card split of K6c (fwbw_generic_kernel)
    over C cuts, S states a thread: fwbw_generic_wave_plain over the C
    cuts of the table and the model (one table or per-read log-probs), the
    ranks' slices joined, and log Pr[data] as block 0 folds it: the C cuts'
    partial maxima of the final alpha (ranks_amax), each cut's S subtree
    sums of exp(alpha - max) folded pairwise, the C sums by
    combine_rank_sums.  {alpha, beta, em (B, T, n), log_pr_data (B,)} as
    fwbw_plain, bit for bit."""
    B, T = ev["mean"].shape
    dev = ev["mean"].device
    W = 4096 // C
    ranks = []
    for cut, m in _split_cuts(ops, model, C):
        ranks.append(FwbwWaveRank(
            ops=cut, model=m, ev=ev,
            **{k: torch.empty((B, T, W), dtype=torch.float32, device=dev)
               for k in ("alpha", "beta", "em")},
            lpd=torch.empty(B, dtype=torch.float32, device=dev),
            col=torch.empty((2, B, W), dtype=torch.float32, device=dev),
            part=torch.empty((2, B), dtype=torch.float32, device=dev),
            flags=torch.zeros(B, dtype=torch.int32, device=dev)))
    fwbw_generic_wave_plain(ranks, 0, B)
    out = {k: torch.cat([getattr(r, k) for r in ranks], dim=-1)
           for k in ("alpha", "beta", "em")}
    final = out["alpha"][:, T - 1]
    mfin = ranks_amax([torch.amax(final[:, c * W:(c + 1) * W], dim=-1)
                       for c in range(C)], dev)
    out["log_pr_data"] = mfin + torch.log(
        split_sum(torch.exp(final - mfin[:, None]), C, S))
    return out


def split_normalizer(x: torch.Tensor, C: int, S: int) -> torch.Tensor:
    """K6e's log-normaliser of x (B, n) as the one-card split folds it: m
    the max of the C cuts' partial maxima, then m + log of split_sum of
    exp(x - m); x - split_normalizer(x) is log_normalize(x), bit for bit."""
    W = x.shape[-1] // C
    m = ranks_amax([torch.amax(x[:, c * W:(c + 1) * W], dim=-1)
                    for c in range(C)], x.device)
    return m + torch.log(split_sum(torch.exp(x - m[:, None]), C, S))


def fwbw_custom_split_plain(ops: TransOps, model: ModelArrays, ev: dict,
                            C: int, S: int = 4) -> dict:
    """Plain version of the one-card split of K6e (fwbw_custom_kernel) over
    C cuts, S states a thread: fwbw_custom_plain's recursions with each step's
    normalisation folded over the C cuts (split_normalizer), and the
    gathered beta formed as the kernel forms it, from the exchanged column
    x = em + alpha and its normaliser c: beta[j] = x[j] - c (a read's
    frozen beta with c = 0 past its end).  {alpha, beta, gamma} (B, T, n)
    as fwbw_custom_plain, bit for bit."""
    n = model.level_mean.shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    dev = mean.device
    out = {k: torch.empty((B, T, n), dtype=torch.float32, device=dev)
           for k in ("alpha", "beta", "gamma")}
    alphas, betas, gammas = out["alpha"], out["beta"], out["gamma"]
    alpha = torch.full((B, n), -math.log(n), dtype=torch.float32, device=dev)
    col = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0]) + alpha
    c = split_normalizer(col, C, S)
    beta = col - c[:, None]
    alphas[:, 0], betas[:, 0] = alpha, beta
    t_alpha = torch.clamp(lengths, min=1)
    for t in range(1, T):
        gathered = gather_slots(col, ops.from_idx) - c[:, None, None]
        alpha = torch.where((t <= t_alpha)[:, None],
                            logsumexp_slots(ops.from_logp + gathered), alpha)
        live = (t < lengths)[:, None]
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        col = torch.where(live, em + alpha, beta)
        cn = split_normalizer(col, C, S)
        beta = torch.where(live, col - cn[:, None], beta)
        c = torch.where(live[:, 0], cn, 0.0)
        alphas[:, t], betas[:, t] = alpha, beta
    gamma = beta
    gammas[:, T - 1] = gamma
    for t in range(T - 2, -1, -1):
        g = gamma - alphas[:, t + 1]
        cand = betas[:, t] + logsumexp_slots(ops.to_logp
                                             + gather_slots(g, ops.to_idx))
        gamma = torch.where((t >= lengths - 1)[:, None], betas[:, t], cand)
        gammas[:, t] = gamma
    return out


#: fwbw_split_clusters' answers, by (card index, S, custom, per_read)
_split_clusters: dict = {}


def fwbw_split_clusters(dev, S: int, custom: bool, per_read: bool) -> int:
    """The most clusters of the one-card split's instance of S states a
    thread that the CUDA device `dev` holds at once
    (cudaOccupancyMaxActiveClusters; its shared memory set there).  The
    launch raises where it is 0."""
    key = (torch.device(dev).index, S, bool(custom), bool(per_read))
    if key not in _split_clusters:
        clusters = ctypes.c_int(0)
        _cuda.check(_cuda.load().nc_fwbw_split_clusters(
            S.bit_length() - 1, int(custom), int(per_read), key[0],
            ctypes.byref(clusters)), "fwbw_split occupancy")
        _split_clusters[key] = clusters.value
    return _split_clusters[key]


def _fwbw_split_launch(ops: TransOps, model: ModelArrays, ev: dict,
                       states: int | None, custom: bool) -> dict:
    """One launch of the streaming K6c (custom: K6e), the one-card split,
    with `states` a thread (FWBW_SPLIT_STATES; None: fwbw_stream_split's),
    once every shape is checked: K6c's {alpha, beta, em, log_pr_data} or
    K6e's {alpha, beta, gamma}, as the plain version; K6e's emissions go
    to a scratch tensor.  The wrappers below call it and count the
    launch."""
    what = "custom fwbw" if custom else "generic fwbw"
    if states is not None and states not in FWBW_SPLIT_STATES:
        raise ValueError(f"{what}: {states} states a thread, the one-card "
                         f"split takes {FWBW_SPLIT_STATES}")
    B, T, table = _check_fwbw(ops, model, ev, False, what)
    S = fwbw_stream_split(B) if states is None else states
    dev = ev["mean"].device
    n = 4096
    C = FWBW_SPLIT_CUTS
    W = n // C
    per = per_read(ops)
    if not fwbw_split_clusters(dev, S, custom, per):
        raise RuntimeError(f"{what}: no cluster of {C} blocks of {W // S} "
                           f"threads fits the card")
    if custom:
        out = _custom_outputs(B, T, n, dev)
        em = torch.empty((B, T, n), dtype=torch.float32, device=dev)
        outs = (out["alpha"], out["beta"], em, out["gamma"])
        lpd = 0
    else:
        out = _fwbw_outputs(B, T, n, dev)
        outs = (out["alpha"], out["beta"], out["em"], None)
        lpd = out["log_pr_data"].data_ptr()
    vals = []
    for c in range(C):
        off = 4 * c * W
        vals += [ev["mean"].data_ptr(), ev["stdv"].data_ptr(),
                 ev["log_stdv"].data_ptr(), ev["length"].data_ptr(),
                 *(x.data_ptr() + off for x in table),
                 *(x.data_ptr() + off for x in model),
                 *(x.data_ptr() + off for x in outs[:3]),
                 outs[3].data_ptr() + off if custom else 0, 0, lpd, 0]
    ranks = _rank_table(vals, [], dev)
    err = _cuda.load().nc_fwbw_split(
        ranks.data_ptr(), B, T, S.bit_length() - 1, table[0].shape[-2],
        table[2].shape[-2], int(custom), int(per), LOG_2PI, math.log(n),
        *_cuda.target(dev))
    _cuda.check(err, f"{what} split kernel launch")
    return out


# K6e: per-step-normalized forward-backward -----------------------------------


def log_normalize(x: torch.Tensor) -> torch.Tensor:
    """x minus its log-sum-exp over the states (the last dim), as `norm` of
    nanocall_tpu/ops/hmm.py:1064-1066, with no -inf guard: m is the
    NaN-propagating max, the sum of exp(x - m) the pairwise tree_sum."""
    m = torch.amax(x, dim=-1, keepdim=True)
    return x - (m + torch.log(tree_sum(torch.exp(x - m)))[..., None])


def fwbw_custom_plain(ops: TransOps, model: ModelArrays, ev: dict) -> dict:
    """Plain version of K6e (nanocall_tpu/ops/hmm.py:1047-1106,
    Forward_Backward_Custom.hpp): the forward-backward normalized at every
    step, loops over events.  With lse the slot log-sum-exp of
    logsumexp_slots and norm = log_normalize,
      alpha_0 = -log n,  beta_0 = norm(em_0 + alpha_0),
      alpha_t = lse(from_logp + beta_{t-1}[from_idx]),
      beta_t  = norm(em_t + alpha_t)   (t >= 1; frozen from t = length on),
      gamma_{T-1} = beta_{T-1},
      gamma_t = beta_t + lse(to_logp + (gamma_{t+1} - alpha_{t+1})[to_idx])
                (t <= T-2; beta_t from t = length-1 on).
    alpha_t is stored as computed, also past a read's length.  Per-read
    (B, deg, n) log-probs broadcast as JAX's do.  Returns {alpha, beta,
    gamma}: (B, T, n) float32 log probabilities."""
    n = model.level_mean.shape[-1]
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    dev = mean.device
    out = {k: torch.empty((B, T, n), dtype=torch.float32, device=dev)
           for k in ("alpha", "beta", "gamma")}
    alphas, betas, gammas = out["alpha"], out["beta"], out["gamma"]
    alpha = torch.full((B, n), -math.log(n), dtype=torch.float32, device=dev)
    em = log_emission(model, mean[:, 0], stdv[:, 0], log_stdv[:, 0])
    beta = log_normalize(em + alpha)
    alphas[:, 0], betas[:, 0] = alpha, beta
    for t in range(1, T):
        alpha = logsumexp_slots(ops.from_logp
                                + gather_slots(beta, ops.from_idx))
        em = log_emission(model, mean[:, t], stdv[:, t], log_stdv[:, t])
        beta = torch.where((t < lengths)[:, None],
                           log_normalize(em + alpha), beta)
        alphas[:, t], betas[:, t] = alpha, beta
    gamma = beta
    gammas[:, T - 1] = gamma
    for t in range(T - 2, -1, -1):
        g = gamma - alphas[:, t + 1]
        cand = betas[:, t] + logsumexp_slots(ops.to_logp
                                             + gather_slots(g, ops.to_idx))
        gamma = torch.where((t >= lengths - 1)[:, None], betas[:, t], cand)
        gammas[:, t] = gamma
    return out


def _custom_outputs(B: int, T: int, n: int, dev) -> dict:
    """K6e's outputs: {alpha, beta, gamma}, (B, T, n) float32 each on
    `dev` (the card tests substitute views between guard rows)."""
    return {k: torch.empty((B, T, n), dtype=torch.float32, device=dev)
            for k in ("alpha", "beta", "gamma")}


def fwbw_custom_kernel(ops: TransOps, model: ModelArrays, ev: dict,
                       states: int | None = None) -> dict:
    """K6e on the card under a table that streams, the one-card split
    (csrc/fwbw_split.cu) with `states` a thread (by default
    fwbw_stream_split's): both passes in one launch, {alpha, beta, gamma}
    (B, T, n) as the plain version.  Per-read tables take the per-read
    instance (fwbw_custom_per_read_kernel)."""
    if per_read(ops):
        return fwbw_custom_per_read_kernel(ops, model, ev, states)
    out = _fwbw_split_launch(ops, model, ev, states, custom=True)
    _cuda.count_launch(fwbw_custom_kernel)
    return out


def fwbw_custom_per_read_kernel(ops: TransOps, model: ModelArrays,
                                ev: dict, states: int | None = None) -> dict:
    """fwbw_custom_kernel under per-read tables (its per-read
    instance)."""
    _require_per_read(ops, "the per-read streaming custom fwbw")
    out = _fwbw_split_launch(ops, model, ev, states, custom=True)
    _cuda.count_launch(fwbw_custom_per_read_kernel)
    return out


def fwbw_custom_resident_kernel(ops: TransOps, model: ModelArrays,
                                ev: dict) -> dict:
    """K6e on the card, the resident kernel (each side's packed table in
    shared memory in turn, K6c's layout): {alpha, beta, gamma} (B, T, n) as
    the plain version.  Per-read tables take the per-read instance
    (fwbw_custom_resident_per_read_kernel)."""
    if per_read(ops):
        return fwbw_custom_resident_per_read_kernel(ops, model, ev)
    out = _fwbw_resident_launch(ops, model, ev, custom=True)
    _cuda.count_launch(fwbw_custom_resident_kernel)
    return out


def fwbw_custom_resident_per_read_kernel(ops: TransOps, model: ModelArrays,
                                         ev: dict) -> dict:
    """K6e's resident kernel under per-read tables (its per-read
    instance)."""
    _require_per_read(ops, "the per-read resident custom fwbw")
    out = _fwbw_resident_launch(ops, model, ev, custom=True)
    _cuda.count_launch(fwbw_custom_resident_per_read_kernel)
    return out


fwbw_custom_kernel.launches = 0
fwbw_custom_per_read_kernel.launches = 0
fwbw_custom_resident_kernel.launches = 0
fwbw_custom_resident_per_read_kernel.launches = 0


def fwbw_custom(ops: TransOps, model: ModelArrays, ev: dict) -> dict:
    """K6e on the tensors' device: {alpha, beta, gamma (B, T, n)}, under one
    table or per-read tables.  On the card the table picks the kernel
    (fwbw_route, as K6c), and per-read tables its per-read instance; all
    give the plain version's bits."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return fwbw_custom_plain(ops, model, ev)
    if dev.type != "cuda":
        raise ValueError(f"no custom fwbw for device {dev}")
    if fwbw_route(ops) == "resident":
        return fwbw_custom_resident_kernel(ops, model, ev)
    return fwbw_custom_kernel(ops, model, ev)


# K6d: grouped log-sum-exp backward -------------------------------------------

#: bits of the grouped backward kernel's per-state flag byte
GROUPED_BWD_FLAG_BITS = {"H": 0, "P2mH": 1, "S5T": 2}

#: the most slots a transition table may give one state: the Viterbi
#: backpointers are uint8 slot ids
MAX_SLOTS = 256


def bwd_exp_tables(gtf: GroupedTransFull):
    """exp of the stay and to-side tables: the backward pass's transition
    weights (K6d here, K5 in ops/em.py)."""
    return (torch.exp(gtf.stay_lp), torch.exp(gtf.step_to_lp),
            torch.exp(gtf.skip_to_lp))


#: width of K5's per-row transition codebooks (bwd_codebooks)
BWD_CODES = 32


@functools.lru_cache(maxsize=None)
def bwd_patterns(K: int):
    """(pattern (n,) uint8, rep (P,) int64): each state's pattern of the
    overlap conditions that bwd_exp_tables' three tables depend on (the
    stay conditions of transitions.grouped_condition_masks and all of
    grouped_condition_masks_to), numbered 0 .. P-1 (P = 27 at K = 6), and
    one state of each pattern."""
    m = transitions.grouped_condition_masks(K)
    cols = [m[f"stay_l{l}"] for l in range(1, K)]
    cols += list(transitions.grouped_condition_masks_to(K).values())
    _, rep, pattern = np.unique(np.stack(cols, 1), axis=0,
                                return_index=True, return_inverse=True)
    if len(rep) > BWD_CODES:
        raise ValueError(f"{len(rep)} transition patterns at K={K}, more "
                         f"than the codebooks' {BWD_CODES}")
    return pattern.reshape(-1).astype(np.uint8), rep


def bwd_codebooks(gtf: GroupedTransFull):
    """bwd_exp_tables' tables as K5 reads them: (pattern (n,) uint8,
    codebooks (..., 3, BWD_CODES) float32).  A table's value at a state is
    fixed by the state's pattern and the row's (p_stay, p_skip), so
    codebooks[..., q, :P] holds table q at one state of each pattern
    and codebooks[..., q, pattern] rebuilds table q bit for bit; the
    entries past P are 0."""
    pattern, rep = bwd_patterns(gtf.K)
    tables = bwd_exp_tables(gtf)
    dev = tables[0].device
    idx = torch.from_numpy(rep).to(dev)
    books = torch.zeros((*tables[0].shape[:-1], 3, BWD_CODES),
                        dtype=torch.float32, device=dev)
    for q, x in enumerate(tables):
        books[..., q, :len(rep)] = x[..., idx]
    return torch.from_numpy(pattern).to(dev), books


def fwbw_grouped_backward_plain(gtf: GroupedTransFull, model: ModelArrays,
                                ev: dict) -> torch.Tensor:
    """Plain version of K6d (the reverse scan of nanocall_tpu/ops/hmm.py:
    1014-1035), a loop over events from T-2 down to 0: g = em(t+1) + beta,
    m = max g, G = exp(g - m), the contiguous 4- and 16-block sums of G
    tiled over the states, the H / P2mH / S5T corrections, beta = m +
    log(total), 0 from t = length-1 on.  Returns beta (B, T, n) float32."""
    mean, stdv, log_stdv = ev["mean"], ev["stdv"], ev["log_stdv"]
    lengths = ev["length"]
    B, T = mean.shape
    n = model.level_mean.shape[-1]
    dev = mean.device
    m_ = correction_masks(gtf.K, dev)
    mH, mP2, mS5T = m_["H"], m_["P2mH"], m_["S5T"]
    e_stay, e_step_to, e_skip_to = bwd_exp_tables(gtf)
    betas = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    beta = torch.zeros((B, n), dtype=torch.float32, device=dev)
    betas[:, T - 1] = beta
    for t in range(T - 2, -1, -1):
        g = log_emission(model, mean[:, t + 1], stdv[:, t + 1],
                         log_stdv[:, t + 1]) + beta
        m = torch.amax(g, dim=-1, keepdim=True)
        G = torch.exp(g - m)
        T4 = block_sum(G, 4).repeat(1, 4)
        T16 = block_sum(G, 16).repeat(1, 16)
        total = (e_stay * G + e_step_to * (T4 - mH * G)
                 + e_skip_to * (T16 - mP2 * G - mS5T * T4))
        beta = torch.where((t >= lengths - 1)[:, None], 0.0,
                           m + torch.log(total))
        betas[:, t] = beta
    return betas


def fwbw_backward_kernel(gtf: GroupedTransFull, model: ModelArrays,
                         ev: dict) -> torch.Tensor:
    """K6d on the card: beta (B, T, n) float32, as the plain version.  The
    kernel runs K5's beta step (csrc/beta_step.cuh) and reads the
    transition tables as bwd_codebooks."""
    mean = ev["mean"]
    dev = mean.device
    B, T = mean.shape
    n = 4096
    if gtf.K != 6:
        raise ValueError(f"the CUDA grouped backward kernel takes K=6, got "
                         f"K={gtf.K}")
    if T < 1:
        raise ValueError("the backward pass needs at least one event column")
    _check_events(ev, B, T, dev)
    pattern, books = bwd_codebooks(gtf)
    _check("codebooks", books, torch.float32, (B, 3, BWD_CODES), dev)
    _check_tables(tuple(model), B, n, dev)
    _require_cuda(dev, "grouped fwbw backward")
    flags = mask_flags(correction_masks(6, dev), GROUPED_BWD_FLAG_BITS)
    betas = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_fwbw_backward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, books.data_ptr(), pattern.data_ptr(),
        *(x.data_ptr() for x in model), flags.data_ptr(), LOG_2PI,
        betas.data_ptr(), *_cuda.target(dev),
    )
    _cuda.check(err, "fwbw_backward kernel launch")
    _cuda.count_launch(fwbw_backward_kernel)
    return betas


fwbw_backward_kernel.launches = 0


def fwbw_grouped_backward(gtf: GroupedTransFull, model: ModelArrays,
                          ev: dict) -> torch.Tensor:
    """K6d on the tensors' device: beta (B, T, n)."""
    dev = ev["mean"].device
    if dev.type == "cpu":
        return fwbw_grouped_backward_plain(gtf, model, ev)
    if dev.type != "cuda":
        raise ValueError(f"no grouped fwbw backward for device {dev}")
    return fwbw_backward_kernel(gtf, model, ev)


def fwbw_grouped(gtf: GroupedTransFull, model: ModelArrays, ev: dict) -> dict:
    """Exact forward-backward by the grouped decomposition
    (nanocall_tpu/ops/hmm.py:956-1044, with keep_emissions): K4's alphas,
    K6d's betas, and the emissions of every event, an elementwise pass of
    log_emission in the kernels' op order.  Returns {alpha, beta, em:
    (B, T, n) float32, log_pr_data: (B,)}; alpha is a (B, T, n) view of
    K4's (T, B, n) store."""
    alphas, lpd = fwbw_grouped_forward(gtf, model, ev)
    beta = fwbw_grouped_backward(gtf, model, ev)
    rows = ModelArrays(*(x[:, None, :] for x in model))
    em = log_emission(rows, ev["mean"], ev["stdv"], ev["log_stdv"])
    return {"alpha": alphas.transpose(0, 1), "beta": beta, "em": em,
            "log_pr_data": lpd}
