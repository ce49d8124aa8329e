"""Grouped Viterbi decode on PyTorch tensors, with hand-written CUDA kernels.

Port of the decode half of nanocall_tpu/ops/hmm.py.  Every function takes
tensors on one device and dispatches by that device:

  - CPU tensors run the plain PyTorch version (a Python loop over events on
    (B, n) tensors, in the JAX scan body's op order);
  - CUDA tensors run the hand-written kernel (csrc/, built by ops/_cuda.py),
    or the call raises.  There is no fallback from a kernel to its plain
    version.

Kernels and their plain versions, side by side below:

  K1  viterbi_forward.cu    forward_path_kernel / forward_score_kernel
                            vs viterbi_forward_grouped_plain
  K2  viterbi_traceback.cu  traceback_kernel vs viterbi_traceback_grouped_plain

Each kernel wrapper counts its launches in a plain int attribute
(`wrapper.launches`), incremented only where it launches the kernel.

Numerics: the kernels are built with -fmad=false, so on the same card they
are bit-identical to the plain versions.  Against the JAX package the port
agrees to float32 rounding: XLA fuses and reorders the jitted emission
expression, and jnp.log and torch.log differ in the last bit on some inputs.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from nanocall_tpu import kmer, transitions
from nanocall_tpu.pore_model import LOG_2PI

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


def grouped_tables(p_stay: torch.Tensor, p_skip: torch.Tensor, K: int):
    """(stay_lp, step_lp, skip_lp), each (..., n) float32: the float32
    pipeline of transitions.grouped_tables(..., xp=jnp)
    (nanocall_tpu/transitions.py:342-389) over the same condition masks."""
    masks = transitions.grouped_condition_masks(K)
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

    stay = p_stay + mask("stay_l1") * (p_step / 4.0) + bg
    for l in range(2, K):
        stay = stay + mask(f"stay_l{l}") * term(l)
    step = p_step / 4.0 + bg
    for l in range(2, K):
        step = step + mask(f"step_l{l}") * term(l)
    skip = term(2) + bg
    for l in range(3, K):
        skip = skip + mask(f"skip_l{l}") * term(l)
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    return torch.log(stay), torch.log(step + zeros), torch.log(skip + zeros)


def make_grouped_trans_device(p_stay, p_skip, K: int = 6) -> GroupedTrans:
    """Per-task grouped tables from (B,) params, built on their device
    (nanocall_tpu/ops/hmm.py:199-206)."""
    stay, step, skip = grouped_tables(p_stay, p_skip, K)
    return GroupedTrans(stay_lp=stay, step_lp=step, skip_lp=skip, K=K)


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


def _grouped_step_core(gt: GroupedTrans, alpha: torch.Tensor):
    """One grouped max-plus step (nanocall_tpu/ops/hmm.py:286-347):
    alpha (B, n) -> (best (B, n) pre-emission scores, bp (B, n) uint8),
    bp = (group << 6) | within-group first argmax, ties to the lowest
    from-state."""
    B, n = alpha.shape
    K = gt.K
    j = torch.arange(n, dtype=torch.int32, device=alpha.device)

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

    v0 = gt.stay_lp + alpha
    v1 = gt.step_lp + m4.repeat_interleave(4, dim=1)
    v2 = gt.skip_lp + m16.repeat_interleave(16, dim=1)
    best = torch.maximum(torch.maximum(v0, v1), v2)

    arg4 = g4.repeat_interleave(4, dim=1)
    arg16 = g16.repeat_interleave(16, dim=1)
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
    for name in ("mean", "stdv", "log_stdv"):
        _check(f"ev[{name!r}]", ev[name], torch.float32, (B, T), dev)
    _check("ev['length']", ev["length"], torch.int32, (B,), dev)
    tables = (gt.stay_lp, gt.step_lp, gt.skip_lp, *model)
    for i, x in enumerate(tables):
        _check(f"table {i}", x, torch.float32, (B, n), dev)
        if x.data_ptr() % 16:  # the kernel reads the tables as float4
            raise ValueError(f"table {i} is not 16-byte aligned")
    final = torch.empty((B, n), dtype=torch.float32, device=dev)
    bps = (torch.empty((T - 1, B, n), dtype=torch.uint8, device=dev)
           if with_path else None)
    lib = _cuda.load()
    err = lib.nc_viterbi_forward(
        mean.data_ptr(), ev["stdv"].data_ptr(), ev["log_stdv"].data_ptr(),
        ev["length"].data_ptr(), B, T, *(x.data_ptr() for x in tables),
        LOG_2PI, math.log(n), final.data_ptr(),
        bps.data_ptr() if with_path and bps.numel() else None,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "viterbi_forward kernel launch")
    return final, bps


def forward_path_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict):
    """K1 on the card, with backpointers: (final_alpha, bps)."""
    out = _forward_kernel(gt, model, ev, with_path=True)
    forward_path_kernel.launches += 1
    return out


def forward_score_kernel(gt: GroupedTrans, model: ModelArrays, ev: dict):
    """K1 on the card, score-only (no backpointer stores): final_alpha."""
    final, _ = _forward_kernel(gt, model, ev, with_path=False)
    forward_score_kernel.launches += 1
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
    Tm, B, _ = bps.shape
    dev = final_alpha.device
    end_state = torch.argmax(final_alpha, dim=-1).to(torch.int32)
    logp = torch.amax(final_alpha, dim=-1)
    lengths = lengths.to(torch.int32)
    rows = torch.arange(B, device=dev)
    codes = torch.zeros((Tm, B), dtype=torch.uint8, device=dev)
    s = end_state
    for t in range(Tm, 0, -1):
        s_eff = torch.where(t == lengths - 1, end_state, s)
        k = bps[t - 1, rows, s_eff.long()].to(torch.int32)
        real = t <= lengths - 1
        s = torch.where(real, grouped_from_state(k, s_eff, K), s_eff)
        codes[t - 1] = torch.where(real, ((k >> 6) << 4) | (s_eff & 15), 0)
    return s, pack_codes(codes), logp


def _traceback_kernel(K: int, final_alpha, bps, lengths):
    dev = final_alpha.device
    B, n = final_alpha.shape
    if K != 6 or n != 4096:
        raise ValueError(f"the CUDA traceback kernel takes K=6, n=4096; "
                         f"got K={K}, n={n}")
    Tm = bps.shape[0]
    _check("final_alpha", final_alpha, torch.float32, (B, n), dev)
    _check("bps", bps, torch.uint8, (Tm, B, n), dev)
    _check("lengths", lengths, torch.int32, (B,), dev)
    code_bytes = 3 * (-(-Tm // 4))
    path0 = torch.empty(B, dtype=torch.int32, device=dev)
    codes = torch.empty((B, code_bytes), dtype=torch.uint8, device=dev)
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.nc_viterbi_traceback(
        final_alpha.data_ptr(), bps.data_ptr() if bps.numel() else None,
        lengths.data_ptr(), B, Tm + 1, code_bytes, path0.data_ptr(),
        codes.data_ptr() if codes.numel() else None, logp.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "viterbi_traceback kernel launch")
    return path0, codes, logp


def traceback_kernel(K: int, final_alpha, bps, lengths):
    """K2 on the card: (path0, codes, logp)."""
    out = _traceback_kernel(K, final_alpha, bps, lengths)
    traceback_kernel.launches += 1
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
    nanocall_tpu.native.path_from_packed_codes."""
    final_alpha, bps = viterbi_forward_grouped(gt, model, ev, with_path)
    if not with_path:
        return {"logp": torch.amax(final_alpha, dim=-1)}
    path0, codes, logp = viterbi_traceback_grouped(gt.K, final_alpha, bps,
                                                   ev["length"])
    return {"path0": path0, "codes": codes, "logp": logp}


# ---------------------------------------------------------------------------
# kernel registry
# ---------------------------------------------------------------------------


class Kernel(NamedTuple):
    name: str
    wrapper: Callable  # carries the `launches` counter
    source: str  # path in the repository
    replaces: str  # file:line of the JAX kernel it replaces


KERNELS = (
    Kernel("viterbi_forward_path", forward_path_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/ops/hmm.py:286"),
    Kernel("viterbi_forward_score", forward_score_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/ops/hmm.py:598"),
    Kernel("viterbi_traceback", traceback_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/ops/hmm.py:517"),
)


def reset_launches() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0
