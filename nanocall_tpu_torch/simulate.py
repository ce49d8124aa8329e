"""Synthetic nanopore read simulator (a copy of nanocall_tpu/simulate.py).

Generates event-detection event sequences from a pore model by sampling the
HMM generative process (stay/step/skip state walk + Normal/InverseGaussian
emissions), optionally inserting an abasic hairpin to create 2-strand reads,
and writes them as fast5 files.  chip_smoke.py and the timing tools draw
their reads from it, and the tests hold it to the original bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import fast5_io, kmer
from .pore_model import PoreModel, PoreModelParams


@dataclasses.dataclass
class SimReadTruth:
    state_paths: list  # per strand
    base_seqs: list  # per strand
    hairpin: bool


def _sample_state_walk(n: int, K: int, p_stay: float, p_skip: float, rng):
    """Sample a state path under the stay/step/skip kinetics."""
    states = np.zeros(n, dtype=np.int64)
    s = int(rng.integers(kmer.n_states(K)))
    p_step = 1.0 - p_stay - p_skip
    for i in range(n):
        states[i] = s
        u = rng.random()
        if u < p_stay:
            pass
        elif u < p_stay + p_step:
            s = int((kmer.suffix(s, K - 1, K) << 2) + rng.integers(4))
        else:
            # skip 1 (geometric tail collapsed to 1 for simulation)
            s = int((kmer.suffix(s, K - 2, K) << 4) + rng.integers(16))
    return states


def sample_state_walk_batch(B: int, T: int, K: int, p_stay: float,
                            p_skip: float, rng) -> np.ndarray:
    """Vectorized (B, T) stay/step/skip state walk — the batch form of
    _sample_state_walk (same collapsed-to-1 skip tail; the mass beyond
    skip-1 is < 2% and the consumers are fixed-shape kernels).  Used by the
    benchmark harness so the bench workload and the accuracy runs share one
    generative process."""
    n = kmer.n_states(K)
    mask = n - 1
    s = rng.integers(0, n, B)
    states = np.empty((B, T), np.int64)
    u = rng.random((B, T))
    b1 = rng.integers(0, 4, (B, T))
    b2 = rng.integers(0, 4, (B, T))
    p_step = 1.0 - p_stay - p_skip
    for t in range(T):
        states[:, t] = s
        stay = u[:, t] < p_stay
        step = u[:, t] < p_stay + p_step
        s_step = ((s << 2) & mask) | b1[:, t]
        s_skip = ((s << 4) & mask) | (b1[:, t] << 2) | b2[:, t]
        s = np.where(stay, s, np.where(step, s_step, s_skip))
    return states


def _emit(pm: PoreModel, states, params: PoreModelParams, t_start_s, rng,
          noise_scale: float = 1.0):
    """Event means/stdvs from the scaled model at the given times."""
    spm = pm.scaled(params)
    mean = rng.normal(
        spm.level_mean[states] + params.drift * t_start_s,
        spm.level_stdv[states] * noise_scale,
    )
    # stdv ~ InverseGaussian(sd_mean, sd_lambda) — the distribution the model
    # being fit declares (Pore_Model.hpp:33-40,112); numpy's wald(mean, scale)
    # is exactly InvGauss(mean, lambda=scale)
    stdv = np.maximum(rng.wald(spm.sd_mean[states], spm.sd_lambda[states]), 0.05)
    return mean, stdv


def simulate_read(
    models: dict,
    template_model: str,
    complement_model: str | None,
    n_events: int,
    rng,
    params: PoreModelParams = PoreModelParams(),
    p_stay: float = 0.1,
    p_skip: float = 0.3,
    sampling_rate: float = 4000.0,
    pad: int = 60,
    # Keep the hairpin below 1% of total events: abasic detection thresholds
    # at the 99th percentile + offset (Fast5_Summary.hpp:528-543), so a
    # longer hairpin would push the threshold above its own level.
    hairpin_len: int = 8,
    abasic_level: float = 110.0,
    noise_scale: float = 1.0,
    K: int = 6,
):
    """Simulate one read's ed-event arrays.

    Returns (mean, stdv, start, length, truth: SimReadTruth).  start/length
    are raw sample counts (the fast5 convention); event durations are
    10..40 samples.
    """
    two_strand = complement_model is not None
    if two_strand:
        total = 2 * n_events + hairpin_len + 2 * (pad + 10)
        if hairpin_len / total > 0.01:
            import warnings

            warnings.warn(
                f"hairpin is {hairpin_len}/{total} = "
                f"{hairpin_len / total:.1%} of events (> 1%): the abasic "
                f"99th-percentile threshold will sit inside the hairpin "
                f"band and strand detection will fail — use n_events >= "
                f"~{int(hairpin_len * 50)} for a detectable 2-strand read",
                stacklevel=2,
            )
    segments = []  # (kind, n) kind in {pad, t, hp, c}
    segments.append(("pad", pad + 10))
    segments.append(("t", n_events))
    if two_strand:
        segments.append(("hp", hairpin_len))
        segments.append(("c", n_events))
    segments.append(("pad", pad + 10))

    total = sum(n for _, n in segments)
    lengths = rng.integers(10, 40, total).astype(np.float64)
    starts = np.concatenate([[0.0], np.cumsum(lengths)[:-1]])
    t_s = starts / sampling_rate

    mean = np.zeros(total)
    stdv = np.full(total, 0.8)
    truth = SimReadTruth(state_paths=[], base_seqs=[], hairpin=two_strand)
    pos = 0
    for kind, n in segments:
        sl = slice(pos, pos + n)
        if kind == "pad":
            # signal-like pad (gets trimmed); draw from template model states
            sts = rng.integers(kmer.n_states(K), size=n)
            mean[sl], stdv[sl] = _emit(
                models[template_model], sts, params, t_s[sl], rng, noise_scale
            )
        elif kind == "hp":
            mean[sl] = rng.normal(abasic_level, 0.5, n)
            stdv[sl] = rng.uniform(0.3, 0.8, n)
        else:
            model = models[template_model if kind == "t" else complement_model]
            sts = _sample_state_walk(n, K, p_stay, p_skip, rng)
            mean[sl], stdv[sl] = _emit(model, sts, params, t_s[sl], rng, noise_scale)
            moves = np.zeros(n, np.int32)
            moves[1:] = kmer.min_skip(sts[:-1], sts[1:], K)
            truth.state_paths.append(sts)
            truth.base_seqs.append(kmer.moves_to_base_seq(sts, moves, K))
        pos += n
    mean = np.maximum(mean, 1.0)
    return mean, stdv, starts, lengths, truth


def write_sim_fast5(path, models, template_model, complement_model, n_events,
                    rng, read_id="", **kw):
    """Simulate and write one fast5; returns the truth record."""
    mean, stdv, start, length, truth = simulate_read(
        models, template_model, complement_model, n_events, rng, **kw
    )
    fast5_io.write_fast5(
        path, mean, stdv, start, length,
        sampling_rate=kw.get("sampling_rate", 4000.0), read_id=read_id,
    )
    return truth


def identity(a: str, b: str) -> float:
    """Cheap global-alignment-free sequence identity: LCS of k-mers via
    difflib ratio (adequate for asserting basecall quality in tests)."""
    import difflib

    return difflib.SequenceMatcher(None, a, b, autojunk=False).ratio()
