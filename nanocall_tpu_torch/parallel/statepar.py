"""State-parallel grouped Viterbi decode over a list of devices (K1m, K2m).

The port of the production decode on the 'model' axis of a (data, model)
mesh: nanocall_tpu/parallel/mesh.py:103 shard_pooled_decode_inputs places
the bank's 4096-state axis over 'model', and GSPMD splits the scaled
models, the emissions and the grouped recursion by state and inserts the
collectives.  Here one process drives every rank, as parallel/seqpar.py
does for K9: rank m of a data row runs on its device, holds the states
[m W, (m + 1) W), W = 4096 / M, and of them only: its (B, W) tables and
scaled model (it scales only its slice of the bank), a (2, B, W) column
buffer, B step counters and its (T - 1, B, W) backpointer bytes, B T W
bytes, a 1/M share of the decode's backpointers (hmm.WaveRank).  A device
may appear more than once; the ranks of a card share its current stream.

Schedule (K1m's design: csrc/viterbi_forward.cu's header):

  - the row's reads are cut into waves (plan_waves): every block of a wave,
    its reads times the ranks a card holds, must be resident at once,
    since a block waits on its peers; every card of the row gets the same
    cut;
  - each wave is one launch of K1m a card (hmm.forward_wave_kernel, a
    cooperative grid) over all T events: each step a rank reads the whole
    column of event t - 1 in place from the ranks' own double-buffered
    slices (a peer's over peer access across cards; state j's step and
    skip predecessors r 1024 + (j >> 2) and r 256 + (j >> 4) lie in every
    slice), steps its own states, stores its slice of column t and
    publishes a counter.  A card's waves go on its current stream in
    order, for every row it holds;
  - after the last event, the row's first rank takes the end argmax over
    the final column's slices and walks the ranks' backpointer slices (K2m:
    K2's row ring, each row assembled from the M slices), so path0, codes
    and logp come out on the row's first device; a score-only decode takes
    the column's max.

Each rank runs K1's step body for its own states from the same column, so
the decode is bit-identical to the one-device K1 + K2 by construction.
The host enqueues a launch a wave and card and no copy or event a step, so
what bounds a decode is the card: K1's step for W states plus the
exchange's latency, T times a wave.  A reduce-scatter of partial (max,
first argmax) pairs, 1280 / M values a read and step in place of the
column's 4096, is untried.

viterbi_decode_statepar_plain runs the same schedule over the plain
versions (hmm.viterbi_forward_wave_plain over all of a row's reads at once,
viterbi_traceback_slices_plain), on any devices; viterbi_decode_statepar
takes the kernels on CUDA (K1m for rows of 2 to 64 ranks; a row of one
rank holds every state and reads no peer, and decodes by K1 + K2) and the
plain version on the CPU, and raises if a kernel fails.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ..ops import _cuda, hmm


class RankInputs(NamedTuple):
    """One rank's part of a data row, on the rank's device: the (B, W)
    grouped tables and scaled model of its states, and the row's (B, T)
    events and (B,) lengths whole."""

    gt: hmm.GroupedTrans
    model: hmm.ModelArrays
    ev: dict


def split_states(gt: hmm.GroupedTrans, model: hmm.ModelArrays, ev: dict,
                 devices) -> list:
    """The ranks' parts of one data row: rank m gets the states [m W,
    (m + 1) W) of every (B, n) table, W = n / len(devices), and the events
    whole, on devices[m]."""
    M, n = len(devices), gt.stay_lp.shape[-1]
    if M < 1 or n % M:
        raise ValueError(f"{n} states do not split over {M} ranks")
    W = n // M
    parts = []
    for m, dev in enumerate(devices):
        def cut(x, dev=dev, cols=slice(m * W, (m + 1) * W)):
            return x[:, cols].contiguous().to(dev)
        parts.append(RankInputs(
            hmm.GroupedTrans(*(cut(x) for x in gt[:3]), K=gt.K),
            hmm.ModelArrays(*(cut(x) for x in model)),
            {k: v.to(dev) for k, v in ev.items()}))
    return parts


def plan_waves(B: int, devices, resident) -> dict:
    """The waves of a data row of B reads whose rank m lies on devices[m]:
    {device: [(lo, hi), ...]}, the same contiguous cut of [0, B) for every
    device of the row, each wave of at most min over the devices d of
    resident[d] // (the row's ranks on d) reads, so that a wave's grid fits
    each card at once.  resident: {device: blocks it holds at once}."""
    count = collections.Counter(devices)
    per = min(resident[d] // k for d, k in count.items())
    if per < 1:
        raise ValueError(f"a wave of one read does not fit: {dict(count)} "
                         f"ranks a device, {dict(resident)} resident blocks")
    cut = [(lo, min(lo + per, B)) for lo in range(0, B, per)]
    return {d: list(cut) for d in count}


def _plan(rows) -> int:
    """T of the rows' events, with the checks of the schedule."""
    if not rows or not all(rows):
        raise ValueError("no ranks given")
    Ts = {p.ev["mean"].shape[1] for parts in rows for p in parts}
    if len(Ts) != 1 or 0 in Ts:
        raise ValueError(f"the rows' event counts differ or are 0: {Ts}")
    for parts in rows:
        W = {p.gt.stay_lp.shape[-1] for p in parts}
        if len(W) != 1:
            raise ValueError(f"the ranks' slices differ in width: {W}")
    return Ts.pop()


def _wave_rank(part: RankInputs, with_path: bool) -> hmm.WaveRank:
    """A rank's part with its column buffer, backpointers and counters,
    made on its device's current stream."""
    B, T = part.ev["mean"].shape
    W = part.gt.stay_lp.shape[-1]
    dev = part.ev["mean"].device
    return hmm.WaveRank(
        part.gt, part.model, part.ev,
        torch.empty((2, B, W), dtype=torch.float32, device=dev),
        (torch.empty((max(T - 1, 0), B, W), dtype=torch.uint8, device=dev)
         if with_path else None),
        torch.zeros(B, dtype=torch.int32, device=dev))


def _wait_all(cards) -> None:
    """Every card's current stream waits on every other's."""
    for a in cards:
        for b in cards:
            if a != b:
                torch.cuda.current_stream(a).wait_stream(
                    torch.cuda.current_stream(b))


def _forward_kernels(ranks, with_path: bool) -> None:
    """K1m over a data row: a launch a wave and card, each card's on its
    current stream; across cards every card waits first for the others'
    counters to be zeroed, and the row's first card for the others' waves
    after the last."""
    devices = [r.ev["mean"].device for r in ranks]
    cards = list(dict.fromkeys(devices))
    for a in cards:
        for b in cards:
            _cuda.enable_peer_access(a, b)
    sys = len(cards) > 1
    waves = plan_waves(ranks[0].flags.shape[0], devices, {
        d: hmm.forward_wave_resident(d, with_path, sys) for d in cards})
    local = {d: [m for m, x in enumerate(devices) if x == d] for d in cards}
    if sys:
        _wait_all(cards)
    for i in range(len(waves[cards[0]])):
        for d in cards:
            hmm.forward_wave_kernel(ranks, local[d], *waves[d][i])
    first = torch.cuda.current_stream(cards[0])
    for d in cards[1:]:
        first.wait_stream(torch.cuda.current_stream(d))


def _decode(rows, with_path: bool, kernels: bool) -> list:
    """The schedule of the module docstring over K1m and K2m (kernels) or
    their plain versions (all of a row's reads in one wave: the plain
    version steps them one after another)."""
    T = _plan(rows)
    traceback = (hmm.traceback_slices_kernel if kernels
                 else hmm.viterbi_traceback_slices_plain)
    groups = [[_wave_rank(p, with_path) for p in parts] for parts in rows]
    for ranks in groups:
        if kernels:
            _forward_kernels(ranks, with_path)
        else:
            hmm.viterbi_forward_wave_plain(ranks, 0, ranks[0].flags.shape[0])
    out = []
    for ranks in groups:
        final = [r.col[(T - 1) % 2] for r in ranks]
        lengths = ranks[0].ev["length"]
        if with_path:
            path0, codes, logp = traceback(ranks[0].gt.K, final,
                                           [r.bps for r in ranks], lengths)
            out.append({"path0": path0, "codes": codes, "logp": logp})
        else:
            out.append({"logp": torch.amax(
                hmm.gather_column(final, lengths.device), dim=-1)})
        if kernels:
            # the peers' cards free their slices once the walk is done
            cur = torch.cuda.current_stream(lengths.device)
            for r in ranks[1:]:
                torch.cuda.current_stream(r.ev["mean"].device).wait_stream(
                    cur)
    return out


def viterbi_decode_statepar_plain(rows, with_path: bool = True) -> list:
    """The schedule over the plain K1m and K2m, on any devices (the plain
    version of viterbi_decode_statepar)."""
    return _decode(rows, with_path, kernels=False)


def viterbi_decode_statepar(rows, with_path: bool = True) -> list:
    """Decode a chunk with its states split over ranks, as
    nanocall_tpu/basecall.py:1052 _decode_chunk_pooled does under
    shard_pooled_decode_inputs.

    rows: one list of RankInputs per data row, rank m of a row holding the
    states [m W, (m + 1) W) (split_states; 4096 / W ranks of a power of
    two, at most 64, for the kernels).  Returns one dict a row, on its first
    rank's device: {"path0", "codes", "logp"}, or {"logp"} when with_path
    is False, bit-identical to hmm.viterbi_decode_grouped on the row's
    whole tables.  CUDA devices run the kernels (a failed kernel raises;
    rows of one rank run K1 + K2), CPU devices the plain version."""
    types = {p.ev["mean"].device.type for parts in rows for p in parts}
    if types == {"cpu"}:
        return viterbi_decode_statepar_plain(rows, with_path)
    if types != {"cuda"}:
        raise ValueError(f"no state-parallel decode over devices {types}")
    if rows and all(len(parts) == 1 for parts in rows):
        # one rank holds every state and reads no peer: K1 + K2
        _plan(rows)
        return [hmm.viterbi_decode_grouped(*parts[0], with_path=with_path)
                for parts in rows]
    return _decode(rows, with_path, kernels=True)
