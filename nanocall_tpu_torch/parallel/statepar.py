"""State-parallel grouped Viterbi decode over a list of devices (K1m, K2m).

The port of the production decode on the 'model' axis of a (data, model)
mesh: nanocall_tpu/parallel/mesh.py:103 shard_pooled_decode_inputs places
the bank's 4096-state axis over 'model', and GSPMD splits the scaled
models, the emissions and the grouped recursion by state and inserts the
collectives.  Here one process drives every rank, as parallel/seqpar.py
does for K9: rank m of a data row runs on its device, on a CUDA stream of
its own, holds the states [m W, (m + 1) W), W = 4096 / M, and of them only:
its (B, W) tables and scaled model (it scales only its slice of the bank),
its alpha slice and its (T - 1, B, W) backpointer bytes, B T W bytes, a
1/M share of the decode's backpointers.  A device may appear more than once
(M ranks on one card each get their own stream).

Schedule, per event t (the JAX scan unrolled on the host):

  - each rank runs K1m (K1's kernel, one step of its states) on the whole
    column of event t - 1 and writes its slice of column t into its own
    copy of the column.  A step needs the whole previous column: state j's
    step predecessors r 1024 + (j >> 2) and skip predecessors r 256 +
    (j >> 4) lie in every slice;
  - the column is all-gathered: each rank pulls the peers' slices of
    column t into its copy (a copy on its stream, peer to peer across
    cards, once the peer's step is done).  The copies are double-buffered by the parity of t, and a rank
    writes its slice of column t only after every peer pulled column t - 1
    (an event a rank and step: `pulled`), so no rank overwrites a slice
    another still reads;
  - after the last event, the row's first rank takes the end argmax over
    the gathered final column and walks the ranks' slices (K2m, reading a
    slice on another card in place), so path0, codes and logp come out on
    the row's first device; a score-only decode takes the column's max.

Each rank runs K1's step body for its own states from the same column, so
the decode is bit-identical to the one-device K1 + K2 by construction.
What bounds it: T M launches of K1m and T M (M - 1) copies a data row,
enqueued by one host thread, against K1's one launch: the host, not the
card.  A reduce-scatter of partial (max, first argmax) pairs, 1280 / M
values a read and step in place of the column's 4096, is the next design.

viterbi_decode_statepar_plain runs the same schedule over the plain
versions, on any devices; viterbi_decode_statepar takes the kernels on CUDA
and the plain version on the CPU, and raises if a kernel fails.
"""

from __future__ import annotations

import contextlib
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


class _Rank:
    """One rank of a data row: its device, stream (None in the plain
    version, which runs on the devices' current streams), its two column
    copies (M, B, W) and its backpointer slice."""

    def __init__(self, m: int, part: RankInputs, M: int, with_path: bool,
                 streams: bool):
        self.m = m
        self.gt, self.model, self.ev = part
        B, T = self.ev["mean"].shape
        self.W = self.gt.stay_lp.shape[-1]
        self.lo = m * self.W
        self.device = self.ev["mean"].device
        # on the device's current stream: the caller's stream waits on
        # every rank's before it frees them (_join)
        cols = torch.empty((2, M, B, self.W), dtype=torch.float32,
                           device=self.device)
        # by parity: the column copy (M, B, W), and its slice m (B, W)
        self.cols = (cols[0], cols[1])
        self.own = (cols[0, m], cols[1, m])
        self.bps = (torch.empty((max(T - 1, 0), B, self.W), dtype=torch.uint8,
                                device=self.device) if with_path else None)
        self.stream = torch.cuda.Stream(self.device) if streams else None
        if streams:
            # made (or owned by the caller) on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self.computed, self.pulled = torch.cuda.Event(), torch.cuda.Event()
        self.peers: list = []

    def ctx(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def pull(self, peer: "_Rank", par: int) -> None:
        """The peer's slice of the column of parity `par` into this rank's
        copy, on this rank's stream once the peer's step is done."""
        src, dst = peer.own[par], self.cols[par][peer.m]
        if self.stream is None:
            dst.copy_(src)
            return
        self.stream.wait_event(peer.computed)
        _cuda.copy_async(dst, src, self.stream)


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


def _decode(rows, with_path: bool, kernels: bool) -> list:
    """The schedule of the module docstring over K1m and K2m (kernels) or
    their plain versions, every data row's ranks stepping together."""
    T = _plan(rows)
    step = (hmm.forward_slice_kernel if kernels
            else hmm.viterbi_forward_slice_plain)
    traceback = (hmm.traceback_slices_kernel if kernels
                 else hmm.viterbi_traceback_slices_plain)
    groups = [[_Rank(m, p, len(parts), with_path, kernels)
               for m, p in enumerate(parts)] for parts in rows]
    for g in groups:
        for r in g:
            r.peers = [p for p in g if p is not r]
    ranks = [r for g in groups for r in g]
    for t in range(T):
        par = t % 2
        for r in ranks:
            with r.ctx():
                if kernels and t:
                    # the slice it writes now, peers pulled at t - 2
                    for p in r.peers:
                        r.stream.wait_event(p.pulled)
                step(r.gt, r.model, r.ev, r.cols[1 - par], t, r.lo,
                     r.own[par],
                     r.bps[t - 1] if r.bps is not None and t else None)
                if kernels:
                    r.computed.record(r.stream)
        for r in ranks:
            for p in r.peers:
                r.pull(p, par)
            if kernels:
                r.pulled.record(r.stream)
    if kernels:
        _join(ranks)
    out = []
    for g in groups:
        final = g[0].cols[(T - 1) % 2]
        if with_path:
            path0, codes, logp = traceback(
                g[0].gt.K, final, [r.bps for r in g], g[0].ev["length"])
            out.append({"path0": path0, "codes": codes, "logp": logp})
        else:
            out.append({"logp": torch.amax(hmm.gather_column(final), dim=-1)})
        if kernels:
            # the peers' cards free their slices once the walk is done
            cur = torch.cuda.current_stream(g[0].device)
            for r in g[1:]:
                torch.cuda.current_stream(r.device).wait_stream(cur)
    return out


def _join(ranks) -> None:
    """Every used device's current stream waits on every rank's stream."""
    devices = {r.device for r in ranks}
    for d in devices:
        cur = torch.cuda.current_stream(d)
        for r in ranks:
            cur.wait_stream(r.stream)


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
    whole tables.  CUDA devices run the kernels (a failed kernel raises),
    CPU devices the plain version."""
    types = {p.ev["mean"].device.type for parts in rows for p in parts}
    if types == {"cpu"}:
        return viterbi_decode_statepar_plain(rows, with_path)
    if types != {"cuda"}:
        raise ValueError(f"no state-parallel decode over devices {types}")
    return _decode(rows, with_path, kernels=True)
