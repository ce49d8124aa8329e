"""Sequence-parallel Viterbi decode over a list of devices (K9).

Port of nanocall_tpu/parallel/seqpar.py.  The event (time) axis of one
batch of reads is split into D contiguous slices, one per rank; each rank
scans only its T/D events and holds only their backpointers, B * T/D * 4096
bytes, so reads D times longer (or batches D times wider) fit on a card.

The JAX function is single-controller: a shard_map over the devices of one
process, whose only cross-device operations are the alpha and state carries
(ppermute) and a psum that only broadcasts.  Here too one process drives
every rank.  `devices` plays the part of the mesh axis: rank d runs on
devices[d], on a CUDA stream of its own, and a device may appear more than
once (D ranks on one card each get their own stream).

Schedule (the JAX fori_loops unrolled on the host; M batch blocks of
b = B/M reads):

  - forward: at microstep m in [0, M+D-1), rank d runs block j = m - d
    when 0 <= j < M: K3's forward chunk over its slice with t0 = d*T/D and
    the alpha carry from rank d-1 (rank 0 reads none: its t = 0 step
    initialises alpha);
  - end state and logp: rank D-1's output alphas for a block are the
    block's final alphas; their first argmax and max, on rank D-1;
  - traceback: the same pipeline right to left; rank D-1 starts from the
    end state, rank d from the state rank d+1 hands it, and each writes the
    states of its slice (K9's traceback chunk, viterbi_traceback.cu).

The host loop only enqueues work.  A carry moves by copy_ into a buffer on
the receiving rank's device, on the receiver's stream after it waits on the
sender's event.  The only wait on the host is the caller's own, on the
output.

Kernels: each rank block runs K3's forward chunk kernel, which reads the
rank's slice through its first event (ev_t0), and the states twin of K3's
traceback chunk kernel; the same step bodies as K1/K2, so K9 is bit-equal
to the single-device decode by construction.  What bounds it: K3's forward
operations and the traceback's dependent byte loads, over D*M launches of
each half, and the pipeline fill: (D-1)/(M+D-1) of the microsteps leave
some rank idle.  Nothing is done about either yet.

viterbi_decode_seqpar_plain runs the same schedule over the plain chunk
functions, on any device; viterbi_decode_seqpar takes the kernels on CUDA
and the plain version on the CPU, and raises if a kernel fails.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import hmm


def _plan(ev: dict, D: int, n_blocks):
    """(B, T, Tl, M, b) of the decode, with the JAX function's checks and
    default pipeline depth (nanocall_tpu/parallel/seqpar.py:52-64)."""
    B, T = ev["mean"].shape
    if D < 1:
        raise ValueError("no devices given")
    if T % D:
        raise ValueError(f"T={T} not divisible by {D} ranks")
    if n_blocks is None:
        # deepest pipeline that divides B, capped at D (more blocks than
        # ranks only adds microsteps without filling more stages)
        n_blocks = max(m for m in range(1, max(min(B, D), 1) + 1)
                       if B % m == 0)
    M = n_blocks
    if M < 1 or B % M:
        raise ValueError(f"B={B} not divisible by n_blocks={M}")
    return B, T, T // D, M, B // M


class _Rank:
    """One rank: its device, its stream (None in the plain version, which
    runs on the devices' current streams), and what it holds there."""

    def __init__(self, d: int, device, streams: bool):
        self.d = d
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device) if streams else None)

    def ctx(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def place(self, gt, model, ev, Tl: int) -> None:
        """Its contiguous copy of the events of its slice, the lengths and
        the tables, on its device; its stream then waits for them."""
        sl = slice(self.d * Tl, (self.d + 1) * Tl)
        dev = self.device
        self.ev = {k: ev[k][:, sl].contiguous().to(dev)
                   for k in ("mean", "stdv", "log_stdv")}
        self.ev["length"] = ev["length"].to(dev, torch.int32)
        self.gt = hmm.GroupedTrans(*(x.to(dev) for x in gt[:3]), K=gt.K)
        self.model = hmm.ModelArrays(*(x.to(dev) for x in model))
        if self.stream is not None:
            # made (or owned by the caller) on the current stream, read on
            # this rank's
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            for x in (*self.ev.values(), *self.gt[:3], *self.model):
                x.record_stream(self.stream)

    def block(self, j: int, b: int):
        """Block j's rows of the tables and events: contiguous views."""
        rows = slice(j * b, (j + 1) * b)
        return (hmm.GroupedTrans(*(x[rows] for x in self.gt[:3]), K=self.gt.K),
                hmm.ModelArrays(*(x[rows] for x in self.model)),
                {k: v[rows] for k, v in self.ev.items()})


def _send(x: torch.Tensor, src: _Rank, dst: _Rank) -> torch.Tensor:
    """x, made on rank src's stream, as a new tensor on rank dst's device,
    copied on dst's stream once src's work so far is done."""
    if src.stream is None:
        return x.to(dst.device, copy=True)
    done = torch.cuda.Event()
    done.record(src.stream)
    dst.stream.wait_event(done)
    with dst.ctx():
        buf = torch.empty_like(x, device=dst.device)
        if x.device == dst.device:
            buf.copy_(x, non_blocking=True)
            x.record_stream(dst.stream)
        else:
            # torch copies between cards on the source's current stream,
            # with a barrier on both cards' current streams
            with src.ctx():
                buf.copy_(x, non_blocking=True)
    return buf


def _forward_kernel(gt, model, ev, carry, t0: int):
    Tl = ev["mean"].shape[1]
    return hmm.forward_chunk_kernel(gt, model, ev, carry, t0, Tl, ev_t0=t0)


def _traceback_plain(K, end, state, bps, t0, lengths, states) -> None:
    s, ys = hmm.viterbi_traceback_grouped_chunk_plain(K, end, state, bps, t0,
                                                      lengths, compact=False)
    state.copy_(s)
    states.copy_(ys)


def _decode(gt, model, ev: dict, devices, n_blocks, kernels: bool) -> dict:
    """The schedule of the module docstring, over K3's kernels and K9's
    traceback chunk (kernels) or their plain versions."""
    D = len(devices)
    B, T, Tl, M, b = _plan(ev, D, n_blocks)
    forward = (_forward_kernel if kernels
               else hmm.viterbi_forward_grouped_chunk_plain)
    traceback = (hmm.traceback_chunk_states_kernel if kernels
                 else _traceback_plain)
    ranks = [_Rank(d, dev, kernels) for d, dev in enumerate(devices)]
    for r in ranks:
        r.place(gt, model, ev, Tl)
    last = ranks[-1]

    # forward: the alpha carry rides left to right
    carries, bps, finals = {}, {}, {}  # (rank, block) / block -> tensor
    for m in range(M + D - 1):
        for r in ranks:
            j = m - r.d
            if not 0 <= j < M:
                continue
            with r.ctx():
                g, mo, e = r.block(j, b)
                alpha, bps[r.d, j] = forward(g, mo, e,
                                             carries.pop((r.d, j), None),
                                             r.d * Tl)
            if r is last:
                finals[j] = alpha
            else:
                carries[r.d + 1, j] = _send(alpha, r, ranks[r.d + 1])

    # end state and logp of each block, on the last rank
    with last.ctx():
        logp = torch.empty(B, dtype=torch.float32, device=last.device)
        ends = {}
        for j in range(M):
            ends[last.d, j] = torch.argmax(finals[j], dim=-1).to(torch.int32)
            logp[j * b:(j + 1) * b] = torch.amax(finals.pop(j), dim=-1)
        for r in ranks[:-1]:
            for j in range(M):
                ends[r.d, j] = _send(ends[last.d, j], last, r)
    states = []  # each rank's (Tl, B) states
    for r in ranks:
        with r.ctx():
            states.append(torch.empty((Tl, B), dtype=torch.uint16,
                                      device=r.device))

    # traceback: the state carry rides right to left
    carries = {}
    for m in range(M + D - 1):
        for r in reversed(ranks):
            j = m - (D - 1 - r.d)
            if not 0 <= j < M:
                continue
            end = ends.pop((r.d, j))
            rows = slice(j * b, (j + 1) * b)
            with r.ctx():
                state = (end.clone() if r is last
                         else carries.pop((r.d, j)))
                traceback(gt.K, end, state, bps.pop((r.d, j)), r.d * Tl,
                          r.ev["length"][rows], states[r.d][:, rows])
            if r.d > 0:
                carries[r.d - 1, j] = _send(state, r, ranks[r.d - 1])

    out = torch.device(devices[0])
    if kernels:
        # the outputs are read on the devices' current streams
        for r in ranks:
            cur = torch.cuda.current_stream(r.device)
            cur.wait_stream(r.stream)
            states[r.d].record_stream(cur)
        logp.record_stream(torch.cuda.current_stream(last.device))
    path = torch.cat([s.to(out) for s in states]).t().contiguous()
    return {"path": path, "logp": logp.to(out)}


def viterbi_decode_seqpar_plain(gt, model, ev: dict, devices,
                                n_blocks: int | None = None) -> dict:
    """K9's schedule over the plain chunk functions, on any devices (the
    plain version of viterbi_decode_seqpar)."""
    return _decode(gt, model, ev, devices, n_blocks, kernels=False)


def viterbi_decode_seqpar(gt, model, ev: dict, devices,
                          n_blocks: int | None = None) -> dict:
    """Decode a (B, T) event batch with T split over the ranks `devices`
    (a list of torch.device; repeats allowed), as
    nanocall_tpu.parallel.seqpar.viterbi_decode_seqpar does over a mesh
    axis.

    ev: {mean, stdv, log_stdv: (B, T) float32; length: (B,) int32 global
    lengths}; gt, model: (B, n) tables.  T must divide by D = len(devices)
    and B by n_blocks (default: the largest divisor of B up to min(B, D)).
    Returns {"path": (B, T) uint16, "logp": (B,) float32} on devices[0],
    bit-identical to the single-device decode.  CUDA devices run the
    kernels (a failed kernel raises), CPU devices the plain version."""
    types = {torch.device(d).type for d in devices}
    if types == {"cpu"}:
        return viterbi_decode_seqpar_plain(gt, model, ev, devices, n_blocks)
    if types != {"cuda"}:
        raise ValueError(f"no sequence-parallel decode over devices {types}")
    return _decode(gt, model, ev, devices, n_blocks, kernels=True)
