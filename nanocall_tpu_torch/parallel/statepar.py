"""State-parallel grouped Viterbi decode and EM round over a list of
devices (K1m, K2m; K6am, K6bm; K4m, K5m; K6cm, K6dm).

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
    the column's max.  The rows whose ranks all lie on one card hold their
    slices in one (R, M, T - 1, B, W) allocation there
    (backpointer_slices), and one K2m launch walks them all, each ring
    stage filled by one tensor copy; a row across cards walks alone on its
    first card, a bulk copy a row and rank (hmm.slices_walk_route).

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

The generic decode (hmm.viterbi_decode: K6a + K6b, under a loaded or
structured table, one for every read or one a read) takes the state axis
under nanocall_tpu/parallel/mesh.py:75 shard_decode_inputs:
split_table_states (or viterbi_decode_placed on mesh.shard_decode_inputs'
parts) gives rank m the (deg, W) cut of the table's from side, its (B, W)
model and the events; K6am (hmm.forward_generic_wave_kernel: the resident
form where the cut has the packed layout, else the streaming one) runs
K6a's slot loop for the rank's states on W / 2 threads, 2 states a
thread, so that a read's M blocks take about one SM; each step a rank
needs the whole column of event t - 1, since a loaded table's from-states
lie anywhere.  A row on one card of at most hmm.MAX_CLUSTER ranks takes
one launch of all its reads, a thread block cluster a read, each rank
pushing its slice into its peers' shared memory; else a launch a wave and
card, cut by plan_waves on hmm.generic_wave_resident (K6am's own resident
blocks), the slices exchanged through global memory behind counters.  Then
K6bm (hmm.generic_traceback_slices_kernel: K6b's ring, each row assembled
from the slices) walks on the row's first card with the table's whole
from side (its from-state table in shared memory where it has one, else
from_idx from global memory), to {"path" (B, T) uint16, "logp"}: one
launch for the rows of one table whose ranks lie on one card, as K2m's.
Each rank runs K6a's slot loop on the same column, so the decode is
bit-identical to the one-device K6a + K6b, NaN bits included.

The fused EM round (train.train_one_round: K4, K5 and the M-steps) takes
the state axis under nanocall_tpu/parallel/mesh.py:126 shard_train_inputs:
train_one_round_placed gives rank m its cut of train.round_inputs (the
scaled models and state weights of its states; the grouped tables and the
subset built whole and cut; the whole tables' codebooks), and
em_round_statepar runs a data row: K4m (hmm.fwbw_forward_wave_kernel, W
/ 4 threads a block, so that a read's M blocks fit an SM), each step
every rank publishing its slice of the alphas, which it stores a 1/M
share of, with the slice's partial max, and reading only the rows of the
strided sums its states read; then K5m (em.em_backward_wave_kernel,
blocks sized as K4m's), each step every rank publishing its partial max
of g = em(t + 1) + beta (with its partial masked maxima of the step
before), then the sums of its own blocks of 4 and 16 states, and taking
its states' beta and statistics as subtrees of K5's pairwise sums; the
row's first rank combines the ranks' per-step partials pairwise in rank
order and folds them in K5's order.  A row on one card of at most
hmm.MAX_CLUSTER ranks takes one launch of each, a thread block cluster a
read (the exchange in shared memory); else a launch a wave and card,
cut by plan_waves on each kernel's own resident blocks (the exchange in
global memory behind counters).  The
M-steps run in plain torch on the row's first device, on the row's
groups.  So the round is bit-identical to the unplaced one, NaN bits
included; a row of one rank runs K4 + K5.

Under a loaded table (default_ops) the round is the legacy one
(legacy_estep_statepar): the rows whose strand is at the CLI priors take
K6cm (hmm.fwbw_generic_wave_kernel: K6c's forward and backward for the
rank's states, hmm.fwbw_wave_reads reads a block under the rank's one cut,
each step's whole column exchanged, since a loaded table's from- and
to-states lie anywhere: pushed into the peers' shared memory onto their
mbarriers on one card, else behind counters), the others K4m and K6dm
(em.fwbw_backward_wave_kernel: K6d's beta step, its partial maxima and
block sums exchanged the same ways, each rank storing its betas); each
rank keeps its (B, T, W) slices of alpha, beta and em, and
train.legacy_statistics reduces them, each state sum a tree whose
subtrees are the ranks' slices, so that the round is bit-identical to the
unplaced legacy round.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from .. import train
from ..ops import _cuda, em, hmm


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


def plan_waves(B: int, devices, resident, reads: int = 1) -> dict:
    """The waves of a data row of B reads whose rank m lies on devices[m]:
    {device: [(lo, hi), ...]}, the same contiguous cut of [0, B) for every
    device of the row, each wave of at most `reads` (a block's reads: K6cm
    takes several) times min over the devices d of resident[d] // (the
    row's ranks on d) reads, so that a wave's grid fits each card at once
    and every wave but the last holds whole blocks of reads.  resident:
    {device: blocks it holds at once}."""
    count = collections.Counter(devices)
    per = min(resident[d] // k for d, k in count.items()) * reads
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
        W = {p.model.level_mean.shape[-1] for p in parts}
        if len(W) != 1:
            raise ValueError(f"the ranks' slices differ in width: {W}")
    return Ts.pop()


def backpointer_slices(rows, T: int, keys=None) -> tuple:
    """The ranks' (T - 1, B, W) uint8 backpointer slices of data rows, and
    the rows each traceback launch walks.  rows: one list a row of its
    ranks' (device, B, W); keys: a value a row (None: all equal).  The rows
    whose ranks all lie on one device, with the same M, B, W and key, get
    views [r, m] of one (R, M, T - 1, B, W) allocation there, in row order,
    and are walked in one launch, each stage filled by one tensor copy
    (hmm.slices_walk_route); a row across devices gets a tensor a rank on
    its device and a launch of its own.  Returns (slices a row, [row
    indices a launch])."""
    keys = [None] * len(rows) if keys is None else keys
    out, launches, blocks = [None] * len(rows), [], {}
    for i, ranks in enumerate(rows):
        devs = {dev for dev, _, _ in ranks}
        if len(devs) == 1:
            blocks.setdefault((*ranks[0], len(ranks), keys[i]), []).append(i)
        else:
            out[i] = [torch.empty((max(T - 1, 0), B, W), dtype=torch.uint8,
                                  device=dev) for dev, B, W in ranks]
            launches.append([i])
    for (dev, B, W, M, _), idx in blocks.items():
        block = torch.empty((len(idx), M, max(T - 1, 0), B, W),
                            dtype=torch.uint8, device=dev)
        for r, i in enumerate(idx):
            out[i] = list(block[r])
        launches.append(idx)
    return out, sorted(launches)


def _wave_rank(part: RankInputs, with_path: bool,
               bps: torch.Tensor | None = None) -> hmm.WaveRank:
    """A rank's part with its column buffer, backpointers (bps, or a
    tensor of its own) and counters, made on its device's current
    stream."""
    B, T = part.ev["mean"].shape
    W = part.gt.stay_lp.shape[-1]
    dev = part.ev["mean"].device
    if with_path and bps is None:
        bps = torch.empty((max(T - 1, 0), B, W), dtype=torch.uint8,
                          device=dev)
    return hmm.WaveRank(
        part.gt, part.model, part.ev,
        torch.empty((2, B, W), dtype=torch.float32, device=dev),
        bps if with_path else None,
        torch.zeros(B, dtype=torch.int32, device=dev))


def _wait_all(cards) -> None:
    """Every card's current stream waits on every other's."""
    for a in cards:
        for b in cards:
            if a != b:
                torch.cuda.current_stream(a).wait_stream(
                    torch.cuda.current_stream(b))


def row_waves(B: int, devices, resident, clusters: bool = False,
              reads: int = 1) -> dict:
    """The launches of a data row of B reads whose rank m lies on
    devices[m]: {device: [(lo, hi), ...]}.  With `clusters` (K4m, K5m,
    K6am, K6cm, K6dm), a row on one card of at most hmm.MAX_CLUSTER ranks
    (hmm.wave_cluster) in one launch of all its reads, which the kernels
    run as a cluster a read (K6cm: a read group); else plan_waves' cut on
    resident(card, sys) blocks of `reads` reads, sys: the row spans
    cards."""
    cards = list(dict.fromkeys(devices))
    sys = len(cards) > 1
    if clusters and hmm.wave_cluster(len(devices), sys):
        return {cards[0]: [(0, B)]}
    return plan_waves(B, devices, {d: resident(d, sys) for d in cards},
                      reads)


def _wave_kernels(ranks, launch, resident, clusters: bool = False,
                  reads: int = 1) -> None:
    """One launch a wave and card over a data row's ranks (launch(ranks,
    local, lo, hi)), the waves cut by row_waves (blocks of `reads` reads
    on the cooperative path).  Across cards every card waits first for the
    others' counters to be zeroed, and the row's first card for the
    others' waves after the last."""
    devices = [r.ev["mean"].device for r in ranks]
    cards = list(dict.fromkeys(devices))
    for a in cards:
        for b in cards:
            _cuda.enable_peer_access(a, b)
    waves = row_waves(ranks[0].flags.shape[0], devices, resident, clusters,
                      reads)
    local = {d: [m for m, x in enumerate(devices) if x == d] for d in cards}
    if len(cards) > 1:
        _wait_all(cards)
    for i in range(len(waves[cards[0]])):
        for d in cards:
            launch(ranks, local[d], *waves[d][i])
    first = torch.cuda.current_stream(cards[0])
    for d in cards[1:]:
        first.wait_stream(torch.cuda.current_stream(d))


def _forward_kernels(ranks, with_path: bool, generic: bool = False,
                     cluster: bool | None = None) -> None:
    """K1m (K6am: generic) over a data row (_wave_kernels).  K1m's waves
    are cut on its resident blocks.  K6am takes its cluster path where
    hmm.wave_cluster says, else (or with cluster False, on one card too)
    its cooperative path, the waves cut on its own resident blocks at the
    ranks' slot count, in the form their cut takes."""
    if generic:
        ops, W = ranks[0].ops, ranks[0].col.shape[-1]
        resident = hmm.generic_forward_route(ops) == "resident"
        deg = (ops.from_packed if resident else ops.from_idx).shape[-2]
        groups = hmm.resident_groups(ops) if resident else 1
        _wave_kernels(ranks, lambda *a: hmm.forward_generic_wave_kernel(
                          *a, cluster=cluster),
                      lambda d, sys: hmm.generic_wave_resident(
                          d, with_path, sys, resident, deg, W,
                          groups=groups),
                      clusters=cluster is None)
    else:
        _wave_kernels(ranks, hmm.forward_wave_kernel,
                      lambda d, sys: hmm.forward_wave_resident(d, with_path,
                                                               sys))


def _walk_layout(rows, W_of, T: int, with_path: bool, keys=None) -> tuple:
    """backpointer_slices' (slices a row, row indices a launch) for rows of
    parts (W_of(part): its slice width); score-only, no slices and a row a
    launch."""
    if not with_path:
        return [[None] * len(parts) for parts in rows], [
            [i] for i in range(len(rows))]
    return backpointer_slices(
        [[(p.ev["mean"].device, p.ev["mean"].shape[0], W_of(p))
          for p in parts] for parts in rows], T, keys)


def _walk_rows(groups, launches, walk, with_path: bool, kernels: bool,
               T: int) -> list:
    """The end of the schedule for the rows' ranks (groups): with_path,
    the walk of each launch's rows (walk(idx, rows of (final slices,
    backpointer slices, lengths), kernels) -> an output a row; idx the
    rows' indices), else the score, each row's output on its first device;
    the peers' cards then wait for the walk's card (they free their slices
    after it)."""
    out = [None] * len(groups)
    for idx in launches:
        rows = [([r.col[(T - 1) % 2] for r in groups[i]],
                 [r.bps for r in groups[i]], groups[i][0].ev["length"])
                for i in idx]
        if with_path:
            for i, o in zip(idx, walk(idx, rows, kernels)):
                out[i] = o
        else:
            for i, (final, _, lengths) in zip(idx, rows):
                out[i] = {"logp": torch.amax(
                    hmm.gather_column(final, lengths.device), dim=-1)}
    if kernels:
        for ranks in groups:
            cur = torch.cuda.current_stream(ranks[0].ev["length"].device)
            for r in ranks[1:]:
                torch.cuda.current_stream(r.ev["mean"].device).wait_stream(
                    cur)
    return out


def _walk_grouped(K: int):
    """_walk_rows' walk for K2m (one launch of the rows) or its plain
    version (row by row)."""
    def walk(idx, rows, kernels):
        if kernels:
            outs = hmm.traceback_slices_kernel(K, *map(list, zip(*rows)))
        else:
            outs = [hmm.viterbi_traceback_slices_plain(K, *row)
                    for row in rows]
        return [{"path0": p, "codes": c, "logp": lp} for p, c, lp in outs]
    return walk


def _decode(rows, with_path: bool, kernels: bool) -> list:
    """The schedule of the module docstring over K1m and K2m (kernels) or
    their plain versions (all of a row's reads in one wave: the plain
    version steps them one after another; the walk a row at a time)."""
    T = _plan(rows)
    bps, launches = _walk_layout(rows, lambda p: p.gt.stay_lp.shape[-1], T,
                                 with_path)
    groups = [[_wave_rank(p, with_path, bp) for p, bp in zip(parts, row)]
              for parts, row in zip(rows, bps)]
    for ranks in groups:
        if kernels:
            _forward_kernels(ranks, with_path)
        else:
            hmm.viterbi_forward_wave_plain(ranks, 0, ranks[0].flags.shape[0])
    return _walk_rows(groups, launches, _walk_grouped(groups[0][0].gt.K),
                      with_path, kernels, T)


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


# ---------------------------------------------------------------------------
# the generic decode (K6am, K6bm)
# ---------------------------------------------------------------------------


class GenericRankInputs(NamedTuple):
    """One rank's part of a data row of the generic decode, on the rank's
    device: ops, the (deg, W) cut of the table's sides at its states (per
    read (B, deg, W) log-probs, and the cut of the resident layout where
    the table has one; from_states None), its (B, W) scaled model, and the
    row's (B, T) events and (B,) lengths whole."""

    ops: hmm.TransOps
    model: hmm.ModelArrays
    ev: dict


class GenericRow(NamedTuple):
    """A data row of the generic decode: its ranks' parts in rank order,
    and `walk`, the table's whole from side (from_idx, from_states) on the
    first rank's device, which the traceback walks."""

    parts: list
    walk: hmm.TransOps


def _cut_table(ops: hmm.TransOps, cols: slice, dev) -> hmm.TransOps:
    """The rank's cut of a table: the states `cols` of each side's slot
    tables and of the resident layout, and the layout's codebooks of the
    blocks those states lie in (hmm.resident_book_rows)."""
    def cut(x):
        return None if x is None else x[..., cols].contiguous().to(dev)
    book = None
    if ops.from_codebook is not None:
        rows = hmm.resident_book_rows(hmm.resident_groups(ops),
                                      ops.from_packed.shape[-2], cols,
                                      ops.from_packed.shape[-1])
        book = ops.from_codebook[..., rows, :].contiguous().to(dev)
    return hmm.TransOps(
        from_idx=cut(ops.from_idx), from_logp=cut(ops.from_logp),
        to_idx=cut(ops.to_idx), to_logp=cut(ops.to_logp), K=ops.K,
        from_packed=cut(ops.from_packed), from_codebook=book)


def walk_table(ops: hmm.TransOps, dev) -> hmm.TransOps:
    """The whole from side of a table that K6bm walks (from_idx, and
    from_states where the table has it), on `dev`."""
    return hmm.TransOps(
        from_idx=ops.from_idx.contiguous().to(dev), from_logp=None,
        to_idx=None, to_logp=None, K=ops.K,
        from_states=(None if ops.from_states is None
                     else ops.from_states.contiguous().to(dev)))


def _row_model(x: torch.Tensor, B: int) -> torch.Tensor:
    """A rank's (B, W) model table from its (B, W) or one-row (1, W)
    slice."""
    return x.expand(B, -1).contiguous()


def split_table_states(ops: hmm.TransOps, model: hmm.ModelArrays,
                       ev: dict, devices) -> GenericRow:
    """One data row of the generic decode: rank m gets the states [m W,
    (m + 1) W) of the table (_cut_table) and of the (B, n) or one-row
    (1, n) model, W = n / len(devices), and the events whole, on
    devices[m]; the walk's table goes to devices[0]."""
    M, n = len(devices), ops.from_idx.shape[-1]
    if M < 1 or n % M:
        raise ValueError(f"{n} states do not split over {M} ranks")
    W, B = n // M, ev["length"].shape[0]
    parts = []
    for m, dev in enumerate(devices):
        cols = slice(m * W, (m + 1) * W)
        parts.append(GenericRankInputs(
            _cut_table(ops, cols, dev),
            hmm.ModelArrays(*(_row_model(x[:, cols], B).to(dev)
                              for x in model)),
            {k: v.to(dev) for k, v in ev.items()}))
    return GenericRow(parts, walk_table(ops, devices[0]))


def viterbi_decode_placed(ops, model, ev: dict, with_path: bool = True,
                          cluster: bool | None = None) -> list:
    """The generic decode of arguments placed by mesh.shard_decode_inputs
    (ops a mesh.PlacedTable, model a ModelArrays and ev a dict of Sharded
    parts), the counterpart of hmm.viterbi_decode: one output a data row,
    in order, on the row's first device ({"path" (B, T) uint16, "logp"},
    or {"logp"}), which mesh.join joins; bit-identical to the rows of the
    unplaced decode (viterbi_decode_generic_statepar, which takes
    `cluster`)."""
    cut = ops.cut
    D, M = cut.from_idx.mesh.ids.shape
    rows = []
    for d in range(D):
        parts = []
        for m in range(M):
            part = {k: (None if v is None else v.shards[d][m])
                    for k, v in cut._asdict().items() if k != "K"}
            e = {k: v.shards[d][m] for k, v in ev.items()}
            B = e["length"].shape[0]
            parts.append(GenericRankInputs(
                hmm.TransOps(**part, K=cut.K),
                hmm.ModelArrays(*(_row_model(x.shards[d][m], B)
                                  for x in model)), e))
        rows.append(GenericRow(parts, ops.walk[d]))
    return viterbi_decode_generic_statepar(rows, with_path, cluster)


def _generic_wave_rank(part: GenericRankInputs, with_path: bool,
                       bps: torch.Tensor | None = None
                       ) -> hmm.GenericWaveRank:
    """A rank's part with its column buffer, backpointers (bps, or a
    tensor of its own) and counters."""
    B, T = part.ev["mean"].shape
    W = part.model.level_mean.shape[-1]
    dev = part.ev["mean"].device
    if with_path and bps is None:
        bps = torch.empty((max(T - 1, 0), B, W), dtype=torch.uint8,
                          device=dev)
    return hmm.GenericWaveRank(
        part.ops, part.model, part.ev,
        torch.empty((2, B, W), dtype=torch.float32, device=dev),
        bps if with_path else None,
        torch.zeros(B, dtype=torch.int32, device=dev))


def _walk_table_key(walk: hmm.TransOps) -> tuple:
    """Rows walked in one launch share their table: its tensors'
    addresses."""
    return tuple(None if x is None else (x.device, x.data_ptr())
                 for x in (walk.from_idx, walk.from_states))


def _walk_generic(tables: list):
    """_walk_rows' walk for K6bm (one launch of the rows, under the first
    row's table of `tables`, which they share) or its plain version (row by
    row)."""
    def walk(idx, rows, kernels):
        if kernels:
            outs = hmm.generic_traceback_slices_kernel(
                tables[idx[0]], *map(list, zip(*rows)))
        else:
            outs = [hmm.viterbi_traceback_generic_slices_plain(tables[i],
                                                               *row)
                    for i, row in zip(idx, rows)]
        return [{"path": p, "logp": lp} for p, lp in outs]
    return walk


def _decode_generic(rows, with_path: bool, kernels: bool,
                    cluster: bool | None = None) -> list:
    """The schedule of the module docstring over K6am (on the exchange path
    `cluster` chooses, _forward_kernels) and K6bm (kernels) or their plain
    versions (a row's reads in one wave; the walk a row at a time)."""
    T = _plan([row.parts for row in rows])
    bps, launches = _walk_layout(
        [row.parts for row in rows], lambda p: p.model.level_mean.shape[-1],
        T, with_path, [_walk_table_key(row.walk) for row in rows])
    groups = [[_generic_wave_rank(p, with_path, bp)
               for p, bp in zip(row.parts, row_bps)]
              for row, row_bps in zip(rows, bps)]
    for ranks in groups:
        if kernels:
            _forward_kernels(ranks, with_path, generic=True, cluster=cluster)
        else:
            hmm.viterbi_forward_generic_wave_plain(
                ranks, 0, ranks[0].flags.shape[0])
    return _walk_rows(groups, launches,
                      _walk_generic([row.walk for row in rows]), with_path,
                      kernels, T)


def viterbi_decode_generic_statepar_plain(rows,
                                          with_path: bool = True) -> list:
    """The generic schedule over the plain K6am and K6bm, on any devices
    (the plain version of viterbi_decode_generic_statepar)."""
    return _decode_generic(rows, with_path, kernels=False)


def viterbi_decode_generic_statepar(rows, with_path: bool = True,
                                    cluster: bool | None = None) -> list:
    """The generic decode with its states split over ranks, as
    nanocall_tpu/ops/hmm.py:759 viterbi_decode runs under
    shard_decode_inputs.

    rows: one GenericRow a data row (split_table_states; 4096 / W ranks of
    a power of two, at most 64, for the kernels).  Returns one dict a row,
    on its first rank's device: {"path", "logp"}, or {"logp"} when
    with_path is False, bit-identical to hmm.viterbi_decode on the row's
    whole table.  CUDA devices run the kernels (a failed kernel, or a table
    neither K6am form takes, raises; rows of one rank run K6a + K6b), CPU
    devices the plain version.  cluster: K6am's exchange path, None where
    hmm.wave_cluster says, False the cooperative grid (cluster_path)."""
    types = {p.ev["mean"].device.type for row in rows for p in row.parts}
    if types == {"cpu"}:
        return viterbi_decode_generic_statepar_plain(rows, with_path)
    if types != {"cuda"}:
        raise ValueError(f"no state-parallel decode over devices {types}")
    if rows and all(len(row.parts) == 1 for row in rows):
        # one rank holds every state and reads no peer: K6a + K6b
        _plan([row.parts for row in rows])
        return [hmm.viterbi_decode(
            row.parts[0].ops._replace(from_idx=row.walk.from_idx,
                                      from_states=row.walk.from_states),
            row.parts[0].model, row.parts[0].ev, with_path=with_path)
            for row in rows]
    return _decode_generic(rows, with_path, kernels=True, cluster=cluster)


# ---------------------------------------------------------------------------
# the EM round (K4m, K5m)
# ---------------------------------------------------------------------------


def split_round_states(ev: dict, models: dict, pm_params, st_params,
                       devices, K: int = 6,
                       train_scaling: bool = True) -> list:
    """One data row's ranks of a fused EM round (train_one_round's
    arguments for the row's groups): rank m gets train.round_inputs of
    the states [m W, (m + 1) W), W = n / len(devices), built on
    devices[m] from its cut of the (G, 2, n) models (or of a bank's
    tables, its model_idx whole) and the row's events and parameters
    whole."""
    M, n = len(devices), models["level_mean"].shape[-1]
    if M < 1 or n % M:
        raise ValueError(f"{n} states do not split over {M} ranks")
    W = n // M
    out = []
    for m, dev in enumerate(devices):
        cols = slice(m * W, (m + 1) * W)
        out.append(train.round_inputs(
            {k: v.to(dev) for k, v in ev.items()},
            {k: (v if k == "model_idx" else v[..., cols].contiguous())
             .to(dev) for k, v in models.items()},
            pm_params.to(dev), st_params.to(dev), K, train_scaling,
            states=cols))
    return out


def _fwd_wave_rank(inp: dict, stored: bool) -> hmm.FwdWaveRank:
    """A rank's cut of round_inputs with K4m's outputs, partials and
    counters."""
    B, T = inp["ev"]["mean"].shape
    W = inp["model"].level_mean.shape[-1]
    dev = inp["ev"]["mean"].device

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return hmm.FwdWaveRank(
        inp["gtf"], inp["model"], inp["ev"],
        buf(T, B, W) if stored else None, None if stored else buf(2, B, W),
        buf(3, B), buf(B), torch.zeros(B, dtype=torch.int32, device=dev))


def _em_wave_rank(inp: dict, fwd: hmm.FwdWaveRank) -> em.EMWaveRank:
    """A rank's cut of round_inputs with K4m's alphas and lpd, K5m's
    exchange buffers, counters and outputs."""
    B, T = inp["ev"]["mean"].shape
    W = inp["model"].level_mean.shape[-1]
    dev = inp["ev"]["mean"].device

    def buf(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return em.EMWaveRank(
        inp["gtf"], inp["books"], inp["model"], inp["ev"], fwd.lpd,
        fwd.alphas, inp["W"], inp["x_unc"], inp["t_start"], inp["valid"],
        inp["subset"], inp["p_stay_seq"], inp["p_skip_seq"],
        buf(2, B, em.NMAX_WAVE), buf(2, B, em.block_sums_width(W)),
        buf(B, T, em.NRED_WAVE),
        torch.zeros(B, dtype=torch.int32, device=dev), buf(B, 14),
        buf(B, 3))


def em_round_statepar(rows, train_scaling: bool = True,
                      train_transitions: bool = True) -> list:
    """The E-step of a fused EM round with its states split over ranks, as
    nanocall_tpu/train.py:326 train_one_round runs under
    shard_train_inputs: K4m (the alphas stored when a train flag is set),
    then K5m.

    rows: one list a data row of its ranks' cuts of train.round_inputs
    (states=, rank m the states [m W, (m + 1) W), on its device; 4096 / W
    ranks of a power of two, at most 64, for the kernels).  Returns one
    (lpd (B,), scal (B, 14), st3 (B, 3)) a row on its first rank's device,
    bit-identical to K4's log Pr[data] and K5's statistics on the row's
    whole inputs; scal and st3 are None when neither flag is set.  CUDA
    devices run the kernels (a failed kernel raises; rows of one rank run
    K4 + K5), CPU devices the plain versions."""
    train_any = train_scaling or train_transitions
    types = {inp["ev"]["mean"].device.type for ranks in rows
             for inp in ranks}
    if types not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"no state-parallel EM round over devices {types}")
    kernels = types == {"cuda"}
    out = []
    for ranks in rows:
        if kernels and len(ranks) == 1:
            # one rank holds every state and reads no peer: K4 + K5
            inp = ranks[0]
            alphas, lpd = hmm.fwbw_grouped_forward(
                inp["gtf"], inp["model"], inp["ev"], with_alphas=train_any)
            stats = (em.fused_bwd_mstats(
                inp["gtf"], inp["model"], inp["ev"], lpd, alphas, inp["W"],
                inp["x_unc"], inp["t_start"], inp["valid"], inp["subset"],
                inp["p_stay_seq"], inp["p_skip_seq"], train_scaling,
                train_transitions) if train_any else (None, None))
            out.append((lpd, *stats))
            continue
        B = ranks[0]["ev"]["mean"].shape[0]
        fwd = [_fwd_wave_rank(inp, train_any) for inp in ranks]
        W = fwd[0].model.level_mean.shape[-1]
        if kernels:
            _wave_kernels(fwd, hmm.fwbw_forward_wave_kernel,
                          lambda d, sys: hmm.fwbw_forward_wave_resident(
                              d, sys, W), clusters=True)
        else:
            hmm.fwbw_forward_wave_plain(fwd, 0, B)
        if not train_any:
            out.append((fwd[0].lpd, None, None))
            continue
        bwd = [_em_wave_rank(inp, f) for inp, f in zip(ranks, fwd)]
        if kernels:
            _wave_kernels(
                bwd, lambda *a: em.em_backward_wave_kernel(
                    *a, train_scaling, train_transitions),
                lambda d, sys: em.em_backward_wave_resident(
                    d, sys, train_scaling, W), clusters=True)
        else:
            em.em_backward_wave_plain(bwd, 0, B, train_scaling,
                                      train_transitions)
        out.append((fwd[0].lpd, bwd[0].scal, bwd[0].st3))
        if kernels:
            # the peers' cards free their slices once the fold is done
            cur = torch.cuda.current_stream(fwd[0].lpd.device)
            for r in bwd[1:]:
                torch.cuda.current_stream(r.lpd.device).wait_stream(cur)
    return out


def _select_rank_rows(inp: dict, rows: torch.Tensor) -> dict:
    """A rank's cut of round_inputs at the given rows (on its device): the
    E-step's tables, model, events and whole tables' codebooks."""
    rows = rows.to(inp["x_unc"].device)
    gtf, model, ev = train._select_rows(inp, rows)
    return {"gtf": gtf, "model": model, "ev": ev,
            "books": inp["books"].index_select(0, rows)}


def _fwbw_generic_row(ops: hmm.TransOps, sub: list, kernels: bool,
                      cluster: bool | None) -> list:
    """K6cm (kernels; else its plain version) over the selected rows of a
    data row (sub: a rank's _select_rank_rows each), on the exchange path
    `cluster` chooses (hmm.cluster_path: None where hmm.wave_cluster says,
    False the cooperative grid, its waves of whole blocks of
    hmm.fwbw_wave_reads reads): {alpha, beta, em (b, T, W), log_pr_data
    (b,)} a rank, its slices of K6c's outputs."""
    b, T = sub[0]["ev"]["mean"].shape
    W = sub[0]["model"].level_mean.shape[-1]
    ranks = []
    for m, s in enumerate(sub):
        dev = s["ev"]["mean"].device

        def buf(*shape, dev=dev):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        ranks.append(hmm.FwbwWaveRank(
            hmm.cut_fwbw_table(ops, slice(m * W, (m + 1) * W), dev),
            s["model"], s["ev"], buf(b, T, W), buf(b, T, W), buf(b, T, W),
            buf(b), buf(2, b, W), buf(2, b),
            torch.zeros(b, dtype=torch.int32, device=dev)))
    if kernels:
        cut = ranks[0].ops
        resident = hmm.fwbw_route(cut) == "resident"
        sides = (cut.fwbw_packed[::2] if resident
                 else (cut.from_idx, cut.to_idx))
        deg = max(x.shape[0] for x in sides)
        _wave_kernels(ranks, lambda *a: hmm.fwbw_generic_wave_kernel(
                          *a, cluster=cluster),
                      lambda d, sys: hmm.fwbw_wave_resident(
                          d, sys, resident, deg, W),
                      clusters=cluster is None,
                      reads=hmm.fwbw_wave_reads(W, deg, resident, False))
    else:
        hmm.fwbw_generic_wave_plain(ranks, 0, b)
    return [{"alpha": r.alpha, "beta": r.beta, "em": r.em,
             "log_pr_data": r.lpd} for r in ranks]


def _fwbw_grouped_row(sub: list, kernels: bool,
                      cluster: bool | None) -> list:
    """K4m (alphas stored) then K6dm (kernels, on the exchange path
    `cluster` chooses, as _fwbw_generic_row), or their plain versions, over
    the selected rows of a data row, and each rank's emissions (the plain
    log_emission pass of hmm.fwbw_grouped on its model slice): {alpha (a
    (b, T, W) view of K4m's (T, b, W) store), beta, em, log_pr_data} a
    rank."""
    b, T = sub[0]["ev"]["mean"].shape
    W = sub[0]["model"].level_mean.shape[-1]
    fwd = [_fwd_wave_rank(s, True) for s in sub]
    if kernels:
        _wave_kernels(fwd, lambda *a: hmm.fwbw_forward_wave_kernel(
                          *a, cluster=cluster),
                      lambda d, sys: hmm.fwbw_forward_wave_resident(d, sys,
                                                                    W),
                      clusters=cluster is None)
    else:
        hmm.fwbw_forward_wave_plain(fwd, 0, b)
    bwd = []
    for s in sub:
        dev = s["ev"]["mean"].device
        bwd.append(em.BetaWaveRank(
            s["gtf"], s["books"], s["model"], s["ev"],
            torch.empty((b, T, W), dtype=torch.float32, device=dev),
            torch.zeros((2, b, em.NMAX_WAVE), dtype=torch.float32,
                        device=dev),
            torch.zeros((2, b, em.block_sums_width(W)), dtype=torch.float32,
                        device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev)))
    if kernels:
        _wave_kernels(bwd, lambda *a: em.fwbw_backward_wave_kernel(
                          *a, cluster=cluster),
                      lambda d, sys: em.fwbw_backward_wave_resident(d, sys,
                                                                    W),
                      clusters=cluster is None)
    else:
        em.fwbw_backward_wave_plain(bwd, 0, b)
    out = []
    for s, f, r in zip(sub, fwd, bwd):
        rows = hmm.ModelArrays(*(x[:, None, :] for x in s["model"]))
        out.append({"alpha": f.alphas.transpose(0, 1), "beta": r.betas,
                    "em": hmm.log_emission(rows, s["ev"]["mean"],
                                           s["ev"]["stdv"],
                                           s["ev"]["log_stdv"]),
                    "log_pr_data": f.lpd})
    return out


def legacy_estep_statepar(ranks: list, default_ops,
                          default_priors) -> list:
    """The E-step of the legacy EM round (train._legacy_estep) with the
    states split over a data row's ranks (their cuts of
    train.round_inputs, states=, rank m the states [m W, (m + 1) W)): the
    rows whose strand is at the CLI priors take K6cm under default_ops
    (its cut at each rank's states), every other row K4m (alphas stored)
    and K6dm.  CUDA devices run the kernels (on the exchange path
    hmm.wave_cluster says; a row of one rank runs K6c, K4 and K6d), CPU
    devices the plain versions.  Returns one {alpha, beta, em (B, T, W),
    log_pr_data (B,)} a rank, on its device: its slices of the unplaced
    E-step's, bit for bit."""
    types = {inp["ev"]["mean"].device.type for inp in ranks}
    if types not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"no state-parallel EM round over devices {types}")
    kernels = types == {"cuda"}
    if kernels and len(ranks) == 1:
        return [train._legacy_estep(ranks[0], default_ops, default_priors)]
    inp0 = ranks[0]
    pri_stay, pri_skip = (float(p) for p in np.float32(default_priors))
    use_seq = ((inp0["p_stay_seq"] == pri_stay)
               & (inp0["p_skip_seq"] == pri_skip))
    B, T = inp0["x_unc"].shape
    W = inp0["model"].level_mean.shape[-1]
    fbs = []
    for inp in ranks:
        dev = inp["x_unc"].device
        fb = {k: torch.empty((B, T, W), dtype=torch.float32, device=dev)
              for k in ("alpha", "beta", "em")}
        fb["log_pr_data"] = torch.empty(B, dtype=torch.float32, device=dev)
        fbs.append(fb)
    for generic in (True, False):
        rows = torch.nonzero(use_seq == generic)[:, 0]
        if not len(rows):
            continue
        sub = [_select_rank_rows(inp, rows) for inp in ranks]
        outs = (_fwbw_generic_row(default_ops, sub, kernels, None)
                if generic else _fwbw_grouped_row(sub, kernels, None))
        for fb, o in zip(fbs, outs):
            idx = rows.to(fb["alpha"].device)
            for k, v in o.items():
                fb[k].index_copy_(0, idx, v)
        del outs, sub
    if kernels:
        # the peers' cards free their slices once the first card is done
        cur = torch.cuda.current_stream(inp0["x_unc"].device)
        for inp in ranks[1:]:
            torch.cuda.current_stream(inp["x_unc"].device).wait_stream(cur)
    return fbs


def train_one_round_placed(ev: dict, models: dict, pm_params, st_params,
                           K: int = 6, train_drift: bool = True,
                           train_scaling: bool = True,
                           train_transitions: bool = True,
                           default_ops=None, default_priors=None) -> list:
    """One EM round of arguments placed by mesh.shard_train_inputs (ev and
    models dicts of Sharded parts, pm_params and st_params Sharded), the
    counterpart of train.train_one_round under nanocall_tpu/parallel/
    mesh.py:126: each rank builds its cut of train.round_inputs from its
    parts (the scaled models and W of its states; the grouped tables and
    subset built whole and cut), and each data row runs either the fused
    round, em_round_statepar (K4m, then K5m with a train flag set) and the
    M-steps in plain torch on its first device (train.fused_round_outputs,
    on the row's groups), or, under a loaded table (default_ops, with the
    CLI priors default_priors), the legacy round: legacy_estep_statepar
    (K6cm for the rows at the priors, K4m + K6dm for the others), then
    each rank's part of the legacy statistics
    and the M-steps (train.legacy_round_outputs).  Returns one {fit,
    new_pm_params, done, new_st_params} a data row, in order, on the row's
    first device, bit-identical to the rows of the unplaced round.  A
    model bank is not placed: it raises ValueError."""
    if "model_idx" in models:
        raise ValueError("a model bank (model_idx) is not placed on the "
                         "state axis: place per-group (G, 2, n) models")
    legacy = default_ops is not None
    grid = pm_params.mesh.ids.shape
    rows, args = [], []
    for d in range(grid[0]):
        ranks = []
        for m in range(grid[1]):
            e = {k: v.shards[d][m] for k, v in ev.items()}
            mdl = {k: v.shards[d][m] for k, v in models.items()}
            W = mdl["level_mean"].shape[-1]
            ranks.append(train.round_inputs(
                e, mdl, pm_params.shards[d][m], st_params.shards[d][m], K,
                train_scaling, states=slice(m * W, (m + 1) * W)))
        rows.append(ranks)
        args.append(({k: v.shards[d][0] for k, v in ev.items()},
                     pm_params.shards[d][0], st_params.shards[d][0],
                     ranks[0]["valid"]))
    if legacy:
        return [train.legacy_round_outputs(
            e, pm, st, list(zip(legacy_estep_statepar(
                ranks, default_ops, default_priors), ranks)),
            train_drift, train_scaling, train_transitions)
            for (e, pm, st, _), ranks in zip(args, rows)]
    stats = em_round_statepar(rows, train_scaling, train_transitions)
    return [train.fused_round_outputs(e, pm, st, valid, lpd, scal, st3,
                                      train_drift, train_scaling,
                                      train_transitions)
            for (e, pm, st, valid), (lpd, scal, st3) in zip(args, stats)]
