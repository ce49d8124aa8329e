"""State-parallel grouped Viterbi decode and EM round over a list of
devices (K1m, K2m; K6am, K6bm; K4m, K5m).

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

The generic decode (hmm.viterbi_decode: K6a + K6b, under a loaded or
structured table, one for every read or one a read) takes the same
schedule under nanocall_tpu/parallel/mesh.py:75 shard_decode_inputs:
split_table_states (or viterbi_decode_placed on mesh.shard_decode_inputs'
parts) gives rank m the (deg, W) cut of the table's from side, its (B, W)
model and the events; each wave is one K6am launch a card
(hmm.forward_generic_wave_kernel, waves cut by plan_waves on
hmm.generic_wave_resident, K6am's own resident blocks), in the resident
form where the cut has the packed layout, else the streaming one; each
step a rank loads the whole column of event t - 1, since a loaded table's
from-states lie anywhere, and runs K6a's slot loop for its states; then
K6bm (hmm.generic_traceback_slices_kernel: K6b's ring, each row assembled
from the slices) walks on the row's first card with the table's whole
from side (its from-state table in shared memory where it has one, else
from_idx from global memory), to {"path" (B, T) uint16, "logp"}.  Each
rank runs K6a's slot loop on the same column, so the decode is
bit-identical to the one-device K6a + K6b, NaN bits included.

The fused EM round (train.train_one_round: K4, K5 and the M-steps) takes
the state axis under nanocall_tpu/parallel/mesh.py:126 shard_train_inputs:
train_one_round_placed gives rank m its cut of train.round_inputs (the
scaled models and state weights of its states; the grouped tables and the
subset built whole and cut; the whole tables' codebooks), and
em_round_statepar runs a data row: K4m (hmm.fwbw_forward_wave_kernel, a
launch a wave and card; waves cut by plan_waves on K4m's own resident
blocks), each step every rank reading the whole alpha column in place
from the ranks' slices of the alphas, which it stores a 1/M share of;
then K5m (em.em_backward_wave_kernel, its own waves), each step every
rank publishing g = em(t + 1) + beta of its states, running K5's
recursion on the whole g column, and taking its states' statistics as
subtrees of K5's pairwise sums (the masked maxima over all states by a
second exchange); the row's first rank combines the ranks' per-step
partials pairwise in rank order and folds them in K5's order.  The
M-steps run in plain torch on the row's first device, on the row's
groups.  So the round is bit-identical to the unplaced one, NaN bits
included; a row of one rank runs K4 + K5.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

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
        W = {p.model.level_mean.shape[-1] for p in parts}
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


def _wave_kernels(ranks, launch, resident) -> None:
    """One launch a wave and card over a data row's ranks (launch(ranks,
    local, lo, hi)), the waves cut by plan_waves from resident(card, sys);
    across cards every card waits first for the others' counters to be
    zeroed, and the row's first card for the others' waves after the
    last."""
    devices = [r.ev["mean"].device for r in ranks]
    cards = list(dict.fromkeys(devices))
    for a in cards:
        for b in cards:
            _cuda.enable_peer_access(a, b)
    sys = len(cards) > 1
    waves = plan_waves(ranks[0].flags.shape[0], devices,
                       {d: resident(d, sys) for d in cards})
    local = {d: [m for m, x in enumerate(devices) if x == d] for d in cards}
    if sys:
        _wait_all(cards)
    for i in range(len(waves[cards[0]])):
        for d in cards:
            launch(ranks, local[d], *waves[d][i])
    first = torch.cuda.current_stream(cards[0])
    for d in cards[1:]:
        first.wait_stream(torch.cuda.current_stream(d))


def _forward_kernels(ranks, with_path: bool, generic: bool = False) -> None:
    """K1m (K6am: generic) over a data row (_wave_kernels), the waves cut on
    the kernel's resident blocks (K6am's at the ranks' slot count, in the
    form their cut takes)."""
    if generic:
        ops, W = ranks[0].ops, ranks[0].col.shape[-1]
        resident = hmm.generic_forward_route(ops) == "resident"
        deg = (ops.from_packed if resident else ops.from_idx).shape[-2]
        _wave_kernels(ranks, hmm.forward_generic_wave_kernel,
                      lambda d, sys: hmm.generic_wave_resident(
                          d, with_path, sys, resident, deg, W))
    else:
        _wave_kernels(ranks, hmm.forward_wave_kernel,
                      lambda d, sys: hmm.forward_wave_resident(d, with_path,
                                                               sys))


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
    tables and of the resident layout, the codebooks whole."""
    def cut(x):
        return None if x is None else x[..., cols].contiguous().to(dev)
    return hmm.TransOps(
        from_idx=cut(ops.from_idx), from_logp=cut(ops.from_logp),
        to_idx=cut(ops.to_idx), to_logp=cut(ops.to_logp), K=ops.K,
        from_packed=cut(ops.from_packed),
        from_codebook=(None if ops.from_codebook is None
                       else ops.from_codebook.contiguous().to(dev)))


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


def viterbi_decode_placed(ops, model, ev: dict,
                          with_path: bool = True) -> list:
    """The generic decode of arguments placed by mesh.shard_decode_inputs
    (ops a mesh.PlacedTable, model a ModelArrays and ev a dict of Sharded
    parts), the counterpart of hmm.viterbi_decode: one output a data row,
    in order, on the row's first device ({"path" (B, T) uint16, "logp"},
    or {"logp"}), which mesh.join joins; bit-identical to the rows of the
    unplaced decode (viterbi_decode_generic_statepar)."""
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
    return viterbi_decode_generic_statepar(rows, with_path)


def _generic_wave_rank(part: GenericRankInputs,
                       with_path: bool) -> hmm.GenericWaveRank:
    """A rank's part with its column buffer, backpointers and counters."""
    B, T = part.ev["mean"].shape
    W = part.model.level_mean.shape[-1]
    dev = part.ev["mean"].device
    return hmm.GenericWaveRank(
        part.ops, part.model, part.ev,
        torch.empty((2, B, W), dtype=torch.float32, device=dev),
        (torch.empty((max(T - 1, 0), B, W), dtype=torch.uint8, device=dev)
         if with_path else None),
        torch.zeros(B, dtype=torch.int32, device=dev))


def _decode_generic(rows, with_path: bool, kernels: bool) -> list:
    """The schedule of the module docstring over K6am and K6bm (kernels) or
    their plain versions (a row's reads in one wave)."""
    T = _plan([row.parts for row in rows])
    traceback = (hmm.generic_traceback_slices_kernel if kernels
                 else hmm.viterbi_traceback_generic_slices_plain)
    groups = [[_generic_wave_rank(p, with_path) for p in row.parts]
              for row in rows]
    for ranks in groups:
        if kernels:
            _forward_kernels(ranks, with_path, generic=True)
        else:
            hmm.viterbi_forward_generic_wave_plain(
                ranks, 0, ranks[0].flags.shape[0])
    out = []
    for row, ranks in zip(rows, groups):
        final = [r.col[(T - 1) % 2] for r in ranks]
        lengths = ranks[0].ev["length"]
        if with_path:
            path, logp = traceback(row.walk, final, [r.bps for r in ranks],
                                   lengths)
            out.append({"path": path, "logp": logp})
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


def viterbi_decode_generic_statepar_plain(rows,
                                          with_path: bool = True) -> list:
    """The generic schedule over the plain K6am and K6bm, on any devices
    (the plain version of viterbi_decode_generic_statepar)."""
    return _decode_generic(rows, with_path, kernels=False)


def viterbi_decode_generic_statepar(rows, with_path: bool = True) -> list:
    """The generic decode with its states split over ranks, as
    nanocall_tpu/ops/hmm.py:759 viterbi_decode runs under
    shard_decode_inputs.

    rows: one GenericRow a data row (split_table_states; 4096 / W ranks of
    a power of two, at most 64, for the kernels).  Returns one dict a row,
    on its first rank's device: {"path", "logp"}, or {"logp"} when
    with_path is False, bit-identical to hmm.viterbi_decode on the row's
    whole table.  CUDA devices run the kernels (a failed kernel, or a table
    neither K6am form takes, raises; rows of one rank run K6a + K6b), CPU
    devices the plain version."""
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
    return _decode_generic(rows, with_path, kernels=True)


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
    """A rank's cut of round_inputs with K4m's outputs and counters."""
    B, T = inp["ev"]["mean"].shape
    W = inp["model"].level_mean.shape[-1]
    dev = inp["ev"]["mean"].device

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return hmm.FwdWaveRank(
        inp["gtf"], inp["model"], inp["ev"],
        buf(T, B, W) if stored else None, None if stored else buf(2, B, W),
        buf(B), torch.zeros(B, dtype=torch.int32, device=dev))


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
        inp["subset"], inp["p_stay_seq"], inp["p_skip_seq"], buf(2, B, W),
        buf(B, 3), buf(B, T, em.NRED_WAVE),
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
        if kernels:
            _wave_kernels(fwd, hmm.fwbw_forward_wave_kernel,
                          lambda d, sys: hmm.fwbw_forward_wave_resident(
                              d, sys, train_any))
        else:
            hmm.fwbw_forward_wave_plain(fwd, 0, B)
        if not train_any:
            out.append((fwd[0].lpd, None, None))
            continue
        bwd = [_em_wave_rank(inp, f) for inp, f in zip(ranks, fwd)]
        W = fwd[0].model.level_mean.shape[-1]
        if kernels:
            _wave_kernels(
                bwd, lambda *a: em.em_backward_wave_kernel(
                    *a, train_scaling, train_transitions),
                lambda d, sys: em.em_backward_wave_resident(
                    d, sys, train_scaling, W))
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


def train_one_round_placed(ev: dict, models: dict, pm_params, st_params,
                           K: int = 6, train_drift: bool = True,
                           train_scaling: bool = True,
                           train_transitions: bool = True,
                           default_ops=None, default_priors=None) -> list:
    """One fused EM round of arguments placed by mesh.shard_train_inputs
    (ev and models dicts of Sharded parts, pm_params and st_params
    Sharded), the counterpart of train.train_one_round under
    nanocall_tpu/parallel/mesh.py:126: each rank builds its cut of
    train.round_inputs from its parts (the scaled models and W of its
    states; the grouped tables and subset built whole and cut), each data
    row runs em_round_statepar (K4m, then K5m with a train flag set), and
    the row's M-steps run in plain torch on its first device
    (train.fused_round_outputs, on the row's groups).  Returns one
    {fit, new_pm_params, done, new_st_params} a data row, in order, on
    the row's first device, bit-identical to the rows of the unplaced
    round.  The legacy round under a loaded table (default_ops) and a
    model bank are not placed: both raise ValueError."""
    if default_ops is not None:
        raise ValueError("the legacy EM round under a loaded table "
                         "(default_ops) is not ported to the mesh's state "
                         "axis yet (ROADMAP.md, queue 1)")
    if "model_idx" in models:
        raise ValueError("a model bank (model_idx) is not placed on the "
                         "state axis: place per-group (G, 2, n) models")
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
    stats = em_round_statepar(rows, train_scaling, train_transitions)
    return [train.fused_round_outputs(e, pm, st, valid, lpd, scal, st3,
                                      train_drift, train_scaling,
                                      train_transitions)
            for (e, pm, st, valid), (lpd, scal, st3) in zip(args, stats)]
