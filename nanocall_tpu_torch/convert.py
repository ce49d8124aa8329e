"""Carry the JAX package's parameters and state over to the port's tensors.

Every function takes numpy arrays (or anything `np.asarray` reads, such as
the JAX package's arrays) and returns tensors on the given device; the
`*_numpy` functions go back.  The decode path and the tests use them to feed
both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import transitions
from .ops import hmm

BANK_FIELDS = ("level_mean", "level_stdv", "sd_mean", "sd_lambda")


def tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """One array as a contiguous tensor of `dtype` on `device`."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def event_batch(batch: dict, device) -> dict:
    """The (B, T) event arrays of events.pad_batch as tensors on `device`:
    mean, stdv and log_stdv float32, length int32 (start is left out)."""
    ev = {k: tensor(batch[k], device) for k in ("mean", "stdv", "log_stdv")}
    ev["length"] = tensor(batch["length"], device, torch.int32)
    return ev


def model_bank(models: dict, names, device) -> dict:
    """{level_mean, level_stdv, sd_mean, sd_lambda}: (M, n) float32 tensors,
    row i from the PoreModel `models[names[i]]` (as
    models.load_builtin_models returns them)."""
    return {
        f: tensor(np.stack([getattr(models[name], f) for name in names]),
                  device)
        for f in BANK_FIELDS
    }


def model_arrays(m, device) -> hmm.ModelArrays:
    """A ModelArrays from the six fields of the JAX package's
    hmm.ModelArrays (or any object with those attributes)."""
    return hmm.ModelArrays(*(tensor(getattr(m, f), device)
                             for f in hmm.ModelArrays._fields))


def model_arrays_from_pore_model(pm, device) -> hmm.ModelArrays:
    """A PoreModel's tables, as it stands (scale it first with pm.scaled),
    as the one (1, n) row of a read that the kernels take
    (hmm.make_model_arrays)."""
    return hmm.make_model_arrays(*(tensor(x, device)
                                   for x in pm.state_arrays()))


def grouped_trans(gt, device) -> hmm.GroupedTrans:
    """A GroupedTrans from the JAX package's hmm.GroupedTrans."""
    return hmm.GroupedTrans(
        stay_lp=tensor(gt.stay_lp, device), step_lp=tensor(gt.step_lp, device),
        skip_lp=tensor(gt.skip_lp, device), K=int(gt.K),
    )


def trans_ops(table, device) -> hmm.TransOps:
    """A TransOps on `device` from the JAX package's numpy tables: a
    SparseTransitions (a loaded `--trans` table, transitions.load_tsv) or a
    StructuredTransitions, whose slot maps are the fixed 21-slot layout
    (transitions.slot_from_state; nanocall_tpu/ops/hmm.py:153-157), with
    the from side's resident K6a layout (hmm.resident_layout: one codebook
    a slot, else hmm.FWBW_GROUPS), both sides' resident K6c / K6e layout
    (hmm.pack_fwbw_sides) and K6b's uint16 from-state table
    (hmm.from_state_table) where the table has them.
    Raises ValueError for a table with more than hmm.MAX_SLOTS
    predecessors of a state, which a uint8 backpointer cannot name."""
    if isinstance(table, transitions.StructuredTransitions):
        from_idx = transitions.slot_from_state(table.K)
        to_idx = transitions._slot_maps(table.K)[1]
    else:
        from_idx, to_idx = table.from_idx, table.to_idx
    deg = np.shape(from_idx)[0]
    if deg > hmm.MAX_SLOTS:
        raise ValueError(
            f"transition table with in-degree {deg}: the Viterbi "
            f"backpointers hold at most {hmm.MAX_SLOTS} slots")
    layout = hmm.resident_layout(from_idx, table.from_logp)
    packed, book = ((None, None) if layout is None else
                    (torch.from_numpy(x).to(device) for x in layout))
    sides = hmm.pack_fwbw_sides(from_idx, table.from_logp, to_idx,
                                table.to_logp)
    states = hmm.from_state_table(from_idx)
    return hmm.TransOps(
        from_idx=tensor(from_idx, device, torch.int32),
        from_logp=tensor(table.from_logp, device),
        to_idx=tensor(to_idx, device, torch.int32),
        to_logp=tensor(table.to_logp, device), K=int(table.K),
        from_packed=packed, from_codebook=book,
        fwbw_packed=None if sides is None else hmm.PackedSides(
            *(torch.from_numpy(x).to(device) for x in sides)),
        from_states=None if states is None
        else torch.from_numpy(states).to(device))


def trans_ops_batch(from_logp, to_logp, K: int, device) -> hmm.TransOps:
    """Per-read structured tables (B, 21, n) as a TransOps on `device`,
    from the JAX package's numpy arrays (transitions.build_structured_batch,
    as nanocall_tpu/ops/hmm.py:82 make_trans_ops_batch takes them): the
    fixed slot maps, K6b's from-state table and, where every read's table
    packs, the per-read resident K6a layout at the codebooks a slot the
    reads need (hmm.make_trans_ops_batch)."""
    return hmm.make_trans_ops_batch(tensor(from_logp, device),
                                    tensor(to_logp, device), K)


def write_fast_transitions(path, p_stay: float, p_skip: float,
                           K: int = 6) -> None:
    """Write the 21-neighbour table of (p_stay, p_skip) as a transitions
    TSV, which `-s/--trans` loads: what the reference's
    `compute-state-transitions --fast -t p_stay -k p_skip` writes."""
    transitions.save_tsv(transitions.build_structured(
        transitions.TransitionParams(p_stay, p_skip), K), path)


def pm_rows(params, device) -> torch.Tensor:
    """(B, 6) float32 scaling rows from PoreModelParams (`as_array()`)."""
    return tensor(np.stack([p.as_array() for p in params]), device)


def st_rows(params, device) -> torch.Tensor:
    """(B, 2) float32 (p_stay, p_skip) rows from TransitionParams or pairs."""
    rows = [(p.p_stay, p.p_skip) if hasattr(p, "p_stay") else tuple(p)
            for p in params]
    return tensor(np.asarray(rows, np.float64).astype(np.float32), device)


def train_batch(ev: dict, models: dict, pm0, st0, device):
    """A packed training batch as the port's tensors: (ev, models, pm_params,
    st_params) for train.train_one_round / train.run_em, from the arrays
    that basecall.pack_train_batch (or the JAX package's) returns.  ev's
    float fields stay float32, length and strand int32, valid bool; models
    are the (M or G, 2, n) float32 tables, plus an int32 'model_idx' when
    the batch carries a model bank."""
    ev_t = {k: tensor(v, device, torch.int32 if k in ("length", "strand")
                      else torch.bool if k == "valid" else torch.float32)
            for k, v in ev.items()}
    mdl_t = {k: tensor(v, device, torch.int32 if k == "model_idx"
                       else torch.float32) for k, v in models.items()}
    return ev_t, mdl_t, tensor(pm0, device), tensor(st0, device)


def model_arrays_numpy(m: hmm.ModelArrays) -> dict:
    return {f: getattr(m, f).cpu().numpy() for f in hmm.ModelArrays._fields}


def grouped_trans_numpy(gt: hmm.GroupedTrans) -> dict:
    return {"stay_lp": gt.stay_lp.cpu().numpy(),
            "step_lp": gt.step_lp.cpu().numpy(),
            "skip_lp": gt.skip_lp.cpu().numpy(), "K": gt.K}
