"""Per-device data parallelism for the decode and EM chunks.

Port of nanocall_tpu/parallel/mesh.py's DataSharder.  The reference
parallelizes with a thread pool over reads (pfor, nanocall.cpp:282,611);
the JAX package shards the batch axis of a chunk (reads, decode tasks or
training groups) over the 'data' axis of a mesh of local devices.  Here the
sharder cuts a chunk's batch-leading tensors into contiguous slices, one per
device, as P("data") does, and copies every other tensor to each device.
Batch rows are independent, so each device runs the chunk's kernels on its
slice and the results join in order: no collective, and the output equals
the unsharded run's.

A device may appear more than once in `devices` (several shards on one
card, as chip_smoke.py checks the sharded runs on a one-GPU machine).  The
sharder never moves work to the CPU: a CUDA run shards over GPUs only.

The 2-D mesh (nanocall_tpu/parallel/mesh.py:64-137): make_mesh builds a
(data, model) grid of devices, and shard_pooled_decode_inputs places the
production decode's inputs on it: the batch over 'data', the bank's
4096-state axis over 'model'.  basecall.decode_chunk_pooled takes the
placed arguments and decodes each data row with its states split over the
row's ranks (parallel/statepar.py: K1m and K2m); where GSPMD inserts the
collectives in JAX, each rank reads the alpha column's other slices in
place from its peers each step.  The JAX package's multi-chip entry point
runs them (__graft_entry__.py:98-172, dryrun_multichip), as does
tests/test_sharding.py.  shard_decode_inputs places the generic decode's
inputs (a TransOps, a model and events; nanocall_tpu/parallel/mesh.py:75)
the same way, under one table or per-read tables, and
statepar.viterbi_decode_placed decodes them (K6am and K6bm).
shard_train_inputs places a training batch (nanocall_tpu/parallel/
mesh.py:126): the groups over 'data', the models' state axis over 'model';
statepar.train_one_round_placed runs the fused EM round on it (K4m and
K5m).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import shapes
from ..ops import hmm
from . import statepar


def indexed(device) -> torch.device:
    """`device` with its index: a bare "cuda" becomes the card current now.
    A run holds its device indexed, so that what it allocates later stays on
    that card whichever card is current then."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(device) -> list:
    """The devices a run on `device` shards over: every visible GPU for a
    CUDA run, the CPU alone for a CPU run."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class DataSharder:
    """Splits batch-leading tensors over a list of devices.

    n_devices: how many of `devices` to use (None or 0: all; the
    --num-shards / Config.num_shards of the JAX package); devices: default
    every visible GPU, and a RuntimeError where there is none (a CPU
    sharder names its devices).  Active when it uses more than one
    device."""

    def __init__(self, n_devices: int | None = None, devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DataSharder() shards over the visible GPUs and there is "
                    "none; pass devices= to shard over others")
            devices = local_devices("cuda")
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("no devices to shard over")
        self.n = max(1, min(n_devices or len(devices), len(devices)))
        self.devices = devices[:self.n]

    @property
    def active(self) -> bool:
        return self.n > 1

    @property
    def align(self) -> int:
        """The multiple every full chunk's batch is floored to."""
        return self.n if self.active else 1

    def shard(self, tree, batch_size: int) -> list:
        """One copy of `tree` (tensors in dicts, tuples and NamedTuples) per
        non-empty shard, in order: each tensor whose leading dimension is
        batch_size cut to the shard's rows, every other tensor whole, all on
        the shard's device (a slice of a contiguous tensor stays
        contiguous)."""
        out, lo = [], 0
        for dev, rows in zip(self.devices,
                             shapes.shard_sizes(batch_size, self.n)):
            out.append(_map(tree, lambda x, dev=dev, lo=lo, rows=rows: (
                x[lo:lo + rows] if x.ndim >= 1 and x.shape[0] == batch_size
                else x).to(dev)))
            lo += rows
        return out

    def replicate(self, tree, n_shards: int) -> list:
        """`tree` on each of the first n_shards devices."""
        return [_map(tree, lambda x, dev=dev: x.to(dev))
                for dev in self.devices[:n_shards]]


def _map(tree, fn):
    """fn applied to every tensor of a tree of dicts, tuples, NamedTuples
    and lists; other leaves (ints, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def join(outs: list) -> dict:
    """The shards' output dicts joined along the batch in shard order, on
    the host."""
    return {k: torch.cat([o[k].cpu() for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# the (data, model) mesh
# ---------------------------------------------------------------------------


class Mesh:
    """A (data, model) grid of devices, row-major as JAX reshapes the
    device list (nanocall_tpu/parallel/mesh.py:64-72): devices[d][m] is
    the device of data row d and model rank m, ids[d, m] its index in the
    list the mesh was made from."""

    axis_names = ("data", "model")

    def __init__(self, devices: list, model: int):
        n = len(devices)
        if n < 1 or n % model:
            raise ValueError(f"{n} devices do not make rows of {model}")
        self.ids = np.arange(n).reshape(n // model, model)
        self.devices = [[devices[i] for i in row] for row in self.ids]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ids.shape))


def make_mesh(n_devices: int | None = None, model_axis: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the first n_devices of `devices` (default
    every visible GPU; a RuntimeError where there is none, as
    DataSharder()).  model_axis falls back to 1 where it does not divide
    n, as in JAX.  A device may repeat: [cuda:0] * n runs every rank on one
    card (a stream each)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() builds its mesh from the visible GPUs and there "
                "is none; pass devices= to use others")
        devices = local_devices("cuda")
    devices = [indexed(d) for d in devices]
    n = n_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from {len(devices)}")
    return Mesh(devices[:n], model_axis if n % model_axis == 0 else 1)


class Sharded(NamedTuple):
    """One argument placed on a mesh: spec names the mesh axis each of its
    dimensions is cut over (JAX's PartitionSpec; None: whole), shards[d][m]
    its part on mesh.devices[d][m] (JAX's addressable_shards)."""

    mesh: Mesh
    spec: tuple
    shards: list


def _cuts(size: int, parts: int, what: str) -> list:
    """`parts` contiguous slices of `size`, as P(axis) cuts it (which, as
    in JAX, must divide it)."""
    if size % parts:
        raise ValueError(f"{size} {what} do not split over {parts} ranks")
    q = size // parts
    return [slice(i * q, (i + 1) * q) for i in range(parts)]


def shard_pooled_decode_inputs(mesh: Mesh, pool_mean, pool_stdv, pool_start,
                               idx, drifts, bank, model_idx, pm_params, stp,
                               lengths) -> tuple:
    """Place the production decode's inputs (basecall.decode_chunk_pooled's
    arguments, in its order; nanocall_tpu/parallel/mesh.py:103) on the
    mesh.  Every batch-leading tensor is cut into contiguous rows over
    'data' (P("data")), whole over 'model'; each bank table's state axis is
    cut into contiguous slices over 'model' (P(None, "model")): rank m holds
    the states [m W, (m + 1) W), W = n / M.  The event pool is indexed
    through idx: a data row's shard holds the pool rows its tasks name, in
    task order, and its idx is renumbered to them (the contiguous P("data")
    cut itself where the pool holds the chunk's own rows in order, as the
    JAX test's does).  Returns the Sharded arguments, in order, with the
    bank as a dict of Sharded tables."""
    D, M = mesh.ids.shape
    rows = _cuts(idx.shape[0], D, "tasks")
    states = _cuts(next(iter(bank.values())).shape[-1], M, "states")

    def by_data(x):
        return Sharded(mesh, ("data",), [
            [x[rows[d]].to(dev) for dev in devs]
            for d, devs in enumerate(mesh.devices)])

    pool = [by_data(x[idx]) for x in (pool_mean, pool_stdv, pool_start)]
    local_idx = Sharded(mesh, ("data",), [
        [torch.arange(idx.shape[0] // D, device=dev) for dev in devs]
        for devs in mesh.devices])
    placed_bank = {k: Sharded(mesh, (None, "model"), [
        [v[:, states[m]].contiguous().to(dev) for m, dev in enumerate(devs)]
        for devs in mesh.devices]) for k, v in bank.items()}
    return (*pool, local_idx, by_data(drifts), placed_bank,
            by_data(model_idx), by_data(pm_params), by_data(stp),
            by_data(lengths))


class PlacedTable(NamedTuple):
    """A transition table placed by shard_decode_inputs: `cut`, a TransOps
    whose tensors are Sharded, each rank's slots of its own destination
    states (what K6am steps from); `walk[d]`, the whole from side on data
    row d's first device (a TransOps of from_idx (deg, n) and from_states
    or None, the rest None), which K6bm walks."""

    cut: hmm.TransOps
    walk: list


def shard_decode_inputs(mesh: Mesh, ops: hmm.TransOps, model, ev: dict
                        ) -> tuple:
    """Place the generic decode's inputs (hmm.viterbi_decode's: a loaded
    or structured table, the scaled model, the events) on the mesh, as
    nanocall_tpu/parallel/mesh.py:75-100 does: the events' batch over
    'data' (P("data")); a (B, n) model over ('data', 'model'), a one-row
    (1, n) model over 'model' (its (1, W) slices broadcast to each data
    row's reads); the table's state axis over 'model': a shared (deg, n)
    table as (deg, W) slices (P(None, "model")), per-read (B, deg, n)
    tables as (B / D, deg, W) (P("data", None, "model")), from_idx and
    to_idx as (deg, W); the resident layout's from_packed cut as its table
    and its codebooks (per read over 'data') cut over 'model' to the
    blocks of states each rank's lie in (hmm.resident_book_rows: one
    block's, or a slice's blocks where it spans several).  The whole from
    side for the traceback goes to each row's first rank
    (PlacedTable.walk).  Returns (PlacedTable, model, ev): the
    model a ModelArrays and the events a dict of Sharded arguments, which
    statepar.viterbi_decode_placed decodes."""
    D, M = mesh.ids.shape
    B = ev["length"].shape[0]
    rows = _cuts(B, D, "reads")
    n = ops.from_idx.shape[-1]
    states = _cuts(n, M, "states")

    def place(x, spec, model_cuts=states):
        if x is None:
            return None
        shards = []
        for d, devs in enumerate(mesh.devices):
            row = []
            for m, dev in enumerate(devs):
                part = x
                for axis, name in enumerate(spec):
                    cut = {"data": rows[d], "model": model_cuts[m]}.get(name)
                    if cut is not None:
                        part = part[(slice(None),) * axis + (cut,)]
                row.append(part.contiguous().to(dev))
            shards.append(row)
        return Sharded(mesh, spec, shards)

    table = ("data", None, "model") if hmm.per_read(ops) else (None, "model")
    book = ("data", "model", None) if hmm.per_read(ops) else ("model", None)
    book_rows = None
    if ops.from_codebook is not None:
        book_rows = [hmm.resident_book_rows(
            hmm.resident_groups(ops), ops.from_packed.shape[-2], s, n)
            for s in states]
    cut = hmm.TransOps(
        from_idx=place(ops.from_idx, (None, "model")),
        from_logp=place(ops.from_logp, table),
        to_idx=place(ops.to_idx, (None, "model")),
        to_logp=place(ops.to_logp, table), K=ops.K,
        from_packed=place(ops.from_packed, table),
        from_codebook=place(ops.from_codebook, book, book_rows))
    walk = [statepar.walk_table(ops, devs[0]) for devs in mesh.devices]
    if model.level_mean.shape[0] not in (1, B):
        raise ValueError(f"a model of {model.level_mean.shape[0]} rows for "
                         f"{B} reads")
    per_row = model.level_mean.shape[0] == B and (B > 1 or D == 1)
    placed_model = type(model)(*(
        place(x, ("data", "model") if per_row else (None, "model"))
        for x in model))
    placed_ev = {k: place(v, ("data",)) for k, v in ev.items()}
    return PlacedTable(cut, walk), placed_model, placed_ev


def shard_train_inputs(mesh: Mesh, ev: dict, models: dict, pm_params,
                       st_params) -> tuple:
    """Place a training batch (train.train_one_round's arguments:
    (G, S, T) and (G, S) events, (G, 2, n) models, (G, 6) pm_params,
    (G, 2, 2) st_params) on the mesh, as nanocall_tpu/parallel/mesh.py:
    126-137 does: the groups over 'data' (P("data"): contiguous rows, whole
    over 'model'); each model table over ('data', None, 'model'), a
    (G / D, 2, W) cut a rank, rank m holding the states [m W, (m + 1) W),
    W = n / M.  A model bank (a (G,) 'model_idx' beside (n_models, 2, n)
    tables) raises ValueError, as JAX's placement cannot put a (G,) array
    under the tables' 3-D spec either.  Returns (ev, models, pm_params,
    st_params) as Sharded arguments (dicts of them for ev and models),
    which statepar.train_one_round_placed runs."""
    if "model_idx" in models:
        raise ValueError("shard_train_inputs places per-group (G, 2, n) "
                         "models; a model bank (model_idx) has no placement "
                         "on the state axis")
    D, M = mesh.ids.shape
    rows = _cuts(pm_params.shape[0], D, "groups")
    states = _cuts(next(iter(models.values())).shape[-1], M, "states")

    def by_data(x):
        return Sharded(mesh, ("data",), [
            [x[rows[d]].contiguous().to(dev) for dev in devs]
            for d, devs in enumerate(mesh.devices)])

    placed_models = {k: Sharded(mesh, ("data", None, "model"), [
        [v[rows[d], :, states[m]].contiguous().to(dev)
         for m, dev in enumerate(devs)]
        for d, devs in enumerate(mesh.devices)]) for k, v in models.items()}
    return ({k: by_data(v) for k, v in ev.items()}, placed_models,
            by_data(pm_params), by_data(st_params))
