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

Not ported: make_mesh, shard_decode_inputs, shard_pooled_decode_inputs and
shard_train_inputs (nanocall_tpu/parallel/mesh.py:64-137).  They shard the
4096-state axis through GSPMD's collectives, which a hand-written kernel
does not have, and the JAX package reaches them only from
tests/test_sharding.py.
"""

from __future__ import annotations

import torch

from .. import shapes


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
    every visible GPU, or the CPU when there is none.  Active when it uses
    more than one device."""

    def __init__(self, n_devices: int | None = None, devices=None):
        if devices is None:
            devices = local_devices(
                "cuda" if torch.cuda.is_available() else "cpu")
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
