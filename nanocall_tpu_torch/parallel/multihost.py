"""Multi-host execution: file sharding, output merging and the barrier.

Port of nanocall_tpu/parallel/multihost.py.  Each host process runs the
whole pipeline over its contiguous share of the input fast5 files (reads
are independent), writes a shard FASTA and a stats shard, and host 0 merges
the FASTA shards in global input order, so the merged FASTA equals a
single-host run's (the reference's ordered-chunk contract,
nanocall.cpp:859-861).

The data sharder over each host's own devices (parallel/mesh.py) composes
underneath.  The only cross-host operation is the barrier before the merge:
basecalling needs no device collective, and EM statistics reduce per read.
So the process group is gloo's, over TCP, whatever the devices.
"""

from __future__ import annotations

import os
import shutil

import torch.distributed as dist


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the run's process group: gloo at tcp://<coordinator>
    (host:port; process 0 listens there).  gloo starts threads, so call it
    after the ingest pool has forked."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def partition_files(files: list, process_id: int, num_processes: int) -> list:
    """Contiguous partition of the input file list for one host.

    Contiguous (not round-robin) so each shard's FASTA is a contiguous run
    of the global input order and the merge is a simple concatenation.
    """
    n = len(files)
    per = (n + num_processes - 1) // num_processes
    return files[process_id * per : (process_id + 1) * per]


def shard_output_path(output: str, process_id: int, num_processes: int) -> str:
    if num_processes <= 1:
        return output
    base = output or "out.fa"
    return f"{base}.shard{process_id:04d}"


def remove_stale_shard(output: str, process_id: int,
                       num_processes: int) -> None:
    """Unlink this host's shard path at run start.

    The coordinator-less merge treats shard existence as completeness, so
    a shard left by a previous failed run must not be mistakable for this
    run's output: each host clears its own target before doing any work
    (a host that crashes mid-run then leaves no shard, and the merge
    fails loudly instead of silently concatenating stale basecalls).
    A host that never launches at all still leaves its old shard behind —
    use --coordinator (barrier'd runs) when that matters."""
    path = shard_output_path(output, process_id, num_processes)
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def merge_shards(output: str, num_processes: int, cleanup: bool = True) -> None:
    """Concatenate shard FASTAs into the final output (host 0 only).

    A missing shard raises rather than silently truncating the merged
    output — a host that produced no shard means the run is incomplete
    (empty inputs still write an empty shard file)."""
    shards = [
        shard_output_path(output, pid, num_processes)
        for pid in range(num_processes)
    ]
    missing = [s for s in shards if not os.path.exists(s)]
    if missing:
        raise FileNotFoundError(
            f"cannot merge {output}: missing shard(s) {missing} — did every "
            f"host finish its run?"
        )
    # write-then-rename, shards deleted only after the rename: an IO
    # failure mid-merge must neither destroy shards that were already
    # copied nor leave a truncated file under the final name
    tmp = output + ".tmp"
    try:
        with open(tmp, "wb") as out:
            for shard in shards:
                with open(shard, "rb") as fh:
                    shutil.copyfileobj(fh, out)  # constant memory per shard
        os.replace(tmp, output)
    except BaseException:
        # a failed merge must not leave a partial .tmp behind — shards
        # stay, the tmp goes, the caller retries
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if cleanup:
        for shard in shards:
            os.remove(shard)


def barrier() -> None:
    """Cross-host synchronization point: every host has written its
    shards."""
    dist.barrier()
