"""Multi-host runs of the port (nanocall_tpu_torch.parallel.multihost and
the CLI's --num-hosts/--host-id/--coordinator), on the CPU.

Every case of tests/test_multihost.py on the port's functions, a two-host
emulation of the port CLI whose merged FASTA is byte-equal to the JAX
CLI's single-host run, and a --coordinator run: two port CLI processes
joined in a gloo process group on 127.0.0.1, each with a time limit.
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from nanocall_tpu import simulate
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.parallel import multihost
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FLAGS = ("--pore", "r73", "--device", "cpu", "-t", "1")


def _reads(d, seed: int, n: int, n_events: int):
    d.mkdir()
    models = load_builtin_models("r73")
    rng = np.random.default_rng(seed)
    for i in range(n):
        simulate.write_sim_fast5(d / f"r{i}.fast5", models, "r73.t.006", None,
                                 n_events, rng, read_id=f"r{i}",
                                 noise_scale=0.5)
    return d


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Four 1D reads of 200 events, and the JAX CLI's untrained FASTA of
    them on one host."""
    d = _reads(tmp_path_factory.mktemp("mh") / "reads", 1, 4, 200)
    single = d.parent / "jax_single.fa"
    assert jax_main([str(d), "--pore", "r73", "-t", "1", "-o", str(single),
                     "--no-train", "--1d"]) == 0
    return d, single.read_text()


def test_partition_contiguous_and_complete():
    files = [f"f{i}" for i in range(10)]
    parts = [multihost.partition_files(files, p, 3) for p in range(3)]
    assert sum(parts, []) == files  # contiguous + order-preserving
    assert all(len(p) <= 4 for p in parts)


def test_partition_more_hosts_than_files():
    files = ["a", "b"]
    parts = [multihost.partition_files(files, p, 4) for p in range(4)]
    assert sum(parts, []) == files


def test_shard_paths_and_merge(tmp_path):
    out = str(tmp_path / "out.fa")
    for pid in range(3):
        p = multihost.shard_output_path(out, pid, 3)
        assert p.endswith(f".shard{pid:04d}")
        with open(p, "w") as fh:
            fh.write(f">r{pid}\nACGT\n")
    multihost.merge_shards(out, 3)
    assert open(out).read() == ">r0\nACGT\n>r1\nACGT\n>r2\nACGT\n"
    assert not os.path.exists(multihost.shard_output_path(out, 0, 3))


def test_single_host_passthrough():
    assert multihost.shard_output_path("x.fa", 0, 1) == "x.fa"


def test_merge_missing_shard_raises(tmp_path):
    """A missing shard means an unfinished host: the merge fails loudly."""
    out = tmp_path / "out.fa"
    p0 = multihost.shard_output_path(str(out), 0, 2)
    open(p0, "w").write(">a\nACGT\n")
    with pytest.raises(FileNotFoundError, match="shard"):
        multihost.merge_shards(str(out), 2)
    assert not out.exists() and open(p0).read()  # shard 0 not consumed


def test_merge_is_atomic_and_preserves_shards_on_failure(tmp_path,
                                                         monkeypatch):
    """An IO failure mid-merge leaves neither a partial output nor a .tmp,
    and every shard, so a second merge succeeds."""
    out = str(tmp_path / "out.fa")
    for pid in range(2):
        open(multihost.shard_output_path(out, pid, 2), "w").write(
            f">r{pid}\nACGT\n")
    calls = {"n": 0}
    real = shutil.copyfileobj

    def failing_copy(src, dst):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        return real(src, dst)

    monkeypatch.setattr(shutil, "copyfileobj", failing_copy)
    with pytest.raises(OSError):
        multihost.merge_shards(out, 2)
    assert not os.path.exists(out) and not os.path.exists(out + ".tmp")
    monkeypatch.undo()
    multihost.merge_shards(out, 2)
    assert open(out).read() == ">r0\nACGT\n>r1\nACGT\n"
    assert not os.path.exists(out + ".tmp")


def test_remove_stale_shard(tmp_path):
    out = str(tmp_path / "out.fa")
    p1 = multihost.shard_output_path(out, 1, 2)
    open(p1, "w").write(">stale\nAAAA\n")
    multihost.remove_stale_shard(out, 1, 2)
    assert not os.path.exists(p1)
    multihost.remove_stale_shard(out, 1, 2)  # idempotent on absence


def test_two_host_cli_emulation_byte_equal_to_jax(reads, tmp_path):
    """Two port CLI runs with --num-hosts 2 (no coordinator: no process
    group), host 1 then host 0, which merges: the merged FASTA equals the
    JAX CLI's single-host run byte for byte, and so does a stale shard
    left before the run (each host removes its own first)."""
    d, want = reads
    out = tmp_path / "multi.fa"
    open(multihost.shard_output_path(str(out), 1, 2), "w").write(">stale\n")
    for host in (1, 0):
        assert torch_main([str(d), *PORT_FLAGS, "-o", str(out), "--no-train",
                           "--1d", "--num-hosts", "2", "--host-id",
                           str(host)]) == 0
    assert out.read_text() == want
    assert not list(tmp_path.glob("multi.fa.shard*"))


def test_multihost_stats_shards_and_resume(tmp_path):
    """A trained 2-host run writes a stats shard per host over disjoint
    halves of the reads; each host's decode-only resume from its own shard
    reproduces the trained run's merged FASTA."""
    d = _reads(tmp_path / "reads", 3, 4, 250)
    out, stats = tmp_path / "multi.fa", tmp_path / "stats.tsv"
    common = [str(d), *PORT_FLAGS, "--1d", "--scaling-max-rounds", "1",
              "-o", str(out), "--stats", str(stats), "--num-hosts", "2"]
    for host in (1, 0):
        assert torch_main([*common, "--host-id", str(host)]) == 0
    merged = out.read_text()
    assert merged.count(">") == 4
    shard_rows = []
    for host in (0, 1):
        rows = open(multihost.shard_output_path(str(stats), host, 2)).read()
        rows = rows.strip().splitlines()
        assert rows[0].startswith("file_name")
        shard_rows.append({r.split("\t")[1] for r in rows[1:]})
    assert shard_rows[0].isdisjoint(shard_rows[1])
    assert shard_rows[0] | shard_rows[1] == {f"r{i}" for i in range(4)}
    re_out = tmp_path / "re.fa"
    for host in (1, 0):
        sp = multihost.shard_output_path(str(stats), host, 2)
        assert torch_main([str(d), *PORT_FLAGS, "--1d", "-o", str(re_out),
                           "--resume-stats", sp, "--num-hosts", "2",
                           "--host-id", str(host)]) == 0
    assert re_out.read_text() == merged


def test_multihost_no_basecall_does_not_merge(tmp_path):
    """A training-only run writes no FASTA shards, so host 0 merges
    nothing; each host writes its stats shard."""
    d = _reads(tmp_path / "reads", 4, 2, 250)
    stats = tmp_path / "stats.tsv"
    common = [str(d), *PORT_FLAGS, "--1d", "--no-basecall",
              "--scaling-max-rounds", "1", "--stats", str(stats),
              "--num-hosts", "2"]
    for host in (1, 0):
        assert torch_main([*common, "--host-id", str(host)]) == 0
    for host in (0, 1):
        assert (tmp_path / f"stats.tsv.shard{host:04d}").exists()
    assert not list(tmp_path.glob("*.fa*"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_run_of_two_processes(reads, tmp_path):
    """Two port CLI processes with --coordinator 127.0.0.1:<free port>:
    they join one gloo group, wait at the barrier, host 0 merges, and the
    merged FASTA equals the JAX CLI's single-host run; both exit 0 within
    their time limit and leave the group."""
    d, want = reads
    out = tmp_path / "coord.fa"
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanocall_tpu_torch", str(d), *PORT_FLAGS,
         "-o", str(out), "--no-train", "--1d", "--num-hosts", "2",
         "--host-id", str(host), "--coordinator", coordinator],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for host in (0, 1)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    assert "merged 2 shards" in results[0][1]
    assert out.read_text() == want
