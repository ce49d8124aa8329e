"""The port's decode under a loaded transition table (`-s/--trans`) against
nanocall_tpu, on the CPU, through both CLIs (the trained runs:
tests/test_torch_pipeline_trans_trained.py).

The fixture is tests/test_torch_pipeline.py's: two 1D reads and one
2-strand (hairpin) read simulated from the builtin r73 models (seed 123).
The table is what `compute-state-transitions --fast -t 0.14 -k 0.21`
writes: the 21-neighbour table of kinetics that are not the CLI priors
(0.1, 0.3), as tests/test_reference_pipeline_golden.py's --trans tests use,
so a task decoded under the wrong table would show in the FASTA.

  - `-s trans.tsv --no-train`: every task is at the priors and decodes
    under the loaded table (K6a, K6b): FASTA and stats byte-equal;
  - `--resume-stats` with one read's transition params put back to the
    priors and the others trained: the decode mixes chunks under the loaded
    table and grouped chunks; FASTA byte-equal.
"""

import functools
import os

import numpy as np
import pytest

from nanocall_tpu import fast5_io, simulate, tools
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch import convert
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.ops import hmm
from torch_helpers import one_torch_thread  # noqa: F401

FLAG_SETS = {
    "1d": ("--1d",),
    "two_strand_joint": ("--double-strand-scaling",),
    "two_strand_per_strand": (),
}
P_STAY, P_SKIP = "0.14", "0.21"


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """(reads dir, the loaded table's TSV path)."""
    d = tmp_path_factory.mktemp("fast5")
    models = load_builtin_models("r73")
    rng = np.random.default_rng(123)
    for name, comp, n in (("read_t0", None, 400), ("read_t1", None, 400),
                          ("read_2d", "r73.c.p1.006", 600)):
        mean, stdv, start, length, _ = simulate.simulate_read(
            models, "r73.t.006", comp, n, rng, noise_scale=0.5)
        fast5_io.write_fast5(str(d / f"{name}.fast5"), mean, stdv, start,
                             length, sampling_rate=4000.0, read_id=name)
    trans = str(tmp_path_factory.mktemp("trans") / "trans.tsv")
    assert tools.main(["compute-state-transitions", "--fast", "-t", P_STAY,
                       "-k", P_SKIP, "-o", trans]) == 0
    return str(d), trans


@functools.lru_cache(maxsize=None)
def _run(main, d, trans, flags, out_dir):
    out = os.path.join(out_dir, f"{main.__module__}.trans."
                       f"{'_'.join(flags) or 'default'}")
    rc = main([d, "--no-train", "--pore", "r73", "-t", "1", "-s", trans,
               "-o", out + ".fa", "--stats", out + ".tsv", *flags])
    assert rc == 0
    with open(out + ".fa") as fa, open(out + ".tsv") as st:
        return fa.read(), st.read()


def _torch_cpu_main(argv):
    return torch_main(argv + ["--device", "cpu"])


def _both(sim, tmp_path_factory, key):
    out_dir = str(tmp_path_factory.getbasetemp())
    return (_run(jax_main, *sim, FLAG_SETS[key], out_dir),
            _run(_torch_cpu_main, *sim, FLAG_SETS[key], out_dir))


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_trans_fasta_byte_equal_to_jax(sim, tmp_path_factory, key):
    (jax_fa, _), (torch_fa, _) = _both(sim, tmp_path_factory, key)
    assert jax_fa.count(">") >= 3
    assert torch_fa == jax_fa


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_trans_stats_byte_equal_to_jax(sim, tmp_path_factory, key):
    (_, jax_st), (_, torch_st) = _both(sim, tmp_path_factory, key)
    assert len(torch_st.splitlines()) == 4
    assert torch_st == jax_st


def test_loaded_table_changes_the_decode(sim, tmp_path_factory):
    """The loaded table's kinetics differ from the priors', so the decode
    under it differs from the default decode: the byte-equality above
    pins the routing of the tasks at the priors to the loaded table."""
    out_dir = str(tmp_path_factory.getbasetemp())
    (trans_fa, _), _ = _both(sim, tmp_path_factory, "two_strand_per_strand")
    out = os.path.join(out_dir, "torch.default")
    assert _torch_cpu_main([sim[0], "--no-train", "--pore", "r73", "-t", "1",
                            "-o", out + ".fa"]) == 0
    with open(out + ".fa") as fh:
        default_fa = fh.read()
    assert default_fa.count(">") == trans_fa.count(">")
    assert default_fa != trans_fa


def test_write_fast_transitions_writes_the_tools_table(sim, tmp_path):
    """convert.write_fast_transitions (the table the GPU smoke loads) is
    `compute-state-transitions --fast`'s TSV, byte for byte."""
    path = tmp_path / "t.tsv"
    convert.write_fast_transitions(str(path), float(P_STAY), float(P_SKIP))
    with open(sim[1]) as fh:
        assert path.read_text() == fh.read()


def _mixed_stats(stats: str) -> str:
    """Stats of a trained run with read_t0's transition params put back to
    the CLI priors, so its task decodes under the loaded table while the
    other reads' tasks decode by the grouped tables."""
    lines = stats.splitlines()
    header = lines[0].split("\t")
    cols = [header.index(c) for c in ("n0_p_stay", "n0_p_skip")]
    out = [lines[0]]
    n_changed = 0
    for line in lines[1:]:
        f = line.split("\t")
        if f[header.index("read_name")] == "read_t0":
            assert (f[cols[0]], f[cols[1]]) != ("0.10000", "0.30000")
            f[cols[0]], f[cols[1]] = "0.10000", "0.30000"
            n_changed += 1
        out.append("\t".join(f))
    assert n_changed == 1
    return "\n".join(out) + "\n"


def test_resume_stats_mixed_decode_byte_equal_to_jax(sim, tmp_path,
                                                     monkeypatch):
    """--resume-stats under a loaded table: a task at the priors decodes
    under the table, a trained one by the grouped tables, in the same run;
    FASTA byte-equal."""
    chunks = {"loaded": 0, "grouped": 0}

    def counted(kind, fn):
        def call(*args, **kw):
            chunks[kind] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(hmm, "viterbi_decode",
                        counted("loaded", hmm.viterbi_decode))
    monkeypatch.setattr(hmm, "viterbi_decode_grouped",
                        counted("grouped", hmm.viterbi_decode_grouped))
    d, trans = sim
    stats = tmp_path / "trained.tsv"
    assert jax_main([d, "--pore", "r73", "-t", "1", "--1d",
                     "--scaling-max-rounds", "1", "-o",
                     str(tmp_path / "t.fa"), "--stats", str(stats)]) == 0
    mixed = tmp_path / "mixed.tsv"
    mixed.write_text(_mixed_stats(stats.read_text()))
    outs = []
    for main, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        out = tmp_path / f"{len(outs)}.fa"
        assert main([d, "--pore", "r73", "-t", "1", "--1d", "-s", trans,
                     "-o", str(out), "--resume-stats", str(mixed),
                     *extra]) == 0
        outs.append(out.read_text())
    assert outs[0].count(">") == 3
    assert outs[1] == outs[0]
    assert chunks["loaded"] >= 1 and chunks["grouped"] >= 1, chunks
