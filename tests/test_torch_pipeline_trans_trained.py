"""The port's trained pipeline under a loaded transition table (`-s`)
against nanocall_tpu, on the CPU, through both CLIs.

Fixture and table as tests/test_torch_pipeline_trans.py's: two 1D reads
and one hairpin read (seed 123), and the 21-neighbour table of p_stay 0.14,
p_skip 0.21, kinetics that are not the CLI priors.  Training runs the
legacy EM rounds (the E-step under the loaded table for rows at the
priors, K6c; by the grouped tables otherwise, K4 + K6d).  The contracts
are tests/test_torch_pipeline_trained.py's:

  1. `--no-train-transitions` at fixed rounds (--scaling-min-progress 0
     --scaling-max-rounds 2): the transition params stay at the priors,
     so every round E-steps under the loaded table and every task decodes
     under it (tests/test_reference_pipeline_golden.py::
     test_trans_file_with_training_fasta_identical's case).  FASTA
     byte-equal on --1d and with joint scaling (the 2-strand default);
     stats within rtol 2e-3.
  2. transitions trained, free stopping (the default flags): round 1
     E-steps every row under the loaded table, later rounds by the grouped
     tables, and the trained tasks decode by them; stats within 2e-2 and
     each record's identity to the JAX record above 0.97.

The rounds are few because each plain E-step under the table loops over
the 21 slots of 4096 states on the CPU.
"""

import functools
import os

import numpy as np
import pytest

from nanocall_tpu import fast5_io, simulate, tools
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch.cli import main as torch_main
from test_torch_pipeline_trained import _assert_identity, \
    _assert_stats_close
from torch_helpers import one_torch_thread  # noqa: F401

FIXED = ("--no-train-transitions", "--scaling-min-progress", "0",
         "--scaling-max-rounds", "2")
FLAG_SETS = {"1d": ("--1d",), "joint": ("--double-strand-scaling",)}


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
    assert tools.main(["compute-state-transitions", "--fast", "-t", "0.14",
                       "-k", "0.21", "-o", trans]) == 0
    return str(d), trans


@functools.lru_cache(maxsize=None)
def _run(main, d, trans, flags, out_dir):
    out = os.path.join(out_dir, f"{main.__module__}.trans."
                       f"{'_'.join(flags) or 'default'}")
    rc = main([d, "--pore", "r73", "-t", "1", "-s", trans, "-o",
               out + ".fa", "--stats", out + ".tsv", *flags])
    assert rc == 0
    with open(out + ".fa") as fa, open(out + ".tsv") as st:
        return fa.read(), st.read()


def _torch_cpu_main(argv):
    return torch_main(argv + ["--device", "cpu"])


def _both(sim, tmp_path_factory, flags):
    out_dir = str(tmp_path_factory.getbasetemp())
    return (_run(jax_main, *sim, flags, out_dir),
            _run(_torch_cpu_main, *sim, flags, out_dir))


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_fixed_rounds_fasta_matches_jax(sim, tmp_path_factory, key):
    (jax_fa, _), (torch_fa, _) = _both(sim, tmp_path_factory,
                                       FLAG_SETS[key] + FIXED)
    assert jax_fa.count(">") == (3 if key == "1d" else 4)
    assert torch_fa == jax_fa


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_fixed_rounds_stats_match_jax(sim, tmp_path_factory, key):
    (_, jax_st), (_, torch_st) = _both(sim, tmp_path_factory,
                                       FLAG_SETS[key] + FIXED)
    _assert_stats_close(jax_st, torch_st, rtol=2e-3)
    # the transition params stayed at the priors
    for line in torch_st.splitlines()[1:]:
        f = line.split("\t")
        assert f[15:17] == ["0.10000", "0.30000"], f


def test_trained_transitions_match_jax(sim, tmp_path_factory):
    (jax_fa, jax_st), (torch_fa, torch_st) = _both(sim, tmp_path_factory,
                                                   ())
    _assert_identity(jax_fa, torch_fa, 0.97)
    _assert_stats_close(jax_st, torch_st, rtol=2e-2)
    # training moved the transition params off the priors
    rows = [line.split("\t") for line in torch_st.splitlines()[1:]]
    assert all(r[15:17] != ["0.10000", "0.30000"] for r in rows)
