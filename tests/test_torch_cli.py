"""The port's CLI against nanocall_tpu's on the paths no other test runs
through both: the resolved-option echo lines, `--write-fast5`, user pore
models (`-m` and `--model-fofn`) and `--no-basecall`, on the CPU.

The fixture is one 1D read of 300 events and one hairpin read of 450 + 450
events, simulated from the builtin r73 models; each test runs both CLIs on
copies of it.  The fast5 files need h5py, so these tests run on the CPU
only.
"""

import logging
import shutil

import h5py
import numpy as np
import pytest

from nanocall_tpu import simulate
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch import pore_model
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.models import load_builtin_models as \
    torch_builtin_models
from torch_helpers import one_torch_thread  # noqa: F401

#: the echo lines after `args:` that the JAX CLI writes, by flag set
ECHO_FLAGS = {
    "trained": (),
    "no_train": ("--no-train",),
    "no_train_scaling": ("--no-train-scaling",),
    "trained_1d_drift": ("--1d", "--train-drift", "1",
                         "--single-strand-scaling", "--scaling-max-rounds",
                         "3", "--scaling-min-progress", "0.5"),
    "no_train_transitions": ("--no-train-transitions", "--no-basecall"),
}
#: a trained run whose rounds do not depend on float rounding
FIXED_ROUNDS = ("--scaling-max-rounds", "1", "--scaling-min-progress", "0")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_reads")
    models = load_builtin_models("r73")
    rng = np.random.default_rng(61)
    for name, comp, n in (("t0", None, 300), ("d0", "r73.c.p1.006", 450)):
        simulate.write_sim_fast5(str(d / f"{name}.fast5"), models,
                                 "r73.t.006", comp, n, rng, read_id=name,
                                 noise_scale=0.5)
    return d


def _torch_cpu_main(argv):
    return torch_main([*argv, "--device", "cpu"])


def _echo(caplog, main, argv) -> list:
    """The `nanocall` logger's INFO lines of one CLI call, up to and with
    `basecall=`."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="nanocall"):
        try:
            main(argv)
        except SystemExit:
            pass
    lines = [r.getMessage() for r in caplog.records if r.name == "nanocall"]
    end = next(i for i, ln in enumerate(lines) if ln.startswith("basecall="))
    return lines[:end + 1]


@pytest.mark.parametrize("key", sorted(ECHO_FLAGS))
def test_echo_lines_equal_to_jax(caplog, tmp_path, key):
    """Both CLIs' resolved-option lines (nanocall.cpp:1060-1078) under the
    same flags, on a directory with no fast5 file (the run stops after the
    echo): equal but for the program's name in `program:` and `args:` and
    the port's `device=` line."""
    argv = [str(tmp_path), "--pore", "r73", "-t", "1", *ECHO_FLAGS[key]]
    want = _echo(caplog, jax_main, argv)
    got = _echo(caplog, _torch_cpu_main, argv)
    assert want[0] == "program: nanocall-tpu"
    assert got[0] == "program: nanocall-tpu-torch"
    assert got[2] == "args: nanocall-tpu-torch " + " ".join(
        [*argv, "--device", "cpu"])
    assert "device=cpu" in got
    assert [ln for ln in got[3:] if ln != "device=cpu"] == want[3:]
    assert got[1] == want[1]
    trained = "--no-train" not in ECHO_FLAGS[key]
    scaling = trained and "--no-train-scaling" not in ECHO_FLAGS[key]
    assert any(ln.startswith("train_transitions=") for ln in got) == trained
    assert any(ln.startswith("scaling_max_rounds=") for ln in got) == scaling


def _nanocall_groups(path) -> dict:
    """{path in the file: (attributes, data or None)} of every object under
    /Analyses/Nanocall_000."""
    out = {}
    with h5py.File(path, "r") as f:
        grp = f["/Analyses/Nanocall_000"]

        def visit(name, obj):
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = ({k: obj.attrs[k] for k in obj.attrs}, data)

        grp.visititems(visit)
        out["."] = ({k: grp.attrs[k] for k in grp.attrs}, None)
    return out


def test_write_fast5_equal_to_jax(reads, tmp_path):
    """`--write-fast5`, untrained: the Nanocall_000 group each CLI writes
    into its copy of every read, dataset by dataset (seq, the event table
    of path and moves, the model table) and attribute by attribute (the
    scaling parameters)."""
    dirs = {}
    for main, name in ((jax_main, "jax"), (_torch_cpu_main, "torch")):
        dirs[name] = tmp_path / name
        shutil.copytree(reads, dirs[name])
        assert main([str(dirs[name]), "--pore", "r73", "--no-train", "-t",
                     "1", "--write-fast5"]) == 0
    files = sorted(p.name for p in reads.glob("*.fast5"))
    n_strands = 0
    for f in files:
        with h5py.File(dirs["jax"] / f, "r") as a, \
                h5py.File(dirs["torch"] / f, "r") as b:
            assert sorted(b["/Analyses"]) == sorted(a["/Analyses"])
        want = _nanocall_groups(dirs["jax"] / f)
        got = _nanocall_groups(dirs["torch"] / f)
        assert sorted(got) == sorted(want), f
        for name, (attrs, data) in want.items():
            assert got[name][0].keys() == attrs.keys(), (f, name)
            for k, v in attrs.items():
                assert np.array_equal(got[name][0][k], v), (f, name, k)
            if data is not None:
                assert got[name][1].dtype == data.dtype, (f, name)
                assert np.array_equal(got[name][1], data), (f, name)
        n_strands += sum(name.endswith("/Events") for name in want)
    assert n_strands == 3  # the 1D read's strand and the hairpin's two


@pytest.fixture(scope="module")
def model_tsvs(tmp_path_factory):
    """The builtin r73 template and complement models as TSVs written by
    the port's pore_model.save_tsv, and a fofn naming them."""
    d = tmp_path_factory.mktemp("models")
    models = torch_builtin_models("r73")
    specs = []
    for strand, name in ((0, "r73.t.006"), (1, "r73.c.p1.006")):
        pore_model.save_tsv(models[name], d / f"{name}.tsv")
        specs.append(f"{strand}:{d / f'{name}.tsv'}")
    (d / "models.fofn").write_text("\n".join(specs) + "\n")
    return specs, d / "models.fofn"


def _fasta_and_stats(main, argv, out):
    assert main([*argv, "-o", f"{out}.fa", "--stats", f"{out}.tsv"]) == 0
    with open(f"{out}.fa") as fa, open(f"{out}.tsv") as st:
        return fa.read(), st.read()


@pytest.mark.parametrize("how", ["m", "model_fofn"])
def test_user_models_equal_to_jax(reads, model_tsvs, tmp_path, how):
    """`-m 0:<t.tsv> -m 1:<c.tsv>`, and the same list through
    `--model-fofn`, untrained: FASTA and stats byte-equal to the JAX
    CLI's."""
    specs, fofn = model_tsvs
    flags = ([a for s in specs for a in ("-m", s)] if how == "m"
             else ["--model-fofn", str(fofn)])
    argv = [str(reads), "--pore", "r73", "--no-train", "-t", "1", *flags]
    want = _fasta_and_stats(jax_main, argv, tmp_path / "jax")
    got = _fasta_and_stats(_torch_cpu_main, argv, tmp_path / "torch")
    assert want[0].count(">") == 3
    assert specs[0][2:] in want[1]  # the user model names the candidates
    assert got == want


def _assert_stats_close(want: str, got: str) -> None:
    """The trained stats' tolerance of tests/test_torch_pipeline_trained.py
    at fixed rounds: names equal, numbers within rtol 2e-3 (atol 2e-2)."""
    want = [ln.split("\t") for ln in want.strip().splitlines()]
    got = [ln.split("\t") for ln in got.strip().splitlines()]
    assert got[0] == want[0] and len(got) == len(want) == 3
    for w_row, g_row in zip(want[1:], got[1:]):
        for col, w, g in zip(want[0], w_row, g_row):
            try:
                wf = float(w)
            except ValueError:
                assert g == w, col
                continue
            assert np.isclose(float(g), wf, rtol=2e-3, atol=2e-2), (col, g, w)


@pytest.mark.parametrize("train", [True, False], ids=["trained", "no_train"])
def test_no_basecall_equal_to_jax(reads, tmp_path, caplog, train):
    """`--no-basecall`: no FASTA is written, and no model contest runs (a
    read that training did not settle keeps "." for its model in the
    stats).  Untrained, the two CLIs' stats are byte-equal.  Trained at
    fixed rounds they agree within the trained pipeline's tolerance, not
    bit for bit: the WLS solve amplifies the moments' float32 summation
    order about 1e3-fold (t0's shift is 0.94002 in the JAX CLI's stats,
    0.93927 in the port's, with the decode or without it).  The echo lines
    are equal."""
    argv = [str(reads), "--pore", "r73", "-t", "1",
            *(FIXED_ROUNDS if train else ["--no-train"])]
    stats, echoes = [], []
    for main, name in ((jax_main, "jax"), (_torch_cpu_main, "torch")):
        out = tmp_path / name
        echoes.append(_echo(caplog, main, [*argv, "--no-basecall", "-o",
                                           f"{out}.fa", "--stats",
                                           f"{out}.tsv"]))
        assert not (tmp_path / f"{name}.fa").exists()
        stats.append((tmp_path / f"{name}.tsv").read_text())
    assert stats[0].count("\n") == 3
    if train:
        _assert_stats_close(stats[0], stats[1])
    else:
        assert stats[1] == stats[0]
    assert [ln for ln in echoes[1][3:] if ln != "device=cpu"] == \
        echoes[0][3:]
    assert ("train_transitions=1" in echoes[1]) == train
