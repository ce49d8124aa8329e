"""The port's untrained decode pipeline against nanocall_tpu, on the CPU
(the trained pipeline: tests/test_torch_pipeline_trained.py).

The fixture follows tests/test_pipeline.py: two 1D reads and one 2-strand
(hairpin) read simulated from the builtin r73 models.  Both CLIs run with
the same flags and must write byte-identical FASTA and stats.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

from nanocall_tpu import fast5_io, ingest as jingest, \
    read_pipeline as jread_pipeline, simulate
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.config import Config as JConfig
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch import basecall, ingest, models as tmodels_mod, \
    read_pipeline
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.config import Config
from torch_helpers import one_torch_thread  # noqa: F401

FLAG_SETS = {
    "1d": ("--1d",),
    "two_strand_joint": ("--double-strand-scaling",),
    "two_strand_per_strand": (),
}


@pytest.fixture(scope="module")
def models():
    return load_builtin_models("r73")


@pytest.fixture(scope="module")
def tmodels():
    """The port's own builtin models."""
    return tmodels_mod.load_builtin_models("r73")


@pytest.fixture(scope="module")
def sim(tmp_path_factory, models):
    """Reads as fast5 files, and the same reads as in-memory arrays."""
    d = tmp_path_factory.mktemp("fast5")
    rng = np.random.default_rng(123)
    arrays, truths = {}, {}
    for name, comp, n in (("read_t0", None, 400), ("read_t1", None, 400),
                          ("read_2d", "r73.c.p1.006", 600)):
        mean, stdv, start, length, truth = simulate.simulate_read(
            models, "r73.t.006", comp, n, rng, noise_scale=0.5)
        fast5_io.write_fast5(str(d / f"{name}.fast5"), mean, stdv, start,
                             length, sampling_rate=4000.0, read_id=name)
        arrays[name] = (mean, stdv, start, length)
        truths[name] = truth
    return d, arrays, truths


@functools.lru_cache(maxsize=None)
def _run(main, d, flags, out_dir):
    out = f"{out_dir}/{main.__module__}.{main.__name__}." \
        f"{'_'.join(flags) or 'default'}"
    rc = main([d, "--no-train", "--pore", "r73", "-t", "1", "-o", out + ".fa",
               "--stats", out + ".tsv", *flags])
    assert rc == 0
    with open(out + ".fa") as fa, open(out + ".tsv") as st:
        return fa.read(), st.read()


def _torch_cpu_main(argv):
    return torch_main(argv + ["--device", "cpu"])


def _both(sim, tmp_path_factory, key):
    d = str(sim[0])
    out_dir = str(tmp_path_factory.getbasetemp())
    return (_run(jax_main, d, FLAG_SETS[key], out_dir),
            _run(_torch_cpu_main, d, FLAG_SETS[key], out_dir))


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_fasta_byte_equal_to_jax(sim, tmp_path_factory, key):
    (jax_fa, _), (torch_fa, _) = _both(sim, tmp_path_factory, key)
    assert jax_fa.count(">") >= 3
    assert torch_fa == jax_fa


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_stats_equal_to_jax(sim, tmp_path_factory, key):
    (_, jax_st), (_, torch_st) = _both(sim, tmp_path_factory, key)
    assert len(torch_st.splitlines()) == 4
    assert torch_st == jax_st


def test_resume_stats_decode_equal_to_jax(sim, tmp_path):
    """--resume-stats decodes from recorded parameters without training."""
    d = str(sim[0])
    stats = tmp_path / "s.tsv"
    assert jax_main([d, "--no-train", "--pore", "r73", "-t", "1", "-o",
                     str(tmp_path / "a.fa"), "--stats", str(stats)]) == 0
    outs = []
    for main, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        out = tmp_path / f"{len(outs)}.fa"
        assert main([d, "--pore", "r73", "-t", "1", "-o", str(out),
                     "--resume-stats", str(stats), *extra]) == 0
        outs.append(out.read_text())
    assert outs[0].count(">") >= 3
    assert outs[1] == outs[0]


def _assert_same_summary(got, want, name):
    """A port summary and its events against the JAX package's: equal
    fields, strand bounds and event arrays."""
    (got_s, got_evs), (want_s, want_evs) = got, want
    assert dataclasses.asdict(got_s) == dataclasses.asdict(want_s), name
    assert len(got_evs) == len(want_evs), name
    for a, b in zip(got_evs, want_evs):
        for f in ("mean", "stdv", "start", "length"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)


@pytest.mark.parametrize("double", [False, True])
def test_summarize_ed_matches_fast5_summarize(sim, models, tmodels, double):
    """The port's summarize_ed on in-memory arrays against the JAX
    package's summarize of the same read's fast5 file."""
    d, arrays, _ = sim
    jcfg = JConfig(pore="r73", train=False,
                   double_strand_scaling=double).apply_pore_preset()
    cfg = Config(pore="r73", train=False,
                 double_strand_scaling=double).apply_pore_preset()
    for name, (mean, stdv, start, length) in arrays.items():
        path = str(d / f"{name}.fast5")
        want = jread_pipeline.summarize(path, models, jcfg,
                                        return_events=True)
        ed = ingest.ed_from_arrays(mean, stdv, start, length, 4000.0, name)
        got = read_pipeline.summarize_ed(path, ed, tmodels, cfg)
        _assert_same_summary(got, want, name)


def test_array_stream_pipeline_matches_fast5_stream(sim, models, tmodels):
    """The in-memory stream (the route for machines without h5py) gives the
    summaries and events of the JAX package's ingest_stream over the files,
    and run_pipeline the same results from it as from the port's
    ingest_stream, with identity to the simulated template above 0.6."""
    d, arrays, truths = sim
    jcfg = JConfig(pore="r73", train=False,
                   ingest_workers=1).apply_pore_preset()
    cfg = Config(pore="r73", train=False, ingest_workers=1).apply_pore_preset()
    files = read_pipeline.init_files([str(d)])
    names = [os.path.basename(f)[: -len(".fast5")] for f in files]
    stream = [read_pipeline.summarize_ed(
        f, ingest.ed_from_arrays(*arrays[name], 4000.0, name), tmodels, cfg)
        for f, name in zip(files, names)]
    jstream = list(jingest.ingest_stream(files, models, jcfg))
    assert len(jstream) == len(stream) == 3
    for got, want, name in zip(stream, jstream, names):
        _assert_same_summary(got, want, name)
    _, want = basecall.run_pipeline(ingest.ingest_stream(files, tmodels, cfg),
                                    tmodels, cfg, "cpu")
    summaries, got = basecall.run_pipeline(iter(stream), tmodels, cfg, "cpu")
    assert len(summaries) == 3
    assert [(r.seq_name, r.base_seq, r.logp) for r in got] == \
        [(r.seq_name, r.base_seq, r.logp) for r in want]
    t0 = [r for r in got if r.seq_name.startswith("read_t0:")]
    assert len(t0) == 1
    assert simulate.identity(t0[0].base_seq,
                             truths["read_t0"].base_seqs[0]) > 0.6


def test_decode_tasks_match_jax_winners(sim, models, tmodels):
    """Task level: the port's build_decode_tasks + run_decode_tasks pick the
    same winners with the same paths as nanocall_tpu.basecall's."""
    from nanocall_tpu import basecall as jbasecall

    d = sim[0]
    jcfg = JConfig(pore="r73", train=False).apply_pore_preset()
    cfg = Config(pore="r73", train=False).apply_pore_preset()
    files = read_pipeline.init_files([str(d)])
    jsums = [jread_pipeline.summarize(f, models, jcfg) for f in files]
    tsums = [read_pipeline.summarize(f, tmodels, cfg) for f in files]
    jtasks, _ = jbasecall.build_decode_tasks(jsums, models, jcfg)
    want = jbasecall.run_decode_tasks(jtasks, jsums, models, jcfg)
    pool = basecall.EventPool("cpu")
    ttasks = basecall.build_decode_tasks(tsums, cfg, pool)
    assert len(ttasks) == len(jtasks) > len(want)  # contests were scored
    got = basecall.run_decode_tasks(ttasks, tsums, tmodels, cfg, pool)

    def key(t):
        return (t.read_idx, t.strand, t.key)

    assert sorted(map(key, got)) == sorted(map(key, want))
    want_by = {key(t): t for t in want}
    for t in got:
        w = want_by[key(t)]
        assert np.array_equal(t.path, w.path), key(t)
        assert np.isclose(t.logp, w.logp, rtol=1e-5), key(t)
