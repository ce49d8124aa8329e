"""The port's default trained pipeline against nanocall_tpu, on the CPU.

The fixture is tests/test_torch_pipeline.py's: two 1D reads and one
2-strand (hairpin) read simulated from the builtin r73 models (seed 123).
Both CLIs train by EM and decode with the same flags.  The two contracts
are those of tests/test_reference_pipeline_golden.py:560-603:

  1. fixed rounds (--scaling-min-progress 0 --scaling-max-rounds 3): the
     stopping edge is off, so the EM arithmetic itself is compared: FASTA
     byte-equal, every stats number within rtol 2e-3 (atol 2e-2, the
     golden's default for values near 0);
  2. free stopping (the default flags): each record's identity to the JAX
     record above 0.97, stats within 2e-2.

In a trained run the default is joint scaling of both strands
(cfg.double_strand_scaling unless --single-strand-scaling), so the flag
sets are --1d, --double-strand-scaling and --single-strand-scaling.

One fixed-round case is not byte-equal, for the reason the golden's
AMPLIFICATION_FLIP_SEEDS give: the 3x3 weighted-least-squares solve
amplifies the moments' float32 summation error about 1e3-fold into the
scaling parameters (here ~1e-3 after 3 rounds), and a Viterbi decision
inside that margin flips.  With joint scaling the hairpin's complement
strand differs from the JAX record by 2 bases at one site, and the test
holds it to those 2.  test_moment_sums_closer_to_float64_than_jax shows
the cause: against float64 sums, the JAX package's moments carry ~2e-6
relative error, the port's pairwise sums ~2e-7.
"""

import difflib
import functools
import os

import numpy as np
import pytest

from nanocall_tpu import fast5_io, simulate
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch.cli import main as torch_main
from ref_tools import parse_fasta
from torch_helpers import one_torch_thread  # noqa: F401

FIXED = ("--scaling-min-progress", "0", "--scaling-max-rounds", "3")
FLAG_SETS = {
    "1d": ("--1d",),
    "joint": ("--double-strand-scaling",),
    "per_strand": ("--single-strand-scaling",),
}
#: fixed-round flag sets whose FASTA may differ from the JAX package's, and
#: by at most how many bases in all (measured: 2; see the docstring)
AMPLIFICATION_FLIP = {"joint": 2}


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast5")
    models = load_builtin_models("r73")
    rng = np.random.default_rng(123)
    for name, comp, n in (("read_t0", None, 400), ("read_t1", None, 400),
                          ("read_2d", "r73.c.p1.006", 600)):
        mean, stdv, start, length, _ = simulate.simulate_read(
            models, "r73.t.006", comp, n, rng, noise_scale=0.5)
        fast5_io.write_fast5(str(d / f"{name}.fast5"), mean, stdv, start,
                             length, sampling_rate=4000.0, read_id=name)
    return str(d)


@functools.lru_cache(maxsize=None)
def _run(main, d, flags, out_dir):
    out = os.path.join(out_dir, f"{main.__module__}.{'_'.join(flags)}")
    rc = main([d, "--pore", "r73", "-t", "1", "-o", out + ".fa", "--stats",
               out + ".tsv", *flags])
    assert rc == 0
    with open(out + ".fa") as fa, open(out + ".tsv") as st:
        return fa.read(), st.read()


def _torch_cpu_main(argv):
    return torch_main(argv + ["--device", "cpu"])


def _both(reads_dir, tmp_path_factory, flags):
    out_dir = str(tmp_path_factory.getbasetemp())
    return (_run(jax_main, reads_dir, flags, out_dir),
            _run(_torch_cpu_main, reads_dir, flags, out_dir))


def _assert_identity(jax_fa, torch_fa, bound):
    want, got = parse_fasta(jax_fa), parse_fasta(torch_fa)
    assert sorted(got) == sorted(want)
    for k in want:
        assert simulate.identity(got[k], want[k]) > bound, k


def _differing_bases(a: str, b: str) -> int:
    """Bases outside the matching blocks of a and b (difflib): a
    substitution counts 1, an indel its length."""
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops
               if tag != "equal")


def _assert_stats_close(jax_st, torch_st, rtol, atol=2e-2):
    want = [l.split("\t") for l in jax_st.strip().splitlines()]
    got = [l.split("\t") for l in torch_st.strip().splitlines()]
    assert got[0] == want[0] and len(got) == len(want) == 4
    for w_row, g_row in zip(want[1:], got[1:]):
        for col, w, g in zip(want[0], w_row, g_row):
            try:
                wf = float(w)
            except ValueError:
                assert g == w, col  # names
                continue
            assert np.isclose(float(g), wf, rtol=rtol, atol=atol), (col, g, w)


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_fixed_rounds_fasta_matches_jax(reads_dir, tmp_path_factory, key):
    (jax_fa, _), (torch_fa, _) = _both(reads_dir, tmp_path_factory,
                                       FLAG_SETS[key] + FIXED)
    assert jax_fa.count(">") == (3 if key == "1d" else 4)
    if key in AMPLIFICATION_FLIP:
        want, got = parse_fasta(jax_fa), parse_fasta(torch_fa)
        assert list(got) == list(want)
        diff = sum(_differing_bases(got[k], want[k]) for k in want)
        assert diff <= AMPLIFICATION_FLIP[key], diff
    else:
        assert torch_fa == jax_fa


@pytest.mark.parametrize("key", sorted(FLAG_SETS))
def test_fixed_rounds_stats_match_jax(reads_dir, tmp_path_factory, key):
    (_, jax_st), (_, torch_st) = _both(reads_dir, tmp_path_factory,
                                       FLAG_SETS[key] + FIXED)
    _assert_stats_close(jax_st, torch_st, rtol=2e-3)


def test_free_stopping_matches_jax(reads_dir, tmp_path_factory):
    (jax_fa, jax_st), (torch_fa, torch_st) = _both(reads_dir,
                                                   tmp_path_factory, ())
    _assert_identity(jax_fa, torch_fa, 0.97)
    _assert_stats_close(jax_st, torch_st, rtol=2e-2)


def test_trained_params_differ_from_untrained(reads_dir, tmp_path_factory):
    """Training ran: the stats carry EM-fitted parameters, not the initial
    moment-matched ones of a --no-train run."""
    (_, trained), _ = _both(reads_dir, tmp_path_factory, ())
    out_dir = str(tmp_path_factory.getbasetemp())
    _, untrained = _run(_torch_cpu_main, reads_dir, ("--no-train",), out_dir)
    assert trained.splitlines()[0] == untrained.splitlines()[0]
    assert trained.splitlines()[1:] != untrained.splitlines()[1:]


STAGED = {  # Config overrides: 1D, joint and per-strand scaling
    "1d": dict(template_only=True),
    "joint": dict(double_strand_scaling=True),
    "per_strand": dict(double_strand_scaling=False),
}


def _summaries(reads_dir, key, port=False, **kw):
    """(models, Config, read summaries) of the fixture, by the JAX package
    or, with port, by the port's own copies of the host modules."""
    if port:
        from nanocall_tpu_torch import models as models_mod, read_pipeline
        from nanocall_tpu_torch.config import Config
    else:
        from nanocall_tpu import models as models_mod, read_pipeline
        from nanocall_tpu.config import Config

    models = models_mod.load_builtin_models("r73")
    cfg = Config(pore="r73", **STAGED[key], **kw).apply_pore_preset()
    files = read_pipeline.init_files([reads_dir])
    return models, cfg, [read_pipeline.summarize(f, models, cfg)
                         for f in files]


def _port_groups(sums, models, cfg) -> list:
    """The port's training groups of every read, in read order."""
    from nanocall_tpu_torch import basecall

    pool = basecall.EventPool("cpu")
    return [g for r, s in enumerate(sums) if s.num_ed_events
            for g in basecall._read_train_groups(r, s, models, cfg,
                                                 pool.load(sums, r, cfg))]


@pytest.mark.parametrize("key", sorted(STAGED))
def test_train_groups_and_packed_batch_match_jax(reads_dir, key):
    """The port's training groups and pack_train_batch arrays equal the
    JAX package's (whose bank is padded to a power-of-two arity)."""
    from nanocall_tpu import basecall as jbasecall
    from nanocall_tpu_torch import basecall

    models, cfg, sums = _summaries(reads_dir, key)
    tmodels, tcfg, tsums = _summaries(reads_dir, key, port=True)
    want = jbasecall.build_train_groups(sums, models, cfg)
    got = _port_groups(tsums, tmodels, tcfg)
    assert [(g.read_idx, g.key, g.model_names, g.joint) for g in got] == \
        [(g.read_idx, g.key, g.model_names, g.joint) for g in want]
    assert len(got) >= 3
    for g, w in zip(got, want):
        assert [(len(e), st) for e, st in g.seqs] == \
            [(len(e), st) for e, st in w.seqs]
    ev_w, mdl_w, pm_w, st_w = jbasecall.pack_train_batch(want, sums, models,
                                                         cfg, pad_T=128)
    ev_g, mdl_g, pm_g, st_g = basecall.pack_train_batch(got, tsums, tmodels,
                                                        tcfg, pad_T=128)
    for k in ev_w:
        assert np.array_equal(ev_g[k], ev_w[k]), k
    assert np.array_equal(pm_g, pm_w) and np.array_equal(st_g, st_w)
    assert np.array_equal(mdl_g["model_idx"], mdl_w["model_idx"])
    M = len(mdl_g["level_mean"])
    assert M == len({g.model_names for g in got})
    for k in ("level_mean", "level_stdv", "sd_mean", "sd_lambda"):
        assert np.array_equal(mdl_g[k], mdl_w[k][:M]), k


@pytest.mark.parametrize("key", sorted(STAGED))
def test_train_reads_matches_jax(reads_dir, key):
    """Training of every read as the pipeline runs it (basecall.ingest_reads
    with the pore models) at fixed rounds: the same selected models as
    nanocall_tpu's staged train_reads, fits within rtol 1e-4, parameters
    within the stats tolerances."""
    from nanocall_tpu import basecall as jbasecall
    from nanocall_tpu_torch import basecall, read_pipeline

    fixed = dict(scaling_min_progress=0.0, scaling_max_rounds=3)
    models, cfg, want = _summaries(reads_dir, key, **fixed)
    tmodels, tcfg, sums = _summaries(reads_dir, key, port=True, **fixed)
    assert all(s.num_ed_events for s in sums)
    jbasecall.train_reads(want, models, cfg)
    got, _ = basecall.ingest_reads(
        ((s, read_pipeline.load_events(s, tcfg)) for s in sums), tcfg, "cpu",
        train_models=tmodels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.preferred_model == w.preferred_model
        assert sorted(g.fits) == sorted(w.fits) and w.fits
        for k in w.fits:
            assert np.isclose(g.fits[k], w.fits[k], rtol=1e-4), k
            np.testing.assert_allclose(g.pm_params[k].as_array(),
                                       w.pm_params[k].as_array(), rtol=5e-3,
                                       atol=2e-2)
            for st in (0, 1):
                np.testing.assert_allclose(g.st_params[k][st].as_array(),
                                           w.st_params[k][st].as_array(),
                                           rtol=5e-3, atol=1e-3)


def _moment_rel_err(x, ref) -> float:
    """Largest |x - ref| / |ref| over the entries where ref != 0."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    nz = ref != 0
    return float(np.max(np.abs(x[nz] - ref[nz]) / np.abs(ref[nz])))


def test_moment_sums_closer_to_float64_than_jax(reads_dir, monkeypatch):
    """The cause of the joint flip, shown: one EM round's WLS moments
    (A00 .. A22, the posterior x state-weight sums over 4096 states) of the
    fixture's joint groups, from the same alphas, in both packages and with
    the port's per-step sums taken in float64.  The port's pairwise sums
    stay within 5e-7 of that reference; XLA's jitted sums are off by at
    least 4x more, which the WLS solve amplifies into the fixed-round
    parameter differences."""
    import jax
    import jax.numpy as jnp

    from nanocall_tpu import train as jtrain
    from nanocall_tpu.ops import hmm as jhmm
    from nanocall_tpu_torch import basecall, convert, train
    from nanocall_tpu_torch.ops import em, hmm

    models, cfg, sums = _summaries(reads_dir, "joint", port=True)
    groups = _port_groups(sums, models, cfg)
    assert any(g.joint for g in groups)
    batch = basecall.pack_train_batch(groups, sums, models, cfg, pad_T=128)
    inp = train.round_inputs(*convert.train_batch(*batch, "cpu"), K=6)
    alphas, lpd = hmm.fwbw_grouped_forward(inp["gtf"], inp["model"],
                                           inp["ev"])
    args = train.em_backward_args(inp, lpd, alphas, True, False)
    port = em.fused_bwd_mstats_plain(*args)[0][:, :6]
    with monkeypatch.context() as m:
        m.setattr(hmm, "tree_sum", lambda x: x.double().sum(-1).float())
        ref = em.fused_bwd_mstats_plain(*args)[0][:, :6]

    def j(x):
        return jnp.asarray(x.numpy())

    gtf = jhmm.GroupedTransFull(*(j(x) for x in inp["gtf"][:5]), K=6)
    bwd = jax.jit(functools.partial(jtrain._fused_bwd_mstats,
                                    train_scaling=True,
                                    train_transitions=False))
    scal_j, _ = bwd(gtf, jhmm.ModelArrays(*(j(x) for x in inp["model"])),
                    {k: j(v) for k, v in inp["ev"].items()}, j(lpd),
                    j(alphas), j(inp["W"].permute(0, 2, 1)), j(inp["x_unc"]),
                    j(inp["t_start"]), j(inp["valid"]), j(inp["subset"]),
                    j(inp["p_stay_seq"]), j(inp["p_skip_seq"]))
    jax_m = np.stack([np.asarray(scal_j[k]) for k in em.SCAL_NAMES[:6]], -1)
    port_err = _moment_rel_err(port, ref)
    jax_err = _moment_rel_err(jax_m, ref)
    print(f"moments against float64 sums: port {port_err:.3g}, "
          f"JAX {jax_err:.3g}")
    assert port_err < 5e-7
    assert jax_err > 4 * port_err
