"""The port's dev tools and debug flags against nanocall_tpu, on the CPU:
K6e (nanocall_tpu_torch.ops.hmm.fwbw_custom), every tool of
nanocall_tpu_torch.tools, and the CLI's --dump-training-data and
--trace-dir.

Both packages get the same inputs, made from numpy seeds: the K = 3
fixture of tests/test_hmm.py and tests/test_tools.py, short rows at the
builtin models' width (K = 6, n = 4096), and simulated r73 reads.  On the
CPU the port runs the plain PyTorch versions of K6a-K6c and K6e;
chip_smoke.py holds the CUDA kernels to them bit for bit on the card.

Tolerances, and why: jitted XLA reorders the emission (up to 2.4e-4
absolute; tests/test_torch_hmm.py) and its sums, so
  - K6e's alpha, beta and gamma agree within atol 1e-3 (and np.allclose's
    rtol 1e-5), as tests/test_hmm.py:135-137 holds the JAX function to the
    oracle; gamma rows sum to 1 within 1e-5;
  - Viterbi strings, k-mer orders, transition tables and scaled models are
    byte-equal; printed posteriors agree within rtol 1e-4;
  - the -o matrix dumps and the training-data dump are %g text (6
    significant digits, so each side is rounded by up to 5e-6 relative):
    K6e's and K6c's tolerances with rtol 2e-5 in place of 1e-5; K6c's
    alpha and beta only where a state's weight is above e^-80 of its row's
    maximum (XLA on the CPU flushes denormals, torch does not;
    tests/test_torch_trans.py), its emissions within atol 5e-4.
"""

import filecmp
import gzip
import json
import shutil

import numpy as np
import pytest
import torch

import oracle
from nanocall_tpu import events as jevents, pore_model as jpore_model, \
    simulate, tools as jtools, transitions as jtransitions
from nanocall_tpu.cli import main as jax_main
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu_torch import convert, events, tools, transitions
from nanocall_tpu_torch.cli import main as torch_main
from nanocall_tpu_torch.ops import hmm, kernels
from test_hmm import random_events, random_model_arrays
from test_torch_train import _rows
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
P_STAY, P_SKIP = 0.14, 0.21


def _port_events(seqs):
    """The JAX package's EventSequences as the port's."""
    return [events.EventSequence(s.mean, s.stdv, s.start, s.length)
            for s in seqs]


def _assert_custom_close(got: dict, want: dict, rtol=1e-5) -> None:
    for k in ("alpha", "beta", "gamma"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-3,
                                   err_msg=k)


def _assert_dumped_close(got, want) -> None:
    """K6c's alphas or betas as (T, n) dump text: within rtol 2e-5 wherever
    a state's weight is above e^-80 of its row's maximum, and more than 80
    below it on both sides elsewhere (test_torch_train's
    _assert_alphas_close, with the text's rounding)."""
    far = [x <= np.max(x, -1, keepdims=True) - 80.0 for x in (got, want)]
    near = ~far[0] | ~far[1]
    np.testing.assert_allclose(got[near], want[near], rtol=2e-5)
    assert (far[0] == far[1]).all()


# ---------------------------------------------------------------------------
# K6e and make_model_arrays
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup_k3():
    """tests/test_hmm.py's K = 3 fixture: the structured table of the
    priors, a random model, reads of 17 and 31 events (one padded)."""
    K = 3
    rng = np.random.default_rng(42)
    pm = random_model_arrays(K, rng)
    seqs = [random_events(T, rng, pm[0]) for T in (17, 31, 9, 31)][:2]
    return K, pm, seqs


def _k3_tables(K):
    """name -> (the JAX package's table, the port's): the structured table
    of the priors, and a sparse table of the same pairs in which every
    transition into state 5 has log-prob -inf (a loaded table may list
    such entries): state 5's alpha is -inf, JAX's norm has no -inf guard,
    so gamma - alpha is NaN there and spreads backwards."""
    st = jtransitions.build_structured(K=K)
    pairs = [(i, j, -np.inf if j == 5 else lp)
             for i, j, lp in jtransitions.structured_to_pairs(st)]
    return {
        "structured": (st, transitions.build_structured(K=K)),
        "unreachable": (jtransitions.sparse_from_pairs(pairs, K),
                        transitions.sparse_from_pairs(pairs, K)),
    }


@pytest.mark.parametrize("table", ["structured", "unreachable"])
def test_fwbw_custom_matches_jax_k3(setup_k3, table):
    """K6e's plain version against hmm.fwbw_custom_jit on the same inputs:
    alpha, beta and gamma within atol 1e-3 everywhere, padding included
    (alpha stored as computed past a read's length, beta frozen, gamma
    equal to beta from length-1 on), NaN where JAX has NaN."""
    K, pm, seqs = setup_k3
    jt, tt = _k3_tables(K)[table]
    want = jhmm.fwbw_custom_jit(jhmm.make_trans_ops(jt),
                                jhmm.make_model_arrays(*pm),
                                jevents.pad_batch(seqs))
    want = {k: np.asarray(v) for k, v in want.items()}
    model = hmm.make_model_arrays(*(torch.from_numpy(x) for x in pm), B=2)
    ev = convert.event_batch(events.pad_batch(_port_events(seqs)), CPU)
    got = {k: v.numpy() for k, v in
           hmm.fwbw_custom(convert.trans_ops(tt, CPU), model, ev).items()}
    assert all(v.shape == (2, 31, 4 ** K) and v.dtype == np.float32
               for v in got.values())
    _assert_custom_close(got, want)
    nan = np.isnan(got["gamma"])
    assert nan.any() == (table == "unreachable")
    L = len(seqs[0])
    assert (got["beta"][0, L:] == got["beta"][0, L - 1]).all()
    assert (got["gamma"][0, L - 1:] == got["beta"][0, L - 1:]).all()


def test_fwbw_custom_matches_the_oracle_k3(setup_k3):
    """K6e against the float64 oracle of tests/oracle.py
    (Forward_Backward_Custom.hpp's loops) over each read's events, within
    atol 1e-3; gamma rows are posteriors that sum to 1 within 1e-5."""
    K, pm, seqs = setup_k3
    st = transitions.build_structured(K=K)
    M = oracle.dense_logp(jtransitions.build_structured(K=K), K)
    model = hmm.make_model_arrays(*(torch.from_numpy(x) for x in pm), B=2)
    ev = convert.event_batch(events.pad_batch(_port_events(seqs)), CPU)
    got = hmm.fwbw_custom(convert.trans_ops(st, CPU), model, ev)
    for b, s in enumerate(seqs):
        T = len(s)
        a_ref, b_ref, g_ref = oracle.fwbw_custom(M, oracle.emissions(pm, s))
        _assert_custom_close({k: got[k][b, :T].numpy() for k in got},
                             {"alpha": a_ref, "beta": b_ref, "gamma": g_ref})
        sums = np.exp(got["gamma"][b, :T].double().numpy()).sum(1)
        np.testing.assert_allclose(sums, 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def loaded6(tmp_path_factory):
    """The 21-neighbour table of (0.14, 0.21) written as a transitions TSV
    and loaded back by each package (`-s`)."""
    path = str(tmp_path_factory.mktemp("trans6") / "trans.tsv")
    jtransitions.save_tsv(jtransitions.build_structured(
        jtransitions.TransitionParams(P_STAY, P_SKIP), 6), path)
    return path, jtransitions.load_tsv(path, 6), transitions.load_tsv(path, 6)


def test_fwbw_custom_matches_jax_k6(loaded6):
    """K6e at the builtin models' width under the loaded table, B = 2 reads
    of 32 and 19 events (one padded), per-read scaled r73 models: within
    atol 1e-3 of hmm.fwbw_custom_jit; gamma rows sum to 1."""
    _, jt, tt = loaded6
    (_, m_j, ev_j), (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(61),
                                              2, 32, [32, 19])
    want = jhmm.fwbw_custom_jit(jhmm.make_trans_ops(jt), m_j, ev_j)
    got = hmm.fwbw_custom(convert.trans_ops(tt, CPU), m_t, ev_t)
    _assert_custom_close({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})
    for b, L in enumerate((32, 19)):
        sums = torch.exp(got["gamma"][b, :L].double()).sum(1).numpy()
        np.testing.assert_allclose(sums, 1.0, atol=1e-5)


def test_make_model_arrays_matches_jax():
    """hmm.make_model_arrays: the unscaled tables bit-equal, the logs within
    1 ulp of jnp.log, repeated in B contiguous rows; convert's
    model_arrays_from_pore_model gives its one row from a PoreModel."""
    pm = load_builtin_models("r73")["r73.t.006"]
    want = jhmm.make_model_arrays(*pm.state_arrays())
    got = hmm.make_model_arrays(*(torch.from_numpy(x)
                                  for x in pm.state_arrays()), B=3)
    one = convert.model_arrays_from_pore_model(pm, CPU)
    for f in hmm.ModelArrays._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == (3, 4096) and g.is_contiguous() and \
            g.dtype == torch.float32, f
        assert (g == g[:1]).all() and torch.equal(getattr(one, f), g[:1]), f
        ulps = np.abs(g[0].numpy().view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= (1 if f.startswith("log") else 0), f


def test_fwbw_custom_kernel_refuses_cpu_and_bad_inputs(loaded6):
    """The CUDA wrapper checks its inputs and takes CUDA tensors only: a CPU
    tensor never reaches the plain version through it, and a K other than 6
    raises the kernels' ValueError (the tools' `-K 3` on the card)."""
    ops = convert.trans_ops(loaded6[2], CPU)
    (_, _, _), (_, m_t, ev_t), _ = _rows(6, np.random.default_rng(2), 2, 8,
                                         [8, 5])
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        hmm.fwbw_custom_kernel(ops, m_t, ev_t)
    with pytest.raises(ValueError, match="K=6"):
        hmm.fwbw_custom_kernel(ops._replace(K=3), m_t, ev_t)
    with pytest.raises(ValueError, match="float32"):
        hmm.fwbw_custom_kernel(ops, m_t, {**ev_t,
                                          "mean": ev_t["mean"].double()})
    with pytest.raises(ValueError, match=r"\(2, 4096\)"):
        hmm.fwbw_custom_kernel(ops, m_t._replace(level_mean=m_t.level_mean[:1]),
                               ev_t)
    meta = {k: v.to("meta") for k, v in ev_t.items()}
    with pytest.raises(ValueError, match="device"):
        hmm.fwbw_custom(ops, m_t, meta)
    assert all(k.wrapper.launches == 0 for k in kernels.KERNELS)
    k6e = {k.name: k for k in kernels.KERNELS}["fwbw_custom"]
    assert k6e.wrapper is hmm.fwbw_custom_kernel
    assert k6e.replaces == "nanocall_tpu/ops/hmm.py:1047"


# ---------------------------------------------------------------------------
# the tools, each through both packages' tools.main
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tsv3(tmp_path_factory):
    """tests/test_tools.py's K = 3 TSV fixture: a random model, the
    structured table of the library defaults, 21 events."""
    d = tmp_path_factory.mktemp("tsv3")
    K, N = 3, 64
    rng = np.random.default_rng(5)
    lm = rng.uniform(40, 90, N).astype(np.float32)
    pm = jpore_model.PoreModel(
        level_mean=lm,
        level_stdv=rng.uniform(0.8, 2.0, N).astype(np.float32),
        sd_mean=rng.uniform(0.5, 1.5, N).astype(np.float32),
        sd_stdv=rng.uniform(0.1, 0.4, N).astype(np.float32), K=K)
    jpore_model.save_tsv(pm, d / "model.tsv")
    jtransitions.save_tsv(jtransitions.build_structured(K=K), d / "trans.tsv")
    T = 21
    jevents.save_tsv(jevents.EventSequence(
        mean=rng.choice(lm, T) + rng.normal(0, 0.5, T),
        stdv=rng.uniform(0.5, 1.5, T),
        start=np.cumsum(rng.uniform(0.01, 0.05, T)),
        length=rng.uniform(0.01, 0.05, T)), d / "events.tsv")
    return d, ["-p", str(d / "model.tsv"), "-s", str(d / "trans.tsv"), "-e",
               str(d / "events.tsv"), "-K", "3"]


@pytest.fixture(scope="module")
def tsv6(tmp_path_factory, loaded6):
    """The r73 template model, the loaded table and 24 events of a read
    simulated from that model, as TSVs: the tools at full width."""
    d = tmp_path_factory.mktemp("tsv6")
    models = load_builtin_models("r73")
    jpore_model.save_tsv(models["r73.t.006"], d / "model.tsv")
    mean, stdv, start, length, _ = simulate.simulate_read(
        models, "r73.t.006", None, 24, np.random.default_rng(66),
        noise_scale=0.5)
    jevents.save_tsv(jevents.EventSequence(mean[70:94], stdv[70:94],
                                           start[70:94], length[70:94]),
                     d / "events.tsv")
    return d, ["-p", str(d / "model.tsv"), "-s", loaded6[0], "-e",
               str(d / "events.tsv")]


def _tool(main, argv, capsys):
    """(return code, stdout) of one tools.main call."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both_tools(argv, capsys, port_extra=("--device", "cpu")):
    j = _tool(jtools.main, list(argv), capsys)
    t = _tool(tools.main, [*argv, *port_extra], capsys)
    assert j[0] == t[0] == 0
    return j[1], t[1]


@pytest.mark.parametrize("fixture", ["tsv3", "tsv6"])
def test_run_viterbi_equal(request, capsys, fixture):
    _, args = request.getfixturevalue(fixture)
    want, got = _both_tools(["run-viterbi", *args], capsys)
    assert len(want.strip()) >= 3 and set(want.strip()) <= set("ACGT")
    assert got == want


def _posteriors(text):
    rows = [line.split("\t") for line in text.strip().splitlines()]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def _dump_columns(path):
    """The -o dump as (i, j) int columns and the float value columns."""
    a = np.loadtxt(path, delimiter="\t", ndmin=2)
    return a[:, :2].astype(np.int64), a[:, 2:]


@pytest.mark.parametrize("custom", [False, True], ids=["fwbw", "custom"])
@pytest.mark.parametrize("fixture", ["tsv3", "tsv6"])
def test_run_fwbw_equal(request, capsys, tmp_path, fixture, custom):
    """The middle event's posteriors: the same k-mers in the same order,
    probabilities within rtol 1e-4, all in [0.1, 1]; the -o dumps within
    the dump tolerance."""
    _, args = request.getfixturevalue(fixture)
    extra = ["--custom-fwbw"] if custom else []
    j_out, t_out = tmp_path / "j.tsv", tmp_path / "t.tsv"
    want, _ = _both_tools(["run-fwbw", *args, *extra], capsys)
    _tool(jtools.main, ["run-fwbw", *args, *extra, "-o", str(j_out)], capsys)
    rc, got = _tool(tools.main, ["run-fwbw", *args, *extra, "-o", str(t_out),
                                 "--device", "cpu"], capsys)
    assert rc == 0
    (kw, pw), (kg, pg) = _posteriors(want), _posteriors(got)
    assert kw and kg == kw
    np.testing.assert_allclose(pg, pw, rtol=1e-4)
    assert ((pg >= 0.1) & (pg <= 1.0 + 1e-6)).all()
    assert list(pg) == sorted(pg, reverse=True)
    (ij_w, v_w), (ij_g, v_g) = _dump_columns(j_out), _dump_columns(t_out)
    assert np.array_equal(ij_g, ij_w)
    assert v_g.shape == v_w.shape == (len(ij_w), 3 if custom else 2)
    n = 4 ** (3 if fixture == "tsv3" else 6)
    if custom:
        _assert_custom_close(*({k: v[:, i] for i, k in enumerate(
            ("alpha", "beta", "gamma"))} for v in (v_g, v_w)), rtol=2e-5)
    else:
        for i in range(2):
            _assert_dumped_close(v_g[:, i].reshape(-1, n),
                                 v_w[:, i].reshape(-1, n))


@pytest.mark.parametrize("K_", [3, 6])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "dense"])
def test_compute_state_transitions_byte_equal(capsys, tmp_path, K_, fast):
    """--fast and the dense table with its cutoff: stdout and the -o file
    byte-equal (K = 3 on stdout, both widths to the file)."""
    argv = ["compute-state-transitions", "-t", "0.14", "-k", "0.21", "-K",
            str(K_), *(["--fast"] if fast else [])]
    if K_ == 3:
        want, got = _both_tools(argv, capsys, ())
        assert got == want and want.count("\n") > 64
    for main, name in ((jtools.main, "j.tsv"), (tools.main, "t.tsv")):
        assert main([*argv, "-o", str(tmp_path / name)]) == 0
    assert filecmp.cmp(tmp_path / "j.tsv", tmp_path / "t.tsv", shallow=False)


@pytest.fixture(scope="module")
def basecalled_fast5(tmp_path_factory):
    """A simulated r73 1D read basecalled into its own fast5 by
    `python -m nanocall_tpu ... --write-fast5` (a Nanocall_* group with the
    model table and the scaling parameters)."""
    d = tmp_path_factory.mktemp("bc_fast5")
    simulate.write_sim_fast5(d / "r.fast5", load_builtin_models("r73"),
                             "r73.t.006", None, 250,
                             np.random.default_rng(8), read_id="r",
                             noise_scale=0.5)
    assert jax_main([str(d), "--pore", "r73", "--no-train", "--1d", "-t",
                     "1", "--write-fast5"]) == 0
    return d / "r.fast5"


def test_compute_scaled_pore_model_byte_equal(basecalled_fast5, capsys,
                                              tmp_path):
    argv = ["compute-scaled-pore-model", "-f", str(basecalled_fast5)]
    want, got = _both_tools(argv, capsys, ())
    assert got == want and want.count("\n") == 4096
    for main, name in ((jtools.main, "j.tsv"), (tools.main, "t.tsv")):
        assert main([*argv, "-o", str(tmp_path / name)]) == 0
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


def test_list_directory_and_gzip_inputs_equal(tsv3, capsys, tmp_path):
    """list-directory's listing (and its refusal of a file), and
    run-viterbi on gzip-compressed TSVs: equal output, equal to the plain
    files' decode."""
    d, args = tsv3
    want, got = _both_tools(["list-directory", str(d)], capsys, ())
    assert got == want == "events.tsv\nmodel.tsv\ntrans.tsv\n"
    for main in (jtools.main, tools.main):
        assert main(["list-directory", str(d / "model.tsv")]) == 1
    gz_args = list(args)
    for i in (1, 3, 5):
        src = d / args[i]
        dst = tmp_path / (src.name + ".gz")
        with open(src, "rb") as fi, gzip.open(dst, "wb") as fo:
            shutil.copyfileobj(fi, fo)
        gz_args[i] = str(dst)
    want_gz, got_gz = _both_tools(["run-viterbi", *gz_args], capsys)
    plain, _ = _both_tools(["run-viterbi", *args], capsys)
    assert got_gz == want_gz == plain


def test_usage_and_device_cuda_without_a_gpu(tsv3, capsys):
    """No tool name prints the usage (rc 2); `--device cuda` without a
    usable GPU raises, and never runs the plain versions instead."""
    assert tools.main([]) == 2
    assert "nanocall_tpu_torch.tools" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in ("run-viterbi", "run-fwbw"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tools.main([tool, *tsv3[1]])
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the CLI's --dump-training-data and --trace-dir
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def r73_read(tmp_path_factory):
    """tests/test_pipeline.py:603-646's 300-event r73 1D read."""
    d = tmp_path_factory.mktemp("dump_fast5")
    simulate.write_sim_fast5(d / "r.fast5", load_builtin_models("r73"),
                             "r73.t.006", None, 300,
                             np.random.default_rng(5), read_id="r",
                             noise_scale=0.5)
    return d


def test_dump_training_data_matches_jax(r73_read, tmp_path):
    """Both CLIs' --dump-training-data on the same read: the same files,
    transitions.k.tab byte-equal, emissions within atol 5e-4 (rtol 2e-5),
    fw and bw within K6c's dump tolerance, and the reference's invariants
    (fw[0] = em[0] - log n, posteriors summing to 1)."""
    flags = ["--pore", "r73", "--scaling-num-events", "60", "-t", "1",
             "--dump-training-data"]
    jd, td = tmp_path / "jax", tmp_path / "torch"
    assert jax_main([str(r73_read), *flags, str(jd)]) == 0
    assert torch_main([str(r73_read), *flags, str(td), "--device",
                       "cpu"]) == 0
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    assert names == sorted(f"{s}.{k}.tab" for k in (0, 1)
                           for s in ("emissions", "transitions", "fw", "bw"))
    n = 4096
    for k in (0, 1):
        assert filecmp.cmp(jd / f"transitions.{k}.tab",
                           td / f"transitions.{k}.tab", shallow=False)
        em, fw, bw = (np.loadtxt(td / f"{s}.{k}.tab")
                      for s in ("emissions", "fw", "bw"))
        assert em.shape == fw.shape == bw.shape == (30, n)
        np.testing.assert_allclose(em, np.loadtxt(jd / f"emissions.{k}.tab"),
                                   rtol=2e-5, atol=5e-4)
        for got, s in ((fw, "fw"), (bw, "bw")):
            _assert_dumped_close(got, np.loadtxt(jd / f"{s}.{k}.tab"))
        assert np.allclose(fw[0], em[0] - np.log(n), atol=2e-4)
        post = np.exp(fw + bw - np.logaddexp.reduce(fw[-1]))
        assert np.allclose(post.sum(1), 1.0, atol=1e-3)


def test_dump_training_data_without_a_trainable_read(r73_read, tmp_path):
    """No read long enough to train (--min-ed-events above the read's
    events): both CLIs exit with the same message."""
    for main, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="no trainable read to dump"):
            main([str(r73_read), "--pore", "r73", "-t", "1",
                  "--min-ed-events", "5000", "--dump-training-data",
                  str(tmp_path / "dump"), *extra])


@pytest.mark.parametrize("resume", [False, True], ids=["run", "resume"])
def test_trace_dir_writes_a_trace_and_changes_no_result(r73_read, tmp_path,
                                                        resume):
    """--trace-dir on the CPU writes a Chrome trace of the run; FASTA and
    stats are byte-equal to the same run without it.  In the --resume-stats
    flow the trace spans both stages: it holds the decode's ops."""
    base = [str(r73_read), "--pore", "r73", "--no-train", "--device", "cpu",
            "-t", "1"]
    if resume:
        assert torch_main([*base, "-o", str(tmp_path / "r.fa"), "--stats",
                           str(tmp_path / "r.tsv")]) == 0
        base += ["--resume-stats", str(tmp_path / "r.tsv")]
    outs = []
    for tag, extra in (("plain", []),
                       ("traced", ["--trace-dir", str(tmp_path / "trace")])):
        fa, st = tmp_path / f"{tag}.fa", tmp_path / f"{tag}.tsv"
        assert torch_main([*base, "-o", str(fa), "--stats", str(st),
                           *extra]) == 0
        outs.append((fa.read_bytes(), st.read_bytes()))
    assert outs[0] == outs[1] and outs[0][0].count(b">") == 1
    with open(tmp_path / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the grouped Viterbi decode's plain forward (K1's) ran inside the trace
    assert "aten::repeat_interleave" in names, sorted(names)[:20]


def test_trace_dir_empty_is_a_no_op():
    from nanocall_tpu_torch import observe

    with observe.device_trace(""):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
