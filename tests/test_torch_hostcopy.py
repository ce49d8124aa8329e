"""The port's own copies of the host modules against their originals in
nanocall_tpu, on the same inputs, on the CPU.

nanocall_tpu_torch imports nothing of nanocall_tpu: it keeps copies of the
numpy and C++ host modules (kmer, config, batching, native, events with its
TSV I/O and pad_batch, pore_model with scaling and save_tsv, transitions
with the dense table, models, fast5_io, read_pipeline, ingest, output,
observe, version) and of the read simulator (simulate).  Each copy must give what its original gives, bit for
bit: tolerance 0 everywhere below.
"""

import dataclasses
import gzip
import io
import logging

import numpy as np
import pytest

from nanocall_tpu import batching as jbatching, config as jconfig, \
    events as jevents, fast5_io as jfast5_io, kmer as jkmer, \
    native as jnative, observe as jobserve, output as joutput, \
    pore_model as jpore_model, read_pipeline as jread_pipeline, simulate, \
    transitions as jtransitions, version as jversion
from nanocall_tpu.models import load_builtin_models as jload_models
from nanocall_tpu_torch import batching, config, events, fast5_io, ingest, \
    kmer, native, observe, output, pore_model, read_pipeline, \
    simulate as tsimulate, transitions, version
from nanocall_tpu_torch.models import load_builtin_models

K = 6
N = 4096


@pytest.mark.parametrize("pore", ["r73", "r9"])
def test_builtin_models_bit_equal(pore):
    want, got = jload_models(pore, K), load_builtin_models(pore, K)
    assert list(got) == list(want) and len(got) >= 2
    for name, w in want.items():
        g = got[name]
        assert (g.K, g.strand, g.name) == (w.K, w.strand, w.name)
        for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv",
                  "sd_lambda"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        assert g.mean() == w.mean() and g.stdv() == w.stdv()


@pytest.mark.parametrize("K_", [3, 6])
def test_kmer_tables_bit_equal(K_):
    rng = np.random.default_rng(K_)
    n = kmer.n_states(K_)
    assert n == jkmer.n_states(K_)
    assert np.array_equal(kmer.int_to_kmer_array(K_),
                          jkmer.int_to_kmer_array(K_))
    assert kmer.all_kmer_strings(K_) == jkmer.all_kmer_strings(K_)
    assert np.array_equal(kmer.max_self_overlap(K_),
                          jkmer.max_self_overlap(K_))
    for d in (1, 2):
        assert np.array_equal(kmer.neighbour_list(K_, d),
                              jkmer.neighbour_list(K_, d))
    a, b = rng.integers(0, n, 500), rng.integers(0, n, 500)
    assert np.array_equal(kmer.min_skip(a, b, K_), jkmer.min_skip(a, b, K_))
    moves = jkmer.min_skip(a[:-1], a[1:], K_)
    moves = np.concatenate([[0], moves])
    assert kmer.moves_to_base_seq(a, moves, K_) == \
        jkmer.moves_to_base_seq(a, moves, K_)
    s = jkmer.int_to_kmer(int(a[0]), K_)
    assert kmer.kmer_to_int(s) == jkmer.kmer_to_int(s) == a[0]


@pytest.mark.parametrize("K_", [3, 6])
def test_transition_tables_and_masks_bit_equal(K_):
    for fn in ("grouped_condition_masks", "grouped_condition_masks_to",
               "grouped_correction_masks"):
        want, got = getattr(jtransitions, fn)(K_), getattr(transitions, fn)(K_)
        assert sorted(got) == sorted(want), fn
        for k in want:
            assert np.array_equal(got[k], want[k]), (fn, k)
    for a, b in zip(transitions._slot_maps(K_), jtransitions._slot_maps(K_)):
        assert np.array_equal(a, b)
    ps = np.float32([0.1, 0.05, 0.3])
    pk = np.float32([0.3, 0.4, 0.1])
    for fn in ("grouped_tables", "grouped_tables_to"):
        for a, b in zip(getattr(transitions, fn)(ps, pk, K_),
                        getattr(jtransitions, fn)(ps, pk, K_)):
            assert a.dtype == b.dtype and np.array_equal(a, b), fn
    for p in ((0.1, 0.3), (0.14, 0.21)):
        got = transitions.build_structured(transitions.TransitionParams(*p),
                                           K_)
        want = jtransitions.build_structured(
            jtransitions.TransitionParams(*p), K_)
        assert np.array_equal(got.from_logp, want.from_logp)
        assert np.array_equal(got.to_logp, want.to_logp)


def test_transition_params_bit_equal():
    for p in ((0.1, 0.3), (np.float32(0.1), np.float32(0.3)), (0.2, 0.25)):
        got, want = transitions.TransitionParams(*p), \
            jtransitions.TransitionParams(*p)
        assert np.array_equal(got.as_array(), want.as_array())
        assert got.is_default(transitions.TransitionParams(0.1, 0.3)) == \
            want.is_default(jtransitions.TransitionParams(0.1, 0.3))


def test_transitions_tsv_round_trip_equal(tmp_path):
    """A table written by each package's save_tsv has the same bytes, and
    each package's loader gives the same slots."""
    for K_ in (3, 6):
        st = jtransitions.build_structured(
            jtransitions.TransitionParams(0.14, 0.21), K_)
        jtransitions.save_tsv(st, tmp_path / "j.tsv")
        transitions.save_tsv(transitions.build_structured(
            transitions.TransitionParams(0.14, 0.21), K_), tmp_path / "t.tsv")
        assert (tmp_path / "t.tsv").read_bytes() == \
            (tmp_path / "j.tsv").read_bytes()
        got = transitions.load_tsv(tmp_path / "j.tsv", K_)
        want = jtransitions.load_tsv(tmp_path / "j.tsv", K_)
        assert isinstance(got, transitions.SparseTransitions)
        for f in ("from_idx", "from_logp", "to_idx", "to_logp"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        transitions.save_tsv(got, tmp_path / "t2.tsv")
        jtransitions.save_tsv(want, tmp_path / "j2.tsv")
        assert (tmp_path / "t2.tsv").read_bytes() == \
            (tmp_path / "j2.tsv").read_bytes()


def test_pore_model_tsv_and_params_equal(tmp_path):
    pm = jload_models("r73")["r73.t.006"]
    jpore_model.save_tsv(pm, tmp_path / "m.tsv")
    got = pore_model.load_tsv(str(tmp_path / "m.tsv"), K, 0, "m")
    want = jpore_model.load_tsv(str(tmp_path / "m.tsv"), K, 0, "m")
    for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv", "sd_lambda"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert pore_model.LOG_2PI == jpore_model.LOG_2PI
    a = np.float32([1.1, -2.0, 0.01, 0.9, 1.05, 0.95])
    p, q = pore_model.PoreModelParams.from_array(a), \
        jpore_model.PoreModelParams.from_array(a)
    assert (str(p), p.write_tsv()) == (str(q), q.write_tsv())
    assert np.array_equal(p.as_array(), q.as_array())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_helpers_bit_equal(seed):
    """The port's native library, and its numpy paths, against the JAX
    package's native helpers on random inputs."""
    assert native.available()
    rng = np.random.default_rng(seed)
    means = rng.normal(70.0, 15.0, 5000)
    means[1000:1008] = 130.0  # an island
    stdv = rng.uniform(0.2, 5.0, 5000)
    for tp, off in ((1.0, 5.0), (1.0, 0.0), (150.0, 0.0)):
        assert native.abasic_level(means, tp, off) == \
            jnative.abasic_level(means, tp, off)
    level = jnative.abasic_level(means, 1.0, 5.0)
    assert native.find_islands_5(means, level) == \
        jnative.find_islands_5(means, level)
    assert np.array_equal(native.filter_events(means, stdv, level),
                          jnative.filter_events(means, stdv, level))
    for n in (0, 1, 17, 5000):
        vals = means[:n].astype(np.float32)
        assert native.mean_stdv_f32(vals) == jnative.mean_stdv_f32(vals)
        assert native._mean_stdv_f32_numpy(vals) == \
            jnative._mean_stdv_f32_numpy(vals)
    path = np.cumsum(rng.integers(0, 3, 3000)) % N
    path = ((path * 2654435761) % N).astype(np.int32)
    gm, gs = native.moves_and_base_seq(path, K)
    wm, ws = jnative.moves_and_base_seq(path, K)
    assert np.array_equal(gm, wm) and gs == ws
    for n in (1, 2, 5, 3001):
        packed = rng.integers(0, 256, 3 * (-(-(n - 1) // 4))).astype(np.uint8)
        s0 = int(rng.integers(0, N))
        want = jnative.path_from_packed_codes(s0, packed, n, K)
        assert np.array_equal(native.path_from_packed_codes(s0, packed, n, K),
                              want)
    codes = rng.integers(0, 64, 500).astype(np.uint8)
    assert np.array_equal(native.path_from_codes(7, codes, K),
                          jnative.path_from_codes(7, codes, K))


def test_native_numpy_paths_bit_equal(monkeypatch):
    """Without the built library the port's numpy paths give the same."""
    rng = np.random.default_rng(9)
    means = rng.normal(70.0, 15.0, 2000)
    means[500:507] = 130.0
    stdv = rng.uniform(0.2, 5.0, 2000)
    path = (np.cumsum(rng.integers(0, 3, 800)) * 37 % N).astype(np.int32)
    packed = rng.integers(0, 256, 3 * 200).astype(np.uint8)
    want = (native.abasic_level(means, 1.0, 5.0),
            native.find_islands_5(means, 100.0),
            native.filter_events(means, stdv, 100.0),
            native.mean_stdv_f32(means),
            native.moves_and_base_seq(path, K),
            native.path_from_packed_codes(3, packed, 800, K))
    monkeypatch.setattr(native, "_LIB", False)
    got = (native.abasic_level(means, 1.0, 5.0),
           native.find_islands_5(means, 100.0),
           native.filter_events(means, stdv, 100.0),
           native.mean_stdv_f32(means),
           native.moves_and_base_seq(path, K),
           native.path_from_packed_codes(3, packed, 800, K))
    assert got[:2] == want[:2]
    assert np.array_equal(got[2], want[2]) and got[3] == want[3]
    assert np.array_equal(got[4][0], want[4][0]) and got[4][1] == want[4][1]
    assert np.array_equal(got[5], want[5])


def test_batching_equal():
    for n in (0, 1, 100, 128, 129, 2048, 2049, 33000, 100000):
        assert batching.bucket_length(n) == jbatching.bucket_length(n)
    assert (batching.TCHUNK_MIN_T, batching.TCHUNK_LEN) == \
        (jbatching.TCHUNK_MIN_T, jbatching.TCHUNK_LEN)
    for T in (128, 8192, 8193, 34816, 100352):
        assert batching.tchunk_len(T) == jbatching.tchunk_len(T)
        for args in ((256, 32 << 30, N), (128, 8 << 30, N, 16)):
            assert batching.batch_size_for(T, *args) == \
                jbatching.batch_size_for(T, *args)


def test_config_defaults_and_presets_equal():
    got, want = config.Config(), jconfig.Config()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for pore in ("r9", "r73"):
        g = config.Config(pore=pore).apply_pore_preset()
        w = jconfig.Config(pore=pore).apply_pore_preset()
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (pore, f.name)
        assert g.trim_margins == w.trim_margins


def test_observe_and_version_equal():
    for specs in ([], ["debug"], ["debug2", "Fast5_Summary:debug1"]):
        assert observe.set_levels_from_options(specs) == \
            jobserve.set_levels_from_options(specs)
    logging.getLogger("Fast5_Summary").setLevel(logging.NOTSET)
    assert observe.LOG_LEVELS == jobserve.LOG_LEVELS
    assert version.get_version() == jversion.get_version()
    for p in (observe.Progress("tasks", stream=io.StringIO()),
              jobserve.Progress("tasks", stream=io.StringIO())):
        p.add(3)
        p.finish()
    assert p.stream.getvalue().endswith("3 tasks in      0 seconds\n")


@pytest.fixture(scope="module")
def fast5_dir(tmp_path_factory):
    """Two 1D reads and one hairpin read as fast5 files."""
    d = tmp_path_factory.mktemp("fast5")
    models = jload_models("r73")
    rng = np.random.default_rng(77)
    for name, comp, n in (("t0", None, 300), ("t1", None, 500),
                          ("d0", "r73.c.p1.006", 450)):
        simulate.write_sim_fast5(str(d / f"{name}.fast5"), models,
                                 "r73.t.006", comp, n, rng, read_id=name,
                                 noise_scale=0.5)
    return d


@pytest.mark.parametrize("flags", [{}, {"template_only": True},
                                   {"double_strand_scaling": False}])
def test_ingest_summaries_equal(fast5_dir, flags):
    """The port's fast5 reader, file list, summaries, events and ingest
    stream against the JAX package's: equal arrays, strand bounds and
    parameters."""
    files = read_pipeline.init_files([str(fast5_dir)])
    assert files == jread_pipeline.init_files([str(fast5_dir)])
    cfg = config.Config(pore="r73", ingest_workers=1,
                        **flags).apply_pore_preset()
    jcfg = jconfig.Config(pore="r73", ingest_workers=1,
                          **flags).apply_pore_preset()
    models, jmodels = load_builtin_models("r73"), jload_models("r73")
    got = list(ingest.ingest_stream(files, models, cfg))
    assert len(got) == 3
    for f, (s, evs) in zip(files, got):
        w, wevs = jread_pipeline.summarize(f, jmodels, jcfg,
                                           return_events=True)
        assert dataclasses.asdict(s) == dataclasses.asdict(w)
        assert s.num_ed_events and s.strand_bounds == w.strand_bounds
        for ev_set in (evs, read_pipeline.load_events(s, cfg)):
            for a, b in zip(ev_set, wevs):
                for fld in ("mean", "stdv", "start", "length", "log_stdv"):
                    assert np.array_equal(getattr(a, fld), getattr(b, fld))
        with fast5_io.Fast5File(f) as h, jfast5_io.Fast5File(f) as jh:
            a, b = h.get_eventdetection_events(), jh.get_eventdetection_events()
            assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
            for fld in ("mean", "stdv", "start", "length"):
                assert np.array_equal(getattr(a, fld), getattr(b, fld))
            assert h.get_basecall_group_list() == jh.get_basecall_group_list()


def test_event_sequences_equal():
    rng = np.random.default_rng(3)
    arrays = [rng.uniform(0.1, 90.0, 50) for _ in range(4)]
    arrays[1][[3, 7]] = 0.0  # clamped to 0.01
    a, b = events.EventSequence(*arrays), jevents.EventSequence(*arrays)
    for f in ("mean", "stdv", "start", "length", "log_stdv"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.mean_stdv() == b.mean_stdv()
    assert a.time_length() == b.time_length()
    assert np.array_equal(a.corrected_mean(0.01), b.corrected_mean(0.01))


def test_output_writers_byte_equal(fast5_dir, tmp_path):
    """Stats (written, loaded back and resumed) and FASTA of the same
    summaries and results: the same bytes from both packages' writers."""
    files = read_pipeline.init_files([str(fast5_dir)])
    cfg = config.Config(pore="r73").apply_pore_preset()
    jcfg = jconfig.Config(pore="r73").apply_pore_preset()
    sums = [read_pipeline.summarize(f, load_builtin_models("r73"), cfg)
            for f in files]
    jsums = [jread_pipeline.summarize(f, jload_models("r73"), jcfg)
             for f in files]
    for s, w in zip(sums, jsums):
        key = sorted(s.pm_params)[0]
        for x in (s, w):
            x.preferred_model[0] = key[0] or key[1]
    texts = []
    for out_mod, ss, tp in ((output, sums, transitions.TransitionParams),
                            (joutput, jsums, jtransitions.TransitionParams)):
        fh = io.StringIO()
        out_mod.write_stats(fh, ss, tp(0.1, 0.3))
        texts.append(fh.getvalue())
    assert texts[0] == texts[1] and texts[0].count("\n") == 4
    (tmp_path / "s.tsv").write_text(texts[0])
    got = output.load_stats(tmp_path / "s.tsv")
    want = joutput.load_stats(tmp_path / "s.tsv")
    assert {k: {st: (r[0], r[1].as_array().tolist(), r[2].as_array().tolist())
                for st, r in v.items()} for k, v in got.items()} == \
        {k: {st: (r[0], r[1].as_array().tolist(), r[2].as_array().tolist())
             for st, r in v.items()} for k, v in want.items()}
    assert output.apply_resume(sums, got) == joutput.apply_resume(jsums, want)

    @dataclasses.dataclass
    class R:
        seq_name: str
        base_seq: str

    results = [R("a:f:0", "ACGT" * 50), R("b:f:1", ""), R("c:f:0", "T" * 81)]
    for width in (80, 7):
        fh, jfh = io.StringIO(), io.StringIO()
        output.write_results_fasta(fh, results, width)
        joutput.write_results_fasta(jfh, results, width)
        assert fh.getvalue() == jfh.getvalue()


def test_event_tsv_and_pad_batch_equal(tmp_path):
    """events.save_tsv / load_tsv (gzip and empty files too) and pad_batch
    with and without drifts and pad_to: the same bytes and arrays; log_stdv
    is np.log of the padded stdv on the host in both."""
    rng = np.random.default_rng(11)
    seqs = [[rng.uniform(0.1, 90.0, n) for _ in range(4)] for n in (7, 13)]
    seqs[0][1][2] = 0.0  # clamped to 0.01
    ts = [events.EventSequence(*a) for a in seqs]
    js = [jevents.EventSequence(*a) for a in seqs]
    events.save_tsv(ts[1], tmp_path / "t.tsv")
    jevents.save_tsv(js[1], tmp_path / "j.tsv")
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    with open(tmp_path / "j.tsv", "rb") as fi, \
            gzip.open(tmp_path / "j.tsv.gz", "wb") as fo:
        fo.write(fi.read())
    (tmp_path / "empty.tsv").write_text("")
    for name in ("j.tsv", "j.tsv.gz", "empty.tsv"):
        a, b = events.load_tsv(tmp_path / name), jevents.load_tsv(tmp_path / name)
        for f in ("mean", "stdv", "start", "length"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
    drifts = np.float32([0.002, -0.001])
    for kw in ({}, {"drifts": drifts}, {"pad_to": 20, "drifts": drifts}):
        got, want = events.pad_batch(ts, **kw), jevents.pad_batch(js, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (kw, k)
    with pytest.raises(ValueError, match="longer"):
        events.pad_batch(ts, pad_to=5)


def test_pore_model_scaling_and_save_equal(tmp_path):
    """PoreModel.scaled, state_arrays and pore_model.save_tsv: the same
    arrays and bytes."""
    jpm = jload_models("r73")["r73.c.p1.006"]
    pm = load_builtin_models("r73")["r73.c.p1.006"]
    params = (1.07, -2.5, 0.001, 1.2, 0.95, 1.1)
    got = pm.scaled(pore_model.PoreModelParams(*params))
    want = jpm.scaled(jpore_model.PoreModelParams(*params))
    for a, b in zip(got.state_arrays(), want.state_arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got.sd_stdv, want.sd_stdv)
    pore_model.save_tsv(got, tmp_path / "t.tsv")
    jpore_model.save_tsv(want, tmp_path / "j.tsv")
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("K_", [3, 6])
def test_compute_transitions_dense_equal(K_):
    """The exact table with its probability cutoff: the same slots."""
    got = transitions.compute_transitions_dense(0.21, 0.14, 1e-3, K_)
    want = jtransitions.compute_transitions_dense(0.21, 0.14, 1e-3, K_)
    assert isinstance(got, transitions.SparseTransitions)
    for f in ("from_idx", "from_logp", "to_idx", "to_logp"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("comp", [None, "r73.c.p1.006"], ids=["1d", "2strand"])
def test_simulate_read_bit_equal(comp):
    """simulate_read from one seed, 1D and 2-strand (with drift and scaling
    and the default noise, and at chip_smoke.py's noise 0.5): the same
    arrays, truth paths and bases, and the same draws left in the
    generator."""
    models, jmodels = load_builtin_models("r73"), jload_models("r73")
    for kw in ({}, {"noise_scale": 0.5, "p_stay": 0.2, "p_skip": 0.25,
                    "params": (1.05, -2.0, 0.01, 1.1, 1.0, 1.0)}):
        rngs = (np.random.default_rng(21), np.random.default_rng(21))
        outs = []
        for mod, pm_mod, ms, rng in ((tsimulate, pore_model, models, rngs[0]),
                                     (simulate, jpore_model, jmodels, rngs[1])):
            args = dict(kw)
            if "params" in args:
                args["params"] = pm_mod.PoreModelParams(*args["params"])
            outs.append(mod.simulate_read(ms, "r73.t.006", comp, 900, rng,
                                          **args))
        got, want = outs
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[4].hairpin == want[4].hairpin == (comp is not None)
        assert got[4].base_seqs == want[4].base_seqs
        assert len(got[4].state_paths) == (2 if comp else 1)
        for a, b in zip(got[4].state_paths, want[4].state_paths):
            assert np.array_equal(a, b)
        assert rngs[0].random() == rngs[1].random()


def test_state_walks_and_identity_equal():
    for K_ in (3, 6):
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        assert np.array_equal(
            tsimulate._sample_state_walk(300, K_, 0.1, 0.3, a),
            simulate._sample_state_walk(300, K_, 0.1, 0.3, b))
        got = tsimulate.sample_state_walk_batch(5, 64, K_, 0.15, 0.25, a)
        want = simulate.sample_state_walk_batch(5, 64, K_, 0.15, 0.25, b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for x, y in (("ACGTTGCA", "ACGTGCA"), ("", "A"), ("AAAA", "AAAA")):
        assert tsimulate.identity(x, y) == simulate.identity(x, y)


@pytest.mark.parametrize("comp", [None, "r73.c.p1.006"], ids=["1d", "2strand"])
def test_write_sim_fast5_datasets_equal(tmp_path, comp):
    """write_sim_fast5 from one seed: the same truth, and the written files'
    datasets and attributes equal, group by group."""
    import h5py

    truths = []
    for mod, ms, name in ((tsimulate, load_builtin_models("r73"), "t"),
                          (simulate, jload_models("r73"), "j")):
        truths.append(mod.write_sim_fast5(
            str(tmp_path / f"{name}.fast5"), ms, "r73.t.006", comp, 500,
            np.random.default_rng(8), read_id="r0", noise_scale=0.5))
    assert truths[0].base_seqs == truths[1].base_seqs

    def items(path):
        out = {}
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                attrs = {k: obj.attrs[k] for k in obj.attrs}
                data = obj[()] if isinstance(obj, h5py.Dataset) else None
                out[name] = (attrs, data)
            f.visititems(visit)
        return out

    got, want = items(tmp_path / "t.fast5"), items(tmp_path / "j.fast5")
    assert sorted(got) == sorted(want) and len(want) >= 6
    for name, (attrs, data) in want.items():
        assert got[name][0] == attrs, name
        if data is not None:
            assert got[name][1].dtype == data.dtype, name
            assert np.array_equal(got[name][1], data), name
