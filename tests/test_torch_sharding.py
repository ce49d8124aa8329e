"""The port's data sharder (nanocall_tpu_torch.parallel.mesh.DataSharder)
over several CPU "devices" ([cpu] * k): sharded runs equal unsharded ones,
as tests/test_sharding.py holds the JAX package's over 8 virtual CPU
devices.

A sharded decode chunk equals the unsharded one bit for bit (path0, codes,
logp; and the sparse decode's path), for shard counts that do and do not
divide the batch.  A sharded EM chunk matches the unsharded one within
rtol 1e-5 and atol 1e-6 (tests/test_sharding.py:84-87).  The pipeline with
num_shards devices writes the FASTA of the unsharded port run and of the
JAX package's num_shards=8 run.
"""

import functools
import io
import threading

import numpy as np
import pytest
import torch

from nanocall_tpu import basecall as jbasecall, output as joutput, \
    read_pipeline as jread_pipeline, simulate
from nanocall_tpu.config import Config as JConfig
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu_torch import basecall, convert, ingest, output, shapes, \
    train, transitions
from nanocall_tpu_torch.config import Config
from nanocall_tpu_torch.models import load_builtin_models as tload_models
from nanocall_tpu_torch.ops import _cuda, hmm
from nanocall_tpu_torch.parallel import mesh
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


class CountingSharder(mesh.DataSharder):
    """Counts the chunks it cut, EM (an event dict first) and decode."""

    def __init__(self, n_devices=None, devices=None):
        super().__init__(n_devices, devices)
        self.cut = {"em": 0, "decode": 0}

    def shard(self, tree, batch_size: int) -> list:
        self.cut["em" if isinstance(tree[0], dict) else "decode"] += 1
        return super().shard(tree, batch_size)


def test_default_sharder_raises_without_a_gpu(monkeypatch):
    """DataSharder() shards over the visible GPUs: on a host without one
    it raises, and never picks the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no"):
        mesh.DataSharder()
    with pytest.raises(RuntimeError, match="no"):
        mesh.DataSharder(2)
    assert mesh.DataSharder(devices=[CPU] * 2).devices == [CPU] * 2


def test_sharder_splits_contiguously_and_replicates_the_rest():
    """n_devices caps the device list; batch-leading tensors split into
    contiguous, near-equal slices (empty ones left out), everything else
    whole, NamedTuples and ints kept."""
    s = mesh.DataSharder(3, devices=[CPU] * 8)
    assert s.active and s.n == 3 and s.align == 3
    assert not mesh.DataSharder(devices=[CPU]).active
    assert mesh.DataSharder(devices=[CPU]).align == 1
    assert mesh.local_devices("cpu") == [CPU]
    assert mesh.indexed("cpu") == CPU
    assert basecall.EventPool("cpu").device == CPU
    with pytest.raises(ValueError):
        mesh.DataSharder(devices=[])
    x = torch.arange(7 * 2).view(7, 2)
    table = torch.arange(5)
    gt = hmm.GroupedTrans(x, x, x, K=6)
    parts = s.shard({"x": x, "table": table, "gt": gt, "none": None}, 7)
    assert [p["x"].shape[0] for p in parts] == [3, 2, 2]
    assert torch.equal(torch.cat([p["x"] for p in parts]), x)
    for p in parts:
        assert p["x"].is_contiguous() and torch.equal(p["table"], table)
        assert p["gt"].K == 6 and torch.equal(p["gt"].stay_lp, p["x"])
        assert p["none"] is None
    assert [len(p["x"]) for p in s.shard({"x": x[:2]}, 2)] == [1, 1]
    assert shapes.shard_sizes(10, 4) == [3, 3, 2, 2]
    assert len(s.replicate(hmm.GroupedTrans(x, x, x, K=6), 2)) == 2
    joined = mesh.join([{"a": torch.ones(2)}, {"a": torch.zeros(1)}])
    assert torch.equal(joined["a"], torch.tensor([1.0, 1.0, 0.0]))


def test_launch_counts_are_exact_under_threads():
    """count_launch adds under a lock: no count is lost when the EM
    sharder's threads launch at once."""

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(20000):
            _cuda.count_launch(wrapper)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 80000


def _pooled_args(B: int, T: int, seed: int):
    """decode_chunk_pooled's inputs for B tasks of T events: both r73
    models, varied scaling and transitions, ragged lengths."""
    rng = np.random.default_rng(seed)
    models = tload_models("r73")
    names = ("r73.t.006", "r73.c.p1.006")
    pm = np.zeros((B, 6), np.float32)
    pm[:, [0, 3, 4, 5]] = 1.0
    pm[:, 1] = rng.uniform(-1, 1, B)
    stp = np.stack([rng.uniform(0.08, 0.12, B), rng.uniform(0.25, 0.35, B)],
                   axis=-1).astype(np.float32)
    lm = models["r73.t.006"].level_mean
    mean = (lm[rng.integers(0, 4096, (B, T))]
            + rng.normal(0, 1, (B, T))).astype(np.float32)
    return (convert.tensor(mean, CPU),
            convert.tensor(rng.uniform(0.5, 1.5, (B, T)), CPU),
            convert.tensor(np.cumsum(rng.uniform(0.01, 0.05, (B, T)), -1),
                           CPU),
            torch.arange(B), convert.tensor(np.full(B, 0.01), CPU),
            convert.model_bank(models, names, CPU),
            convert.tensor(np.arange(B) % 2, CPU, torch.int32),
            convert.tensor(pm, CPU), convert.tensor(stp, CPU),
            convert.tensor(rng.integers(T // 2, T + 1, B), CPU, torch.int32))


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("with_path", [True, False])
def test_sharded_decode_chunk_equals_unsharded(k, with_path):
    """The gathered batch decoded in k shards and joined: path0, codes and
    logp (logp alone score-only) bit-equal to the one-device decode."""
    args = _pooled_args(8, 48, 3)
    [want] = basecall.decode_chunk_pooled(*args, with_path=with_path)
    got = basecall.decode_chunk_pooled(
        *args, with_path=with_path,
        sharder=mesh.DataSharder(devices=[CPU] * k))
    assert isinstance(got, list) and len(got) == k
    got = mesh.join(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_sharded_sparse_decode_chunk_equals_unsharded():
    """Under a loaded table (the generic decode) the shards' paths and logp
    equal the one-device decode's."""
    args = _pooled_args(6, 24, 4)
    ops = convert.trans_ops(transitions.sparse_from_pairs(
        transitions.structured_to_pairs(transitions.build_structured(
            transitions.TransitionParams(0.14, 0.21), 6)), 6), CPU)
    [want] = basecall.decode_chunk_pooled(*args, sparse_ops=ops)
    got = mesh.join(basecall.decode_chunk_pooled(
        *args, sparse_ops=ops, sharder=mesh.DataSharder(devices=[CPU] * 4)))
    for key in ("path", "logp"):
        assert torch.equal(got[key], want[key]), key


def _em_batch(G: int, S: int, T: int, K: int, seed: int):
    """A training batch of G groups (as tests/test_sharding.py's), with a
    model bank of two entries."""
    rng = np.random.default_rng(seed)
    n = 4 ** K
    stdv = rng.uniform(0.5, 1.5, (G, S, T)).astype(np.float32)
    ev = {"mean": rng.uniform(40, 90, (G, S, T)).astype(np.float32),
          "stdv": stdv, "log_stdv": np.log(stdv),
          "start": np.cumsum(np.full((G, S, T), 0.02, np.float32), -1),
          "length": rng.integers(T // 2, T + 1, (G, S)).astype(np.int32),
          "strand": np.tile(np.arange(S) % 2, (G, 1)).astype(np.int32),
          "valid": np.ones((G, S), bool)}
    mdl = {"level_mean": rng.uniform(40, 90, (2, 2, n)),
           "level_stdv": rng.uniform(0.8, 2, (2, 2, n)),
           "sd_mean": rng.uniform(0.5, 1.5, (2, 2, n)),
           "sd_lambda": rng.uniform(2, 9, (2, 2, n)),
           "model_idx": np.arange(G) % 2}
    pm0 = np.tile(np.float32([1, 0, 0, 1, 1, 1]), (G, 1))
    st0 = np.tile(np.float32([0.1, 0.3]), (G, 2, 1))
    return convert.train_batch(ev, mdl, pm0, st0, CPU)


@pytest.mark.parametrize("resume", [False, True])
def test_sharded_em_chunk_matches_unsharded(resume):
    """_EMDriver's sharded chunk (run_em per device, one thread each,
    joined in group order) against train.run_em on the whole chunk:
    params and fit within rtol 1e-5, atol 1e-6; rounds and frozen flags
    equal; from fresh starts and from phase-1 carries."""
    G, K = 8, 3
    cfg = Config(kmer_size=K, scaling_max_rounds=3)
    drv = basecall._EMDriver([], {}, cfg, CPU,
                             sharder=mesh.DataSharder(devices=[CPU] * 4))
    batch = _em_batch(G, 4, 24, K, 1)
    caps = drv.em_cfg.caps([g % 3 == 0 for g in range(G)])
    state0 = None
    if resume:
        state0 = (np.full(G, -1e4, np.float32), np.arange(G) % 4 == 1,
                  np.ones(G, np.int32))
    want = train.run_em(*batch, drv.em_cfg, caps=caps, state0=state0,
                        round_limit=2)
    got = drv._run_sharded(batch, caps, state0, 2)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert torch.equal(a, b), i


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    """tests/test_sharding.py's pipeline reads: 8 1D reads of 250 events."""
    d = tmp_path_factory.mktemp("shard") / "reads"
    d.mkdir()
    models = load_builtin_models("r73")
    rng = np.random.default_rng(4)
    for i in range(8):
        simulate.write_sim_fast5(d / f"r{i}.fast5", models, "r73.t.006",
                                 None, 250, rng, read_id=f"r{i}",
                                 noise_scale=0.5)
    return d


@functools.lru_cache(maxsize=None)
def _port_fasta(d, num_shards: int, train: bool = False, n_reads: int = 8):
    """The port's pipeline over the first n_reads reads (template only,
    untrained unless `train`, then 1 EM round), its sharder over num_shards
    of 8 CPU devices: (FASTA text, stats text, chunks cut)."""
    cfg = Config(pore="r73", train=train, num_shards=num_shards,
                 ingest_workers=1, scaling_max_rounds=1).apply_pore_preset()
    cfg.template_only = True
    models = tload_models("r73")
    files = sorted(str(p) for p in d.glob("*.fast5"))[:n_reads]
    sharder = CountingSharder(cfg.num_shards, devices=[CPU] * 8)
    summaries, results = basecall.run_pipeline(
        ingest.ingest_stream(files, models, cfg), models, cfg, CPU,
        sharder=sharder)
    fa, st = io.StringIO(), io.StringIO()
    output.write_results_fasta(fa, results)
    output.write_stats(st, summaries)
    return fa.getvalue(), st.getvalue(), sharder.cut


@pytest.fixture(scope="module")
def jax_sharded_fasta(reads_dir):
    """JAX's test_sharded_pipeline_equals_single run, num_shards=8."""
    cfg = JConfig(pore="r73", train=False, num_shards=8).apply_pore_preset()
    cfg.template_only = True
    models = load_builtin_models("r73")
    files = jread_pipeline.init_files([str(reads_dir)])
    summaries = [jread_pipeline.summarize(f, models, cfg) for f in files]
    buf = io.StringIO()
    joutput.write_results_fasta(buf, jbasecall.basecall_reads(
        summaries, models, cfg))
    return buf.getvalue()


@pytest.mark.parametrize("num_shards", [3, 8])
def test_sharded_pipeline_equals_unsharded_and_jax(reads_dir,
                                                   jax_sharded_fasta,
                                                   num_shards):
    """num_shards of 8 CPU devices: the FASTA equals the unsharded port
    run's and JAX's num_shards=8 run's, and every decode chunk was cut."""
    one, _, cut1 = _port_fasta(reads_dir, 1)
    many, _, cut = _port_fasta(reads_dir, num_shards)
    assert cut1 == {"em": 0, "decode": 0} and cut["decode"] > 0
    assert many.count(">") == 8
    assert many == one == jax_sharded_fasta


def test_sharded_trained_pipeline_equals_unsharded(reads_dir):
    """A trained run of 4 reads over 2 shards: EM chunks of an even group
    count run one per device; FASTA and stats equal the unsharded run's."""
    one_fa, one_st, _ = _port_fasta(reads_dir, 1, train=True, n_reads=4)
    two_fa, two_st, cut = _port_fasta(reads_dir, 2, train=True, n_reads=4)
    assert cut["em"] > 0 and cut["decode"] > 0
    assert two_fa == one_fa and two_st == one_st
