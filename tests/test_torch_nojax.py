"""nanocall_tpu_torch runs without JAX and without the JAX package
nanocall_tpu, and never falls back from CUDA.

The CLI runs in a fresh interpreter, so the JAX and nanocall_tpu modules
this test process imports (tests/conftest.py) cannot hide an import made
by the port.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from nanocall_tpu import simulate
from nanocall_tpu.models import load_builtin_models

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the end of each CLI script: no module of jax or of nanocall_tpu (but
#: nanocall_tpu_torch) was loaded
_ASSERT_NO_JAX = (
    "assert rc == 0\n"
    "bad = sorted(m for m in sys.modules"
    " if m.split('.')[0] in ('jax', 'nanocall_tpu'))\n"
    "assert not bad, bad\n"
    "print('NOJAX_OK')\n")
#: an import of jax or of the JAX package in a source line
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|nanocall_tpu)\b", re.M)


def _run_python(code: str, *args) -> subprocess.CompletedProcess:
    # one intra-op thread: the suite runs several workers on one host
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast5")
    rng = np.random.default_rng(31)
    simulate.write_sim_fast5(d / "r.fast5", load_builtin_models("r73"),
                             "r73.t.006", None, 250, rng, read_id="r",
                             noise_scale=0.5)
    return d


def test_cli_runs_on_cpu_without_importing_jax(reads, tmp_path):
    out = tmp_path / "out.fa"
    proc = _run_python(
        "import sys\n"
        "from nanocall_tpu_torch.cli import main\n"
        "rc = main([sys.argv[1], '--no-train', '--pore', 'r73', '--device',"
        " 'cpu', '-t', '1', '-o', sys.argv[2]])\n"
        + _ASSERT_NO_JAX,
        reads, out)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout
    assert out.read_text().count(">") == 1


def test_trained_cli_runs_on_cpu_without_importing_jax(reads, tmp_path):
    """The default run trains by EM before the decode; still no jax."""
    out = tmp_path / "out.fa"
    proc = _run_python(
        "import sys\n"
        "from nanocall_tpu_torch.cli import main\n"
        "rc = main([sys.argv[1], '--pore', 'r73', '--device', 'cpu', '-t',"
        " '1', '-o', sys.argv[2]])\n"
        + _ASSERT_NO_JAX,
        reads, out)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout
    assert "scaling_result" in proc.stderr  # EM ran
    assert out.read_text().count(">") == 1


def test_trans_cli_runs_on_cpu_without_importing_jax(reads, tmp_path):
    """`-s/--trans`: the loaded table's EM rounds and decode; still no
    jax."""
    out = tmp_path / "out.fa"
    trans = tmp_path / "trans.tsv"
    proc = _run_python(
        "import sys\n"
        "from nanocall_tpu_torch import convert\n"
        "from nanocall_tpu_torch.cli import main\n"
        "convert.write_fast_transitions(sys.argv[3], 0.14, 0.21)\n"
        "rc = main([sys.argv[1], '--pore', 'r73', '--device', 'cpu', '-t',"
        " '1', '--scaling-max-rounds', '2', '-s', sys.argv[3], '-o',"
        " sys.argv[2]])\n"
        + _ASSERT_NO_JAX,
        reads, out, trans)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout
    assert "loaded state transitions from" in proc.stderr
    assert "scaling_result" in proc.stderr  # EM ran
    assert out.read_text().count(">") == 1


def test_tools_run_on_cpu_without_importing_jax(tmp_path):
    """`python -m nanocall_tpu_torch.tools run-viterbi ... --device cpu`
    (run as __main__ by runpy), then run-fwbw --custom-fwbw, the dev tools'
    K6a/K6b and K6e paths: still no jax and no nanocall_tpu."""
    from nanocall_tpu import events, pore_model, transitions

    K, n, T = 3, 64, 15
    rng = np.random.default_rng(4)
    lm = rng.uniform(40, 90, n).astype(np.float32)
    pore_model.save_tsv(pore_model.PoreModel(
        lm, rng.uniform(0.8, 2.0, n).astype(np.float32),
        rng.uniform(0.5, 1.5, n).astype(np.float32),
        rng.uniform(0.1, 0.4, n).astype(np.float32), K=K),
        tmp_path / "m.tsv")
    transitions.save_tsv(transitions.build_structured(K=K),
                         tmp_path / "s.tsv")
    events.save_tsv(events.EventSequence(
        rng.choice(lm, T) + rng.normal(0, 0.5, T), rng.uniform(0.5, 1.5, T),
        np.cumsum(rng.uniform(0.01, 0.05, T)), rng.uniform(0.01, 0.05, T)),
        tmp_path / "e.tsv")
    args = ["-p", tmp_path / "m.tsv", "-s", tmp_path / "s.tsv", "-e",
            tmp_path / "e.tsv", "-K", str(K), "--device", "cpu"]
    proc = _run_python(
        "import runpy, sys\n"
        "args = sys.argv[1:]\n"
        "sys.argv = ['tools', 'run-viterbi', *args]\n"
        "try:\n"
        "    runpy.run_module('nanocall_tpu_torch.tools', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "assert rc == 0\n"
        "from nanocall_tpu_torch import tools\n"
        "rc = tools.main(['run-fwbw', '--custom-fwbw', *args])\n"
        + _ASSERT_NO_JAX,
        *args)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "NOJAX_OK"
    assert set(lines[0]) <= set("ACGT") and len(lines[0]) >= K
    assert len(lines) >= 3  # a base string, posteriors, the marker


def test_device_cuda_without_gpu_raises(reads, tmp_path):
    proc = _run_python(
        "import sys, torch\n"
        "from nanocall_tpu_torch.cli import main\n"
        "assert not torch.cuda.is_available()\n"
        "main([sys.argv[1], '--no-train', '--pore', 'r73', '--device',"
        " 'cuda', '-t', '1', '-o', sys.argv[2]])\n",
        reads, tmp_path / "out.fa")
    assert proc.returncode != 0
    assert "RuntimeError: --device cuda: no CUDA device" in proc.stderr
    assert not (tmp_path / "out.fa").exists()


def test_package_source_names_no_jax():
    """No source of the port, nor its tools (the timing tool, the reshape
    repro), imports jax or the JAX package nanocall_tpu."""
    files = sorted((ROOT / "nanocall_tpu_torch").rglob("*.py"))
    assert len(files) >= 20
    pkg = ROOT / "nanocall_tpu_torch"
    assert {pkg / "simulate.py", pkg / "roofline.py", pkg / "ops" / "fma.py",
            pkg / "ops" / "repro.py", pkg / "shapes.py",
            pkg / "parallel" / "seqpar.py", pkg / "parallel" / "mesh.py",
            pkg / "parallel" / "multihost.py",
            pkg / "parallel" / "statepar.py"} <= set(files)
    tools = sorted((ROOT / "tools").glob("torch_*.py"))
    assert {t.name for t in tools} >= {"torch_decode_times.py",
                                       "torch_reshape_repro.py"}
    for f in [*files, *tools]:
        assert not _JAX_IMPORT.search(f.read_text()), f


def test_measurement_path_and_repro_run_on_cpu_without_importing_jax():
    """roofline.measure_fma_peak (K8's plain version), the simulator and
    tools/torch_reshape_repro.py (K10's) in a fresh interpreter: no jax and
    no nanocall_tpu."""
    proc = _run_python(
        "import runpy, sys\n"
        "import numpy as np\n"
        "from nanocall_tpu_torch import roofline, simulate\n"
        "from nanocall_tpu_torch.models import load_builtin_models\n"
        "rate, s = roofline.measure_fma_peak(2, 64, 4, k=3, n_iter=1,"
        " device='cpu')\n"
        "assert rate > 0\n"
        "simulate.simulate_read(load_builtin_models('r73'), 'r73.t.006',"
        " None, 50, np.random.default_rng(0))\n"
        "sys.argv = ['torch_reshape_repro.py', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_path('tools/torch_reshape_repro.py',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        + _ASSERT_NO_JAX)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith("PASS")
    assert proc.stdout.splitlines()[-1] == "NOJAX_OK"


def test_parallel_path_runs_on_cpu_without_importing_jax():
    """K9's plain version over 2 CPU ranks, a decode chunk over the data
    sharder of 2 CPU devices and placed on a 2 x 2 CPU mesh (the plain
    state-parallel decode, parallel/statepar.py), shapes.py and multihost's
    file partition in a fresh interpreter: no jax and no nanocall_tpu."""
    proc = _run_python(
        "import sys, torch\n"
        "from nanocall_tpu_torch import basecall, convert, shapes\n"
        "from nanocall_tpu_torch.config import Config\n"
        "from nanocall_tpu_torch.models import load_builtin_models\n"
        "from nanocall_tpu_torch.ops import hmm\n"
        "from nanocall_tpu_torch.parallel import mesh, multihost, seqpar\n"
        "cpu = torch.device('cpu')\n"
        "B, T = 2, 16\n"
        "gt = hmm.make_grouped_trans_device(torch.full((B,), 0.1),"
        " torch.full((B,), 0.3), 6)\n"
        "bank = convert.model_bank(load_builtin_models('r73'),"
        " ('r73.t.006',), cpu)\n"
        "pm = torch.tensor([[1.0, 0, 0, 1, 1, 1]] * B)\n"
        "model = hmm.make_scaled_model_arrays(bank,"
        " torch.zeros(B, dtype=torch.int32), pm)\n"
        "stdv = torch.ones(B, T)\n"
        "ev = {'mean': torch.full((B, T), 60.0), 'stdv': stdv,"
        " 'log_stdv': torch.log(stdv),"
        " 'length': torch.tensor([T, 5], dtype=torch.int32)}\n"
        "out = seqpar.viterbi_decode_seqpar(gt, model, ev, [cpu] * 2)\n"
        "assert out['path'].shape == (B, T)\n"
        "shards = basecall.decode_chunk_pooled(ev['mean'], stdv,"
        " torch.zeros(B, T), torch.arange(B), torch.zeros(B), bank,"
        " torch.zeros(B, dtype=torch.int32), pm,"
        " torch.tensor([[0.1, 0.3]] * B), ev['length'],"
        " sharder=mesh.DataSharder(devices=[cpu] * 2))\n"
        "assert torch.equal(mesh.join(shards)['logp'], out['logp'])\n"
        "placed = mesh.shard_pooled_decode_inputs(mesh.make_mesh(4, 2,"
        " devices=[cpu] * 4), ev['mean'], stdv, torch.zeros(B, T),"
        " torch.arange(B), torch.zeros(B), bank,"
        " torch.zeros(B, dtype=torch.int32), pm,"
        " torch.tensor([[0.1, 0.3]] * B), ev['length'])\n"
        "rows = basecall.decode_chunk_pooled(*placed)\n"
        "assert torch.equal(mesh.join(rows)['logp'], out['logp'])\n"
        "assert shapes.path_chunk_cap(Config(), 8192, 2) == 256\n"
        "assert multihost.partition_files(['a', 'b', 'c'], 1, 2) == ['c']\n"
        "rc = 0\n"
        + _ASSERT_NO_JAX)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "NOJAX_OK"


def test_generic_mesh_path_runs_on_cpu_without_importing_jax():
    """Per-read structured tables (transitions.build_structured_batch,
    convert.trans_ops_batch) and the generic decode placed on a 2 x 2 CPU
    mesh (mesh.shard_decode_inputs, statepar.viterbi_decode_placed: the
    plain K6am and K6bm) in a fresh interpreter, equal to the unplaced
    plain K6a + K6b: no jax and no nanocall_tpu."""
    proc = _run_python(
        "import sys, numpy as np, torch\n"
        "from nanocall_tpu_torch import convert, transitions\n"
        "from nanocall_tpu_torch.models import load_builtin_models\n"
        "from nanocall_tpu_torch.ops import hmm\n"
        "from nanocall_tpu_torch.parallel import mesh, statepar\n"
        "cpu = torch.device('cpu')\n"
        "B, T = 2, 6\n"
        "ops = convert.trans_ops_batch(*transitions.build_structured_batch("
        "np.array([[0.1, 0.3], [0.14, 0.21]]), 6), 6, cpu)\n"
        "pm = load_builtin_models('r73')['r73.t.006']\n"
        "model = hmm.make_model_arrays(*(torch.from_numpy(x) for x in ("
        "pm.level_mean, pm.level_stdv, pm.sd_mean, pm.sd_lambda)), B=B)\n"
        "stdv = torch.ones(B, T)\n"
        "ev = {'mean': torch.full((B, T), 60.0), 'stdv': stdv,"
        " 'log_stdv': torch.log(stdv),"
        " 'length': torch.tensor([T, 4], dtype=torch.int32)}\n"
        "want = hmm.viterbi_decode(ops, model, ev)\n"
        "got = mesh.join(statepar.viterbi_decode_placed(*mesh."
        "shard_decode_inputs(mesh.make_mesh(4, 2, devices=[cpu] * 4), ops,"
        " model, ev)))\n"
        "assert torch.equal(got['path'], want['path'])\n"
        "assert torch.equal(got['logp'], want['logp'])\n"
        "rc = 0\n"
        + _ASSERT_NO_JAX)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "NOJAX_OK"


def test_placed_em_round_and_dryrun_run_on_cpu_without_importing_jax():
    """The EM round placed on a 2 x 2 CPU mesh (mesh.shard_train_inputs,
    statepar.train_one_round_placed: the plain K4m and K5m), bit-equal to
    the unplaced round, and the port's dry run over 4 CPU devices
    (nanocall_tpu_torch.dryrun: all five of its steps) in a fresh
    interpreter: no jax and no nanocall_tpu."""
    proc = _run_python(
        "import sys, numpy as np, torch\n"
        "from nanocall_tpu_torch import dryrun, train\n"
        "from nanocall_tpu_torch.models import load_builtin_models\n"
        "from nanocall_tpu_torch.parallel import mesh, statepar\n"
        "cpu = torch.device('cpu')\n"
        "G, S, T = 2, 4, 5\n"
        "pm = load_builtin_models('r73')['r73.t.006']\n"
        "mdl = {k: torch.from_numpy(np.tile(getattr(pm, k), (G, 2, 1)))"
        " for k in ('level_mean', 'level_stdv', 'sd_mean', 'sd_lambda')}\n"
        "stdv = torch.ones(G, S, T)\n"
        "ev = {'mean': torch.full((G, S, T), 60.0), 'stdv': stdv,"
        " 'log_stdv': torch.log(stdv),"
        " 'start': torch.arange(T).float().expand(G, S, T) * 0.01,"
        " 'length': torch.full((G, S), T, dtype=torch.int32),"
        " 'strand': torch.tensor([[0, 0, 1, 1]] * G, dtype=torch.int32),"
        " 'valid': torch.ones(G, S, dtype=torch.bool)}\n"
        "p0 = torch.tensor([[1.0, 0, 0, 1, 1, 1]] * G)\n"
        "s0 = torch.tensor([[[0.1, 0.3]] * 2] * G)\n"
        "want = train.train_one_round(ev, mdl, p0, s0)\n"
        "got = mesh.join(statepar.train_one_round_placed(*mesh."
        "shard_train_inputs(mesh.make_mesh(4, 2, devices=[cpu] * 4), ev,"
        " mdl, p0, s0)))\n"
        "for k in want:\n"
        "    assert torch.equal(got[k], want[k]), k\n"
        "line = dryrun.dryrun_multichip(4, devices=[cpu] * 4)\n"
        "assert line.endswith('seqpar_exact=True pipeline_fasta_equal=True')\n"
        "rc = 0\n"
        + _ASSERT_NO_JAX)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "NOJAX_OK"


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A kernel build that fails raises; nothing falls back or is cached."""
    from nanocall_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "_nvcc", lambda: "/bin/false")
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.load()
    assert _cuda._lib is None
    assert not list(tmp_path.glob("*.so"))


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py reaches the system only through nanocall_tpu_torch."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert "nanocall_tpu_torch" in src
    assert not _JAX_IMPORT.search(src), _JAX_IMPORT.search(src)


def test_chip_smoke_keeps_no_counts_or_simulator_of_its_own():
    """The kernels' bounds and the reads come from the package
    (roofline.kernel_bound, simulate.simulate_read): chip_smoke.py defines
    neither a bound, CELL_OPS nor a read simulator."""
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("def bound(", "CELL_OPS", "def simulate_read(", "def _walk(",
                 "def _emit(", "def identity(", "PEAK_F32_PER_S"):
        assert name not in src, name
    assert "roofline.kernel_bound(" in src
    assert "simulate.simulate_read(" in src
