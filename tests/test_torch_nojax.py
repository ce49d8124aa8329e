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
    """No source of the port, nor its timing tool, imports jax or the JAX
    package nanocall_tpu."""
    files = sorted((ROOT / "nanocall_tpu_torch").rglob("*.py"))
    assert len(files) >= 20
    for f in [*files, ROOT / "tools" / "torch_decode_times.py"]:
        assert not _JAX_IMPORT.search(f.read_text()), f


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
