"""K10, the reshape copy of the repository's one Pallas kernel, against
that kernel on the CPU.

tools/exp_mosaic_repro.py builds its kernel as a closure inside main(), so
the test restates its two lines under pl.pallas_call(..., interpret=True),
which runs on the CPU.  The CUDA kernel is held to the plain version bit
for bit on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nanocall_tpu_torch.ops import repro

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _pallas_reshape(x: np.ndarray) -> np.ndarray:
    """tools/exp_mosaic_repro.py:26-33's kernel, interpreted."""
    def kernel(x_ref, o_ref):
        x = x_ref[...]  # (8, 128, 4)
        o_ref[...] = x.reshape(8, 512)

    fn = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("values", ["arange", "normal"])
def test_plain_reshape_copy_equal_to_the_pallas_kernel(values):
    if values == "arange":
        x = np.arange(8 * 128 * 4, dtype=np.float32).reshape(8, 128, 4)
    else:
        x = np.random.default_rng(5).normal(0.0, 1.0, (8, 128, 4)).astype(
            np.float32)
    want = _pallas_reshape(x)
    got = repro.reshape_copy(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 512)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, x.reshape(8, 512))


def test_reshape_copy_is_a_copy_and_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 3, 4))
    out = repro.reshape_copy(x)
    out[0, 0] = 1.0
    assert x[0, 0, 0] == 0.0
    with pytest.raises(ValueError, match="CUDA tensors"):
        repro.reshape_copy_kernel(x)
    with pytest.raises(ValueError, match=r"\(R, M, L\)"):
        repro.reshape_copy_kernel(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="float32"):
        repro.reshape_copy_kernel(x.double())
    with pytest.raises(ValueError, match="device"):
        repro.reshape_copy(x.to("meta"))
    assert repro.reshape_copy_kernel.launches == 0


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_reshape_repro", ROOT / "tools" / "torch_reshape_repro.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_repro_tool_on_the_cpu_prints_pass():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _load_tool().main(["--device", "cpu"])
    assert rc == 0
    assert buf.getvalue().startswith("PASS")


def test_repro_tool_exits_1_on_a_mismatch(monkeypatch):
    """A wrong copy prints FAIL and exits 1, as the original does."""
    monkeypatch.setattr(repro, "reshape_copy",
                        lambda x: repro.reshape_copy_plain(x).flip(1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _load_tool().main(["--device", "cpu"])
    assert rc == 1 and buf.getvalue().startswith("FAIL")


def test_repro_tool_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_tool().main([])
