"""nanocall_tpu_torch.roofline and K8's plain version against
nanocall_tpu.roofline, on the CPU.

The counting functions are copies and must give exactly what the JAX
package's give; the port's kernel bounds are pinned to the numbers
chip_smoke.py printed before they moved into the package; the FMA chain's
plain version, which rounds once per FMA, is held bit for bit to a numpy
loop and to the JAX package's chain (the CUDA kernel is held to it bit for
bit on the card: tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from nanocall_tpu import roofline as jroofline
from nanocall_tpu_torch import roofline
from nanocall_tpu_torch.ops import fma
from torch_helpers import one_torch_thread  # noqa: F401

#: the counting functions copied from nanocall_tpu/roofline.py:28-292
COPIED = ("log_emission_ops", "grouped_forward_ops_per_event",
          "grouped_traceback_ops_per_event", "decode_ops_per_event",
          "fwbw_grouped_fwd_ops_per_event", "fwbw_grouped_bwd_ops_per_event",
          "em_scaling_mstep_ops_per_event", "em_stats_einsum_macs_per_event",
          "em_st_mstep_ops_per_event", "em_ops_per_event",
          "em_hbm_bytes_per_event", "em_fused_bwd_ops_per_event",
          "em_fused_ops_per_event", "em_fused_hbm_bytes_per_event")

#: kernel_bound at the shapes of PERF.md's kernel table: exactly what
#: chip_smoke.bound returned before the counts moved into the package,
#: but for counts that follow a kernel's redesign
PINNED = {
    ("viterbi_forward_path", 128, 8192): (1.8389831985671643, "operations"),
    ("viterbi_forward_score", 128, 8192): (1.8389831985671643,
                                           "operations"),
    ("viterbi_traceback", 128, 8192): (0.0011741994029850747, "bytes"),
    ("viterbi_forward_chunk", 4, 8192): (0.057468224955223884,
                                         "operations"),
    ("fwbw_forward", 512, 128): (0.34329370746268656, "bytes"),
    # K5's count since it was repaired: what em_backward.cu reads and
    # writes (model rows, W, codebooks), not 15 (B, n) tables
    ("em_backward", 512, 128): (0.35173834507462687, "bytes"),
    # K6d's count since its redesign: model rows and codebooks, no tables
    ("fwbw_grouped_backward", 512, 128): (0.3358408214925373, "bytes"),
    ("viterbi_generic_forward_path", 128, 8192): (5.25652713838806,
                                                  "operations"),
    ("viterbi_generic_forward_score", 128, 8192): (3.910343359044776,
                                                   "operations"),
    ("viterbi_generic_traceback", 128, 8192): (0.0028171844776119404,
                                               "bytes"),
    ("fwbw_generic", 512, 128): (0.9772304047761194, "bytes"),
    ("fwbw_custom", 16, 2048): (0.8022975999999999, "bytes"),
}


@pytest.mark.parametrize("name", COPIED)
def test_counting_function_equal_to_jax(name):
    for n in (64, 1024, 4096):
        got, want = getattr(roofline, name)(n), getattr(jroofline, name)(n)
        assert got == want, (name, n)
        assert roofline.__dict__[name].__doc__ == \
            jroofline.__dict__[name].__doc__
    for flags in ((False, True), (True, False), (False, False)):
        assert roofline.em_ops_per_event(4096, *flags) == \
            jroofline.em_ops_per_event(4096, *flags)


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: k[0])
def test_kernel_bound_pinned(key):
    ms, by = PINNED[key]
    assert roofline.kernel_bound(*key) == {"bound_ms": ms, "bound_by": by}


def test_kernel_bound_k8_and_k10():
    """K8: B n 2k T operations over 67 TFLOP/s; K10: 2 x 16 KiB over
    3.35 TB/s; every kernel of ops/kernels.py has a counting function."""
    from nanocall_tpu_torch.ops import kernels

    b = roofline.kernel_bound("fma_chain", 128, 8192)
    assert b == {"bound_ms": 1e3 * (128 * 4096 * 48 * 8192 / 67e12),
                 "bound_by": "operations"}
    assert roofline.fma_chain_counts(16, 2048, k=4) == \
        (8 * 16 * 4096, 16 * 4096 * 8 * 2048)
    assert roofline.FMA_K == 24
    assert roofline.kernel_counts("fma_chain", 16, 2048) == \
        roofline.fma_chain_counts(16, 2048, k=24)
    b = roofline.kernel_bound("reshape_copy", 8, 512)
    assert b == {"bound_ms": 1e3 * (2 * 16384 / 3.35e12), "bound_by": "bytes"}
    assert {k.name for k in kernels.KERNELS} == set(roofline.KERNEL_COUNTS)


def test_table_kernels_count_their_slots():
    """Bytes per slot: 16 per state for both directions' int32 / float32
    tables (K6c's and K6e's streaming kernels), 8 for the from side (K6a's
    streaming kernel), 2 per state and a 64-byte codebook for the packed
    from side (K6a's resident kernel), 2 per state and four 64-byte
    codebooks for each packed side (K6c's and K6e's resident kernels), 2
    per state for the uint16 from-states (K6b's ring kernel); under per-read
    tables (at 8 reads) the shared int32 slot maps once and each read's
    float32 log-probs of both sides, or each read's packed sides; each
    redesigned kernel does its streaming twin's operations."""
    for name in roofline.TABLE_KERNELS:
        b21, b42 = (roofline.kernel_counts(name, 8, 64, deg=d)[0]
                    for d in (21, 42))
        per_slot = (8 * 2 * (2 * 4096 + 256)
                    if name in ("fwbw_resident_per_read",
                                "fwbw_custom_resident_per_read")
                    else 8 * 4096 + 8 * 8 * 4096
                    if name.endswith("_per_read")
                    else 2 * (2 * 4096 + 256)
                    if name in ("fwbw_resident", "fwbw_custom_resident")
                    else 2 * 4096 + 64 if "resident" in name
                    else 2 * 4096 if name.endswith("_ring")
                    else (16 if "fwbw" in name else 8) * 4096)
        assert b42 - b21 == per_slot * 21
    for kind in ("path", "score"):
        assert roofline.kernel_counts(f"viterbi_resident_forward_{kind}",
                                      128, 8192)[1] == \
            roofline.kernel_counts(f"viterbi_generic_forward_{kind}",
                                   128, 8192)[1]
    assert roofline.kernel_counts("fwbw_resident", 512, 128)[1] == \
        roofline.kernel_counts("fwbw_generic", 512, 128)[1]
    assert roofline.kernel_counts("fwbw_custom_resident", 16, 2048)[1] == \
        roofline.kernel_counts("fwbw_custom", 16, 2048)[1]
    assert roofline.kernel_counts("viterbi_generic_traceback_ring", 128,
                                  8192)[1] == \
        roofline.kernel_counts("viterbi_generic_traceback", 128, 8192)[1]


@pytest.mark.parametrize("name", ["fwbw_generic", "fwbw_resident",
                                  "fwbw_custom", "fwbw_custom_resident"])
def test_per_read_fwbw_counts_each_read_table(name):
    """K6c's and K6e's per-read instances count each read's own table:
    the streaming ones B x 2 sides x deg x 4096 float32 log-probs in place
    of the one table's 2 x deg x 4096 (the int32 slot maps stay shared),
    the resident ones B copies of the one table's packed sides; the same
    operations.  At one read a per-read instance moves what its one-table
    twin moves."""
    n, deg = 4096, 21
    for B, T in ((512, 128), (16, 2048), (1, 4000)):
        one, per = (roofline.kernel_counts(k, B, T)
                    for k in (name, f"{name}_per_read"))
        assert per[1] == one[1]
        extra = ((B - 1) * 2 * deg * (2 * n + 256) if "resident" in name
                 else (B - 1) * 2 * deg * n * 4)
        assert per[0] - one[0] == extra, (B, T)
    bound = roofline.kernel_bound(f"{name}_per_read", 512, 128)
    nbytes, ops = roofline.kernel_counts(f"{name}_per_read", 512, 128)
    assert bound["bound_ms"] == 1e3 * max(nbytes / 3.35e12, ops / 67e12)


def test_em_backward_counts_what_k5_moves():
    """K5's bytes at the EM chunk (512 rows x 128 events), part by part as
    csrc/em_backward.cu reads and writes them: events and lengths, the
    alphas, log Pr[data], the 6 model rows and W's 6 (W only when it trains
    scaling), 3 x 32 codebook floats a row, a pattern and a flag byte per
    state, x_unc and t_start, valid and the two log rates a row; red
    (B, T, 9), scal (B, 14) and st (B, 3) written."""
    B, T, n = 512, 128, 4096
    common = (12 * B * T + 4 * B + 4 * T * B * n + 4 * B + 384 * B + 2 * n
              + 8 * B * T + B + 8 * B + 36 * B * T + 4 * 14 * B + 4 * 3 * B)
    assert roofline.em_backward_counts(B, T)[0] == \
        common + 48 * B * n == 1178323456
    assert roofline.em_backward_counts(B, T, train_scaling=False)[0] == \
        common + 24 * B * n
    assert roofline.kernel_counts("em_backward", B, T) == \
        roofline.em_backward_counts(B, T)


def test_mfu_report_arithmetic():
    """As tests/test_roofline.py:111-117, against the H100's spec."""
    rep = roofline.mfu_report(128, 8192, 4096, decode_s=0.16,
                              fma_peak_ops_per_s=1e13)
    achieved = 128 * 8192 * roofline.decode_ops_per_event(4096)["total"] / 0.16
    assert rep["achieved_vpu_ops_per_s"] == achieved
    assert rep["mfu_vs_h100_f32_spec"] == achieved / 67e12
    assert rep["mfu_vs_measured_fma_peak"] == achieved / 1e13
    assert rep["measured_fma_peak_ops_per_s"] == 1e13
    want = jroofline.mfu_report(128, 8192, 4096, decode_s=0.16,
                                fma_peak_ops_per_s=1e13)
    for key in ("ops_per_event_per_row", "achieved_vpu_ops_per_s",
                "mfu_vs_measured_fma_peak"):
        assert rep[key] == want[key], key
    assert not any("v5e" in key for key in rep)
    assert "mfu_vs_measured_fma_peak" not in roofline.mfu_report(
        1, 10, 64, 1.0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_em_mfu_report_arithmetic(fused):
    """As tests/test_roofline.py:81-102, against the H100's peaks."""
    n = 4096
    rep = roofline.em_mfu_report(1.5e6, n, fma_peak_ops_per_s=3e12,
                                 fused=fused)
    ops = (roofline.em_fused_ops_per_event(n) if fused
           else roofline.em_ops_per_event(n))["total"]
    bts = 8 * n if fused else 9 * 4 * n
    assert rep["achieved_vpu_ops_per_s"] == 1.5e6 * ops
    assert rep["achieved_hbm_bytes_per_s"] == 1.5e6 * bts
    assert rep["mfu_vs_fma_peak"] == 1.5e6 * ops / 3e12
    assert rep["hbm_utilization_vs_spec"] == 1.5e6 * bts / 3.35e12
    assert rep["ceiling_events_per_s_compute"] == 3e12 / ops
    assert rep["ceiling_events_per_s_hbm"] == 3.35e12 / bts
    assert rep["binding_resource"] == (
        "hbm" if 3.35e12 / bts < 3e12 / ops else "compute")
    want = jroofline.em_mfu_report(1.5e6, n, fma_peak_ops_per_s=3e12,
                                   fused=fused)
    for key in ("ops_per_event_round", "hbm_bytes_per_event_round",
                "achieved_vpu_ops_per_s", "mfu_vs_fma_peak",
                "ceiling_events_per_s_compute"):
        assert rep[key] == want[key], key
    spec = roofline.em_mfu_report(1.5e6, n, fused=fused)
    assert spec["mfu_vs_fma_peak"] == 1.5e6 * ops / 67e12


def test_matched_fma_k_is_24_at_n_4096():
    """bench.py:200-201's k: the chain's per-step work matches K1's."""
    n = 4096
    assert roofline.matched_fma_k(n) == 24 == max(8, round(
        jroofline.grouped_forward_ops_per_event(n)["total"] / (2 * n)))


def test_kernel_shares():
    """A kernel's float32 rate is its count over the time, as a share of
    67 TFLOP/s and of a measured K8 peak (None without one)."""
    ops = roofline.kernel_counts("viterbi_forward_path", 16, 2048)[1]
    sh = roofline.kernel_shares("viterbi_forward_path", 16, 2048, 4.0, 5e12)
    assert sh == {"f32_ops_per_s": ops / 4e-3,
                  "share_of_f32_spec": ops / 4e-3 / 67e12,
                  "share_of_k8_peak": ops / 4e-3 / 5e12}
    assert roofline.kernel_shares("reshape_copy", 8, 512, 0.01) == {
        "f32_ops_per_s": 0.0, "share_of_f32_spec": 0.0,
        "share_of_k8_peak": None}


def _peak_inputs(B: int, n: int):
    """measure_fma_peak's inputs: x, c, d."""
    x = np.random.default_rng(0).uniform(0.9, 1.1, (B, n)).astype(np.float32)
    return x, np.float32(0.9999), np.float32(1e-4)


def test_plain_fma_chain_bit_equal_to_numpy_loop():
    """The plain version rounds once per FMA, as a numpy loop that forms
    x * c + d in float64 and rounds it to float32; on measure_fma_peak's
    inputs every float64 sum is exact (its TwoSum error is 0), so that
    rounding is the FMA's own, and it differs from rounding the product
    and the sum apart.  A counting chain (c = 1, d = 2^-10 from 0) is exact:
    T k d."""
    x, c, d = _peak_inputs(3, 64)
    T, k = 7, 5
    want, apart = x.copy(), x.copy()
    c64, d64 = np.float64(c), np.float64(d)
    for _ in range(T * k):
        p = want.astype(np.float64) * c64
        s = p + d64
        bp = s - d64
        assert not np.any((p - bp) + (d64 - (s - bp))), "inexact float64 sum"
        want = s.astype(np.float32)
        apart = apart * c + d
    assert want.dtype == apart.dtype == np.float32
    got = fma.fma_chain(torch.from_numpy(x), c, d, T, k)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, apart)
    assert np.array_equal(fma.fma_chain(torch.from_numpy(x), c, d, 0, k)
                          .numpy(), x)
    count = fma.fma_chain(torch.zeros((2, 8)), 1.0, 2.0**-10, T, k)
    assert torch.all(count == T * k * 2.0**-10)


def test_plain_fma_chain_bit_equal_to_the_jax_chain():
    """measure_fma_peak's chain (nanocall_tpu/roofline.py:370-377) restated
    under jax.lax.scan: XLA's CPU backend contracts x * c + d into one FMA,
    so on measure_fma_peak's inputs it equals the plain version bit for
    bit."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("T", "k"))
    def chain(x, c, d, T: int, k: int):
        def step(x, _):
            for _ in range(k):
                x = x * c + d
            return x, None
        x, _ = jax.lax.scan(step, x, None, length=T)
        return x

    B, n, T, k = 4, 256, 32, 4
    x, c, d = _peak_inputs(B, n)
    want = np.asarray(chain(jnp.asarray(x), jnp.asarray(c), jnp.asarray(d),
                            T, k))
    got = fma.fma_chain(torch.from_numpy(x), c, d, T, k).numpy()
    assert np.array_equal(got, want), float(np.abs(got - want).max())


def test_measure_fma_peak_on_the_cpu_next_to_jax():
    """measure_fma_peak(device="cpu") returns B n 2k T / seconds; JAX's at
    the same arguments (its CPU backend) only runs, with a positive
    rate."""
    B, n, T, k = 4, 256, 32, 4
    rate, seconds = roofline.measure_fma_peak(B, n, T=T, k=k, n_iter=2,
                                              device="cpu")
    assert seconds > 0 and rate == B * n * 2 * k * T / seconds
    jrate, jseconds = jroofline.measure_fma_peak(B, n, T=T, k=k, n_iter=1)
    assert jrate > 0 and jseconds > 0
    assert fma.fma_chain_kernel.launches == 0


def test_measure_fma_peak_without_device_needs_a_gpu(monkeypatch):
    """device=None means cuda: without a GPU it raises, and never runs the
    plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.measure_fma_peak(4, 1024, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.measure_fma_peak(4, 1024, 8, device="cuda")


def test_fma_chain_kernel_refuses_cpu_tensors_and_bad_shapes():
    x = torch.ones((2, 1024))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fma.fma_chain_kernel(x, 0.9999, 1e-4, 1, 1)
    with pytest.raises(ValueError, match="lanes"):
        fma.fma_chain_kernel(torch.ones((2, 100)), 0.9999, 1e-4, 1, 1)
    with pytest.raises(ValueError, match="float32"):
        fma.fma_chain_kernel(x.double(), 0.9999, 1e-4, 1, 1)
    with pytest.raises(ValueError, match="device"):
        fma.fma_chain(x.to("meta"), 0.9999, 1e-4, 1, 1)
    assert fma.fma_chain_kernel.launches == 0
