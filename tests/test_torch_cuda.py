"""Checks of the port's CUDA kernels that need the card (marker `cuda`).

Each test skips without a CUDA device.  The file imports neither JAX nor
nanocall_tpu, so it also runs on a machine that has only the port's
dependencies (tests/conftest.py imports JAX: pass --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same checks at the main path's full shapes; these
are small and quick.
"""

import numpy as np
import pytest
import torch

from nanocall_tpu_torch import convert, events, kmer, pore_model, tools, \
    transitions
from nanocall_tpu_torch.models import load_builtin_models
from nanocall_tpu_torch.ops import hmm


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k6_inputs(dev, B: int, T: int, lengths, seed: int):
    """The loaded 21-neighbour table of (0.14, 0.21), per-read scaled r73
    models and noisy events of random states, on `dev`."""
    rng = np.random.default_rng(seed)
    ops = convert.trans_ops(transitions.sparse_from_pairs(
        transitions.structured_to_pairs(transitions.build_structured(
            transitions.TransitionParams(0.14, 0.21), 6)), 6), dev)
    models = load_builtin_models("r73")
    bank = convert.model_bank(models, ("r73.t.006", "r73.c.p1.006"), dev)
    params = np.zeros((B, 6), np.float32)
    params[:, 0] = rng.uniform(0.95, 1.05, B)
    params[:, 1] = rng.uniform(-1.0, 1.0, B)
    params[:, 3:] = rng.uniform(0.9, 1.1, (B, 3))
    model = hmm.make_scaled_model_arrays(
        bank, convert.tensor(np.arange(B) % 2, dev, torch.int32),
        convert.tensor(params, dev))
    lm = models["r73.t.006"].level_mean
    seqs = [events.EventSequence(
        lm[rng.integers(0, 4096, L)] + rng.normal(0.0, 1.0, L),
        rng.uniform(0.6, 1.8, L), np.arange(L) / 4000.0, np.full(L, 0.002))
        for L in lengths]
    return ops, model, convert.event_batch(events.pad_batch(seqs, T), dev)


@pytest.mark.cuda
def test_fwbw_custom_kernel_bit_equal_on_the_card(card):
    """K6e bit-equal to its plain version on the same card (tolerance 0),
    lengths 0, 1, T-1 and T among the reads; one launch counted."""
    ops, model, ev = _k6_inputs(card, 4, 40, [40, 0, 1, 39], 3)
    want = hmm.fwbw_custom_plain(ops, model, ev)
    n0 = hmm.fwbw_custom_kernel.launches
    got = hmm.fwbw_custom(ops, model, ev)
    torch.cuda.synchronize()
    assert hmm.fwbw_custom_kernel.launches == n0 + 1
    for k in ("alpha", "beta", "gamma"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_tools_refuse_k3_on_the_card(card, tmp_path):
    """On the card the tools run the K = 6 kernels: `-K 3` raises their
    ValueError instead of falling back to the plain versions."""
    n = kmer.n_states(3)
    pore_model.save_tsv(pore_model.PoreModel(*(
        np.full(n, v, np.float32) for v in (80.0, 1.5, 1.0, 0.3)), K=3),
        tmp_path / "m.tsv")
    transitions.save_tsv(transitions.build_structured(K=3),
                         tmp_path / "s.tsv")
    events.save_tsv(events.EventSequence(*(np.full(9, v) for v in (
        80.0, 1.0, 0.0, 0.002))), tmp_path / "e.tsv")
    args = ["-p", str(tmp_path / "m.tsv"), "-s", str(tmp_path / "s.tsv"),
            "-e", str(tmp_path / "e.tsv"), "-K", "3", "--device", "cuda"]
    for tool in (["run-viterbi"], ["run-fwbw"], ["run-fwbw", "--custom-fwbw"]):
        with pytest.raises(ValueError, match="K=6"):
            tools.main([*tool, *args])


@pytest.mark.cuda
def test_fma_chain_kernel_bit_equal_on_the_card(card):
    """K8 bit-equal to its plain version (both round once per FMA:
    ops/fma.py) on measure_fma_peak's inputs at every lane count the
    kernel takes, and a counting run (x = 0, c = 1, d = 2^-10, exact in
    float32) equal to T k d in every lane; one launch each."""
    from nanocall_tpu_torch.ops import fma

    rng = np.random.default_rng(0)
    c, d = np.float32(0.9999), np.float32(1e-4)
    T, k = 8, 24
    for n in (1024, 2048, 4096, 8192):
        x = torch.from_numpy(rng.uniform(0.9, 1.1, (3, n)).astype(
            np.float32)).to(card)
        want = fma.fma_chain_plain(x, c, d, T, k)
        n0 = fma.fma_chain_kernel.launches
        got = fma.fma_chain(x, c, d, T, k)
        count = fma.fma_chain(torch.zeros_like(x), 1.0, 2.0**-10, T, k)
        torch.cuda.synchronize()
        assert fma.fma_chain_kernel.launches == n0 + 2
        assert torch.equal(got, want), n
        assert torch.all(count == T * k * 2.0**-10), n
    with pytest.raises(ValueError, match="lanes"):
        fma.fma_chain(torch.ones((2, 512), device=card), c, d, 1, 1)


@pytest.mark.cuda
def test_reshape_copy_kernel_bit_equal_on_the_card(card):
    """K10 bit-equal to x.reshape(R, M * L) at the repro's shape and a
    ragged one; one launch each."""
    from nanocall_tpu_torch.ops import repro

    rng = np.random.default_rng(1)
    for shape in ((8, 128, 4), (3, 5, 7)):
        x = torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(
            np.float32)).to(card)
        n0 = repro.reshape_copy_kernel.launches
        got = repro.reshape_copy(x)
        torch.cuda.synchronize()
        assert repro.reshape_copy_kernel.launches == n0 + 1
        assert torch.equal(got, x.reshape(shape[0], -1)), shape


@pytest.mark.cuda
def test_seqpar_kernels_bit_equal_on_the_card(card):
    """K9 over 2 and 4 ranks on one card (a stream each) against its plain
    version: path and logp bit-equal, logp bit-equal to K1's; D * M
    launches of each half."""
    from nanocall_tpu_torch.ops import hmm as khmm
    from nanocall_tpu_torch.parallel import seqpar

    _, model, ev = _k6_inputs(card, 4, 40, [40, 0, 1, 39], 5)
    gt = khmm.make_grouped_trans_device(
        torch.full((4,), 0.12, device=card),
        torch.full((4,), 0.28, device=card), 6)
    full = khmm.viterbi_decode_grouped(gt, model, ev)
    for D, M in ((2, 1), (2, 2), (4, 4)):
        want = seqpar.viterbi_decode_seqpar_plain(gt, model, ev, [card] * D,
                                                  M)
        n0 = (khmm.forward_chunk_kernel.launches,
              khmm.traceback_chunk_states_kernel.launches)
        got = seqpar.viterbi_decode_seqpar(gt, model, ev, [card] * D, M)
        torch.cuda.synchronize()
        assert khmm.forward_chunk_kernel.launches == n0[0] + D * M
        assert khmm.traceback_chunk_states_kernel.launches == n0[1] + D * M
        assert torch.equal(got["path"].int(), want["path"].int()), (D, M)
        assert torch.equal(got["logp"], want["logp"]), (D, M)
        assert torch.equal(got["logp"], full["logp"]), (D, M)


@pytest.mark.cuda
def test_kernel_launch_leaves_the_current_device(card):
    """A C entry makes its tensors' card current for the launch and hands
    the caller's device back: after launches on every visible card, the
    current device, and so where a bare "cuda" allocates, is unchanged.
    A run's pool and drivers hold their device indexed."""
    from nanocall_tpu_torch import basecall
    from nanocall_tpu_torch.ops import repro

    torch.cuda.set_device(0)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        got = repro.reshape_copy(torch.ones((2, 3, 4), device=dev))
        assert got.device == dev
        _, model, ev = _k6_inputs(dev, 2, 8, [8, 5], i)
        gt = hmm.make_grouped_trans_device(torch.full((2,), 0.1, device=dev),
                                           torch.full((2,), 0.3, device=dev),
                                           6)
        hmm.viterbi_decode_grouped(gt, model, ev)
        assert torch.cuda.current_device() == 0, i
        assert torch.empty(1, device="cuda").device == card, i
    torch.cuda.synchronize()
    assert basecall.EventPool("cuda").device == card
