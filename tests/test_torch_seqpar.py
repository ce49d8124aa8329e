"""K9, the sequence-parallel Viterbi decode, on the CPU: the port's
parallel.seqpar against nanocall_tpu.parallel.seqpar on the 8-device CPU
mesh, against the port's own chunked decode, and its states traceback
chunk against the JAX chunk's non-compact output.

The case is tests/test_seqpar.py's: B = 8 simulated reads of T = 128
events, ragged lengths, seed 5, the r73 template model and the prior
transitions.  Tolerances: against JAX, paths equal and logp within rtol
1e-5 (the jit rounding of tests/test_torch_tchunk.py: XLA reorders the
emission); against the port's own decode, logp bit-equal and paths equal
to the states its packed codes give (both run one step body).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nanocall_tpu import simulate, transitions as jtransitions
from nanocall_tpu.models import load_builtin_models
from nanocall_tpu.ops import hmm as jhmm
from nanocall_tpu.parallel import seqpar as jseqpar
from nanocall_tpu_torch import convert, native
from nanocall_tpu_torch.ops import hmm
from nanocall_tpu_torch.parallel import seqpar
from torch_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
B, T = 8, 128


@functools.lru_cache(maxsize=None)
def _case():
    """Both packages' inputs and JAX's single-device decode."""
    rng = np.random.default_rng(5)
    models = load_builtin_models("r73")
    model_j = jhmm.make_model_arrays(*models["r73.t.006"].state_arrays())
    gt_j = jhmm.make_grouped_trans(jtransitions.TransitionParams(), 6)
    mean = np.zeros((B, T), np.float32)
    stdv = np.zeros((B, T), np.float32)
    for b in range(B):
        m, s, _, _, _ = simulate.simulate_read(
            models, "r73.t.006", None, T, rng, noise_scale=0.5)
        mean[b], stdv[b] = m[:T], s[:T]
    lengths = np.array([128, 100, 65, 128, 33, 17, 128, 90], np.int32)
    ev = {"mean": mean, "stdv": stdv, "log_stdv": np.log(stdv),
          "length": lengths}

    def rows(x):  # the port's kernels take one (n,) table row per read
        return x.expand(B, -1).contiguous()

    gt_t = convert.grouped_trans(gt_j, CPU)
    gt_t = hmm.GroupedTrans(*(rows(x) for x in gt_t[:3]), K=6)
    model_t = hmm.ModelArrays(*(rows(x) for x in
                                convert.model_arrays(model_j, CPU)))
    ev_t = {k: convert.tensor(v, CPU, torch.int32 if k == "length"
                              else torch.float32) for k, v in ev.items()}
    return gt_j, model_j, ev, gt_t, model_t, ev_t


@functools.lru_cache(maxsize=None)
def _jax_seqpar(n_blocks: int):
    gt_j, model_j, ev, *_ = _case()
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    out = jseqpar.viterbi_decode_seqpar(gt_j, model_j, ev, mesh,
                                        n_blocks=n_blocks)
    return np.asarray(out["path"]), np.asarray(out["logp"])


def _assert_path_from_codes(path, ref, lengths):
    """Each read's path up to its length equals the states rebuilt from
    ref's packed codes; past it, the end state."""
    path = path.numpy().astype(np.int32)
    for b, L in enumerate(lengths.tolist()):
        want = native.path_from_packed_codes(
            int(ref["path0"][b]), ref["codes"][b].numpy(), L, 6)
        assert np.array_equal(path[b, :L], want), b
        assert (path[b, L - 1:] == path[b, L - 1]).all(), b


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_seqpar_8_ranks_matches_jax_8way_mesh(n_blocks):
    """devices=[cpu]*8 against JAX's K9 on the 8-device CPU mesh at every
    pipeline depth: paths equal (the clamped suffix past each length
    included), logp within rtol 1e-5."""
    *_, gt_t, model_t, ev_t = _case()
    got = seqpar.viterbi_decode_seqpar(gt_t, model_t, ev_t, [CPU] * 8,
                                       n_blocks=n_blocks)
    path_j, logp_j = _jax_seqpar(n_blocks)
    assert got["path"].dtype == torch.uint16
    assert got["path"].shape == (B, T) and got["logp"].shape == (B,)
    assert np.array_equal(got["path"].numpy().astype(np.int32),
                          path_j.astype(np.int32))
    np.testing.assert_allclose(got["logp"].numpy(), logp_j, rtol=1e-5)


@pytest.mark.parametrize("D,n_blocks", [(2, None), (2, 1), (4, 2), (4, 4)])
def test_seqpar_bit_equal_to_the_chunked_decode(D, n_blocks):
    """D ranks against the port's viterbi_decode_grouped_tchunk (in chunks
    of T/D, and of 48): logp bit-equal, paths equal to its codes' states."""
    *_, gt_t, model_t, ev_t = _case()
    got = seqpar.viterbi_decode_seqpar(gt_t, model_t, ev_t, [CPU] * D,
                                       n_blocks=n_blocks)
    for Tc in (T // D, 48):
        ref = hmm.viterbi_decode_grouped_tchunk(gt_t, model_t, ev_t, Tc)
        assert torch.equal(got["logp"], ref["logp"]), Tc
        _assert_path_from_codes(got["path"], ref, ev_t["length"])


def test_states_traceback_chunk_matches_jax():
    """The plain traceback chunk with compact=False, chunk by chunk on the
    same backpointers and carries, gives JAX's
    viterbi_traceback_grouped_chunk(compact=False) states and carries
    exactly; the rows of every chunk joined are the whole path."""
    gt_j, _, _, gt_t, model_t, ev_t = _case()
    Tc = 48
    alpha = None
    chunks = []
    for t0 in range(0, T, Tc):
        evc = {k: ev_t[k][:, t0:t0 + Tc] for k in ("mean", "stdv",
                                                    "log_stdv")}
        evc["length"] = ev_t["length"]
        alpha, bps = hmm.viterbi_forward_grouped_chunk_plain(
            gt_t, model_t, evc, alpha, t0)
        chunks.append((t0, bps))
    end = torch.argmax(alpha, dim=-1).to(torch.int32)
    s_t, s_j = end, jnp.asarray(end.numpy())
    rows = []
    for t0, bps in reversed(chunks):
        s_j, ys_j = jhmm.viterbi_traceback_grouped_chunk(
            gt_j, jnp.asarray(end.numpy()), s_j, jnp.asarray(bps.numpy()),
            t0, jnp.asarray(ev_t["length"].numpy()), compact=False)
        s_t, ys_t = hmm.viterbi_traceback_grouped_chunk_plain(
            6, end, s_t, bps, t0, ev_t["length"], compact=False)
        assert ys_t.dtype == torch.uint16 and ys_t.shape == bps.shape[:2]
        assert np.array_equal(s_t.numpy(), np.asarray(s_j)), t0
        assert np.array_equal(ys_t.numpy().astype(np.int32),
                              np.asarray(ys_j).astype(np.int32)), t0
        rows.insert(0, ys_t)
    path = torch.cat(rows).t()
    ref = hmm.viterbi_decode_grouped(gt_t, model_t, ev_t)
    _assert_path_from_codes(path, ref, ev_t["length"])


def test_rank_slice_chunk_equals_the_chunk_over_whole_rows():
    """A rank's step: the plain forward chunk over its contiguous copy of
    events [t0, t0+Tc) with the global t0 and a block of rows, equal to
    K3's chunk over the whole rows (what the kernel reads through ev_t0)."""
    *_, gt_t, model_t, ev_t = _case()
    t0, Tc, rows = 64, 32, slice(2, 6)
    carry, _ = hmm.viterbi_forward_grouped_chunk(gt_t, model_t, ev_t, None,
                                                 0, t0)
    whole = hmm.viterbi_forward_grouped_chunk(gt_t, model_t, ev_t, carry,
                                              t0, Tc)
    part = {k: ev_t[k][rows, t0:t0 + Tc].contiguous()
            for k in ("mean", "stdv", "log_stdv")}
    part["length"] = ev_t["length"][rows]
    sliced = hmm.viterbi_forward_grouped_chunk_plain(
        hmm.GroupedTrans(*(x[rows] for x in gt_t[:3]), K=6),
        hmm.ModelArrays(*(x[rows] for x in model_t)), part, carry[rows], t0)
    assert torch.equal(whole[0][rows], sliced[0])
    assert torch.equal(whole[1][:, rows], sliced[1])


def test_seqpar_shape_validation():
    """The JAX function's two ValueErrors, and no decode over devices that
    have neither kernels nor plain versions."""
    *_, gt_t, model_t, ev_t = _case()
    bad = {k: (v[:, :100] if k != "length" else v) for k, v in ev_t.items()}
    with pytest.raises(ValueError, match="not divisible"):
        seqpar.viterbi_decode_seqpar(gt_t, model_t, bad, [CPU] * 8)
    with pytest.raises(ValueError, match="n_blocks"):
        seqpar.viterbi_decode_seqpar(gt_t, model_t, ev_t, [CPU] * 8,
                                     n_blocks=3)
    with pytest.raises(ValueError, match="devices"):
        seqpar.viterbi_decode_seqpar(gt_t, model_t, ev_t,
                                     [CPU, torch.device("meta")])


def test_k9_kernel_wrappers_refuse_cpu_tensors():
    """The states traceback chunk's wrapper checks its buffer and takes
    CUDA tensors only: a CPU tensor never reaches a plain version through
    it."""
    Bk, Tc = 3, 9
    ints = torch.zeros(Bk, dtype=torch.int32)
    bps = torch.zeros((Tc, Bk, 4096), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint16"):
        hmm.traceback_chunk_states_kernel(
            6, ints, ints.clone(), bps, 0, ints,
            torch.zeros((Tc, Bk), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        hmm.traceback_chunk_states_kernel(
            6, ints, ints.clone(), bps, 0, ints,
            torch.zeros((Tc, 2 * Bk), dtype=torch.uint16)[:, :Bk])
    assert hmm.traceback_chunk_states_kernel.launches == 0


def test_seqpar_bound_counts_k3_forward_and_the_states_walk():
    """K9's bound: K3's forward chunk counts over all B x T events plus the
    states traceback's bytes (a bp byte, a uint16 state per event)."""
    from nanocall_tpu_torch import roofline

    assert roofline.viterbi_traceback_chunk_states_counts(4, 100) == \
        (4 * 100 + 16 * 4 + 2 * 4 * 100, 0.0)
    fb, fo = roofline.viterbi_forward_chunk_counts(4, 40960)
    tb, _ = roofline.viterbi_traceback_chunk_states_counts(4, 40960)
    t_ops = fo / roofline.H100_F32_OPS_PER_S
    assert (fb + tb) / roofline.H100_HBM_BYTES_PER_S < t_ops
    assert roofline.seqpar_bound(4, 40960) == {"bound_ms": 1e3 * t_ops,
                                               "bound_by": "operations"}
