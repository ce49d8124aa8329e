"""The port's hand-written CUDA kernels, in main-path order (K9's
traceback chunk after K3's, then K1m and K2m, K1 and K2 with the states
split over a mesh's ranks, the redesigned kernels of K6a, K6b, K6c and
K6e after their streaming ones, K6am (its two forms) and K6bm, K6a and
K6b with the states split over a mesh's ranks, K4m and K5m, K4 and K5
with the states split over a mesh's ranks, then the measurement path's K8
and the repro tool's K10): each kernel's wrapper (which carries its
`launches` counter), its source, and the JAX function it replaces."""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import em, fma, hmm, repro


class Kernel(NamedTuple):
    name: str
    wrapper: Callable  # carries the `launches` counter
    source: str  # path in the repository
    # file:line of the JAX kernel it replaces (K1m and K2m: K1's and K2's
    # step and walk under shard_pooled_decode_inputs' state placement;
    # K6am and K6bm: K6a's and K6b's, viterbi_forward and
    # viterbi_traceback, under shard_decode_inputs',
    # nanocall_tpu/parallel/mesh.py:75; K4m and K5m: K4's and K5's,
    # fwbw_grouped_forward and _fused_bwd_mstats, under
    # shard_train_inputs', nanocall_tpu/parallel/mesh.py:126)
    replaces: str


KERNELS = (
    Kernel("viterbi_forward_path", hmm.forward_path_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/ops/hmm.py:286"),
    Kernel("viterbi_forward_score", hmm.forward_score_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/ops/hmm.py:598"),
    Kernel("viterbi_traceback", hmm.traceback_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/ops/hmm.py:517"),
    Kernel("viterbi_forward_chunk", hmm.forward_chunk_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/ops/hmm.py:389"),
    Kernel("viterbi_traceback_chunk", hmm.traceback_chunk_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/ops/hmm.py:437"),
    Kernel("viterbi_traceback_chunk_states", hmm.traceback_chunk_states_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/parallel/seqpar.py:40"),
    Kernel("viterbi_forward_slice", hmm.forward_wave_kernel,
           "nanocall_tpu_torch/csrc/viterbi_forward.cu",
           "nanocall_tpu/parallel/mesh.py:103"),
    Kernel("viterbi_traceback_slices", hmm.traceback_slices_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/parallel/mesh.py:103"),
    Kernel("fwbw_forward", hmm.fwbw_forward_kernel,
           "nanocall_tpu_torch/csrc/fwbw_forward.cu",
           "nanocall_tpu/ops/hmm.py:890"),
    Kernel("em_backward", em.em_backward_kernel,
           "nanocall_tpu_torch/csrc/em_backward.cu",
           "nanocall_tpu/train.py:159"),
    Kernel("viterbi_generic_forward_path", hmm.generic_forward_path_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:673"),
    Kernel("viterbi_generic_forward_score", hmm.generic_forward_score_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:759"),
    Kernel("viterbi_resident_forward_path", hmm.resident_forward_path_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:673"),
    Kernel("viterbi_resident_forward_score",
           hmm.resident_forward_score_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:759"),
    Kernel("viterbi_generic_traceback", hmm.generic_traceback_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:714"),
    Kernel("viterbi_generic_traceback_ring",
           hmm.generic_traceback_ring_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/ops/hmm.py:714"),
    Kernel("fwbw_generic", hmm.fwbw_generic_kernel,
           "nanocall_tpu_torch/csrc/fwbw_generic.cu",
           "nanocall_tpu/ops/hmm.py:784"),
    Kernel("fwbw_resident", hmm.fwbw_resident_kernel,
           "nanocall_tpu_torch/csrc/fwbw_generic.cu",
           "nanocall_tpu/ops/hmm.py:784"),
    Kernel("fwbw_grouped_backward", hmm.fwbw_backward_kernel,
           "nanocall_tpu_torch/csrc/fwbw_backward.cu",
           "nanocall_tpu/ops/hmm.py:1016"),
    Kernel("fwbw_custom", hmm.fwbw_custom_kernel,
           "nanocall_tpu_torch/csrc/fwbw_custom.cu",
           "nanocall_tpu/ops/hmm.py:1047"),
    Kernel("fwbw_custom_resident", hmm.fwbw_custom_resident_kernel,
           "nanocall_tpu_torch/csrc/fwbw_custom.cu",
           "nanocall_tpu/ops/hmm.py:1047"),
    Kernel("viterbi_generic_wave_resident", hmm.generic_wave_resident_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:673"),
    Kernel("viterbi_generic_wave_streaming",
           hmm.generic_wave_streaming_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:673"),
    Kernel("viterbi_generic_traceback_slices",
           hmm.generic_traceback_slices_kernel,
           "nanocall_tpu_torch/csrc/viterbi_traceback.cu",
           "nanocall_tpu/ops/hmm.py:714"),
    Kernel("fwbw_forward_wave", hmm.fwbw_forward_wave_kernel,
           "nanocall_tpu_torch/csrc/fwbw_forward.cu",
           "nanocall_tpu/ops/hmm.py:890"),
    Kernel("em_backward_wave", em.em_backward_wave_kernel,
           "nanocall_tpu_torch/csrc/em_backward.cu",
           "nanocall_tpu/train.py:159"),
    Kernel("fma_chain", fma.fma_chain_kernel,
           "nanocall_tpu_torch/csrc/fma_chain.cu",
           "nanocall_tpu/roofline.py:340"),
    Kernel("reshape_copy", repro.reshape_copy_kernel,
           "nanocall_tpu_torch/csrc/reshape_copy.cu",
           "tools/exp_mosaic_repro.py:31"),
)


def reset_launches() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0
