"""The port's hand-written CUDA kernels, in main-path order: each kernel's
wrapper (which carries its `launches` counter), its source, and the JAX
function it replaces."""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import em, hmm


class Kernel(NamedTuple):
    name: str
    wrapper: Callable  # carries the `launches` counter
    source: str  # path in the repository
    replaces: str  # file:line of the JAX kernel it replaces


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
    Kernel("viterbi_generic_traceback", hmm.generic_traceback_kernel,
           "nanocall_tpu_torch/csrc/viterbi_generic.cu",
           "nanocall_tpu/ops/hmm.py:714"),
    Kernel("fwbw_generic", hmm.fwbw_generic_kernel,
           "nanocall_tpu_torch/csrc/fwbw_generic.cu",
           "nanocall_tpu/ops/hmm.py:784"),
    Kernel("fwbw_grouped_backward", hmm.fwbw_backward_kernel,
           "nanocall_tpu_torch/csrc/fwbw_backward.cu",
           "nanocall_tpu/ops/hmm.py:1016"),
)


def reset_launches() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0
