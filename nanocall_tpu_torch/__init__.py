"""nanocall_tpu_torch: the nanocall_tpu basecaller on PyTorch and CUDA.

A port of the JAX package `nanocall_tpu` to PyTorch, with its hot loops
written by hand as CUDA kernels for Hopper (`csrc/`, built with nvcc for
sm_90a at first use).  The host-only modules (fast5 ingest, pore models,
events, batching, output, the native C++ helpers) are imported from
`nanocall_tpu` rather than copied; they import no JAX.

It runs the default pipeline: ingest, per-read EM training (the grouped
log-sum-exp forward and the fused backward with the M-step statistics),
model selection, model contests scored by the grouped Viterbi forward,
path decode of the winners with the grouped traceback, and FASTA output;
`--no-train` skips the training.  Every device function takes an explicit
device; CPU tensors run the plain PyTorch version of each kernel, CUDA
tensors run the kernel.

This package never imports jax.
"""
