"""nanocall_tpu_torch: the nanocall_tpu basecaller on PyTorch and CUDA.

A port of the JAX package `nanocall_tpu` to PyTorch, with its hot loops
written by hand as CUDA kernels for Hopper (`csrc/`, built with nvcc for
sm_90a at first use).  The host-only modules (fast5 ingest, pore models,
events, batching, output, the native C++ helpers in `native/`, which g++
builds at first use) are this package's own copies; it imports nothing of
`nanocall_tpu` and never imports jax.

It runs the default pipeline: ingest, per-read EM training (the grouped
log-sum-exp forward and the fused backward with the M-step statistics),
model selection, model contests scored by the grouped Viterbi forward,
path decode of the winners with the grouped traceback (chunk by chunk in
time for buckets of 32768 events and more), and FASTA output; `--no-train`
skips the training.  Every device function takes an explicit device; CPU
tensors run the plain PyTorch version of each kernel, CUDA tensors run the
kernel.
"""


def _tune_allocator() -> None:
    """Keep large numpy buffers on the glibc heap instead of fresh mmaps.

    glibc munmaps freed allocations above the mmap threshold, so every
    large numpy allocation (each event-pool staging buffer) pays the
    kernel's page zeroing on first touch again.  Raising the mmap/trim
    thresholds makes the heap grow once to its high-water mark and be
    reused (nanocall_tpu/__init__.py does the same)."""
    import ctypes
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD = 1 GB
        libc.mallopt(-1, 2047 << 20)  # M_TRIM_THRESHOLD (int32 max-ish)
    except Exception:  # non-glibc platforms: best-effort no-op
        pass


_tune_allocator()
