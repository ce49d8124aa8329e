// K10: the row-major reshape copy of tools/exp_mosaic_repro.py.
//
// Replaces the one pl.pallas_call of the repository
// (tools/exp_mosaic_repro.py:31), whose kernel reads an (8, 128, 4)
// float32 block and stores it as (8, 512): the in-kernel shape cast that
// Mosaic refused ("unsupported shape cast") and that the fused Pallas
// grouped forward needed every step.  On Hopper there is no layout to
// infer: the input is contiguous, so the (R, M L) output is its R M L
// floats in order.  Each thread copies 16 B (one float4 load and store),
// so (8, 128, 4) is one block of 1024 threads; when the count is not a
// multiple of 4, or a pointer is not 16-byte aligned (a view into another
// tensor), the threads past the float4s copy the rest one float each.
//
// What bounds it: bytes (2 x 16 KiB at (8, 128, 4)), and at that size the
// launch itself: the host's enqueue (ops/repro.py keeps its wrapper to what
// a PyTorch copy does per call).  It is on no user path; the repro tool
// (tools/torch_reshape_repro.py) runs it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 1024;

// threads [0, n4) copy float4 i; threads [n4, n4 + rest) one float each
// from float 4 n4 on
__global__ void __launch_bounds__(THREADS)
reshape_copy_kernel(const float* __restrict__ x, int n4, int rest,
                    float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    reinterpret_cast<float4*>(out)[i] =
        __ldg(reinterpret_cast<const float4*>(x) + i);
  } else if (i < n4 + rest) {
    out[3 * n4 + i] = __ldg(x + 3 * n4 + i);
  }
}

}  // namespace

// Plain C entry for ctypes: count = R M L floats.  Returns
// cudaGetLastError() after the launch.
extern "C" int nc_reshape_copy(const float* x, int count, float* out,
                               int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const int n4 = aligned ? count / 4 : 0;
  const int rest = count - 4 * n4;
  if (count > 0) {
    reshape_copy_kernel<<<(n4 + rest + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(x, n4, rest, out);
  }
  return (int)cudaGetLastError();
}
