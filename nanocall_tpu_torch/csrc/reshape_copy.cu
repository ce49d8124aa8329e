// K10: the row-major reshape copy of tools/exp_mosaic_repro.py.
//
// Replaces the one pl.pallas_call of the repository
// (tools/exp_mosaic_repro.py:31), whose kernel reads an (8, 128, 4)
// float32 block and stores it as (8, 512): the in-kernel shape cast that
// Mosaic refused ("unsupported shape cast") and that the fused Pallas
// grouped forward needed every step.  On Hopper there is no layout to
// infer: out[r, c] = x[r, c / L, c % L] for an (R, M, L) input and an
// (R, M L) output, one thread per output element.
//
// What bounds it: bytes (2 x 16 KiB at (8, 128, 4)), and at that size the
// launch itself.  It is on no user path; the repro tool
// (tools/torch_reshape_repro.py) runs it.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void reshape_copy_kernel(const float* __restrict__ x, int R, int M,
                                    int L, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int W = M * L;
  if (i >= R * W) return;
  const int r = i / W, c = i % W;
  out[i] = x[((size_t)r * M + c / L) * L + c % L];
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_reshape_copy(const float* x, int R, int M, int L,
                               float* out, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int count = R * M * L;
  if (count > 0) {
    reshape_copy_kernel<<<(count + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(x, R, M, L, out);
  }
  return (int)cudaGetLastError();
}
