// K8: the FMA chain that measures the card's float32 speed of light at the
// decode's own shape.
//
// Replaces the lax.scan chain of nanocall_tpu/roofline.py measure_fma_peak
// (:340): T steps, each k dependent x = x*c + d over a (B, n) float32
// carry; out is the carry after the last step.  Each multiply-add is an
// explicit __fmaf_rn, one FFMA that rounds once, so the library's
// -fmad=false (which keeps a*b+c apart in the other kernels) does not turn
// it into a multiply and an add.  The plain version (ops/fma.py) rounds
// once per FMA too, and the two are bit-equal on measure_fma_peak's inputs.
//
// Design: K1's layout (viterbi_forward.cu).  One block per row, 1024
// threads, the time loop inside the block; each thread keeps LANES = n /
// 1024 independent carries in registers (lane l of thread t is element
// t + 1024 l, so each load and store is coalesced).  The LANES chains of a
// thread interleave, which hides the FFMA latency behind the other lanes
// and the other warps.  The chain loop is unrolled by 24, the k matched to
// K1's step (roofline.matched_fma_k), so at that k a step is 24 x LANES
// FFMAs and one loop test.  The carry is written out at the end, so the
// chain cannot be elided.
//
// What bounds it: operations.  2k T n float32 ops per row against 8 n
// bytes moved; at B rows only B of the 132 SMs work, which is the point:
// the peak it measures is the one a one-block-per-read kernel can reach at
// that B.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 1024;

template <int LANES>
__global__ void __launch_bounds__(THREADS)
    fma_chain_kernel(const float* __restrict__ x, int n, int T, int k,
                     float c, float d, float* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * n;
  float v[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) v[l] = x[row + threadIdx.x + l * THREADS];
  for (int t = 0; t < T; ++t) {
#pragma unroll 24
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int l = 0; l < LANES; ++l) v[l] = __fmaf_rn(v[l], c, d);
    }
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) out[row + threadIdx.x + l * THREADS] = v[l];
}

}  // namespace

// Plain C entry for ctypes: n must be 1024, 2048, 4096 or 8192 (the
// wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int nc_fma_chain(const float* x, int B, int n, int T, int k,
                            float c, float d, float* out, int device,
                            void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (n / THREADS) {
      case 1:
        fma_chain_kernel<1><<<B, THREADS, 0, s>>>(x, n, T, k, c, d, out);
        break;
      case 2:
        fma_chain_kernel<2><<<B, THREADS, 0, s>>>(x, n, T, k, c, d, out);
        break;
      case 4:
        fma_chain_kernel<4><<<B, THREADS, 0, s>>>(x, n, T, k, c, d, out);
        break;
      case 8:
        fma_chain_kernel<8><<<B, THREADS, 0, s>>>(x, n, T, k, c, d, out);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
