// Device helpers shared by the kernels of nanocall_tpu_torch/csrc.
//
// Every kernel here gives one read (one row) to one block of 1024 threads,
// and thread t holds the 4 contiguous states 4t .. 4t+3 of the 4096.  The
// reductions below follow the plain PyTorch versions' fixed orders, so that
// with -fmad=false a kernel is bit-identical to its plain version:
//   - maxima are exact in any order;
//   - a full-width sum is the pairwise tree of ops/hmm.py tree_sum
//     (x[2i] + x[2i+1], level by level): each thread's 4 states, then the
//     warp's 32 threads by shuffles, then the 32 warps' sums in warp 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nc {

constexpr int N = 4096;
constexpr int N4 = N / 4;
constexpr int N16 = N / 16;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// log_emission in the op order of nanocall_tpu/ops/hmm.py:230-244
__device__ __forceinline__ float emission(float x, float y, float ly, float lm,
                                          float ls, float lls, float sm,
                                          float slam, float lsl,
                                          float log2pi) {
  const float a = (x - lm) / ls;
  const float lnorm = -lls - (log2pi + a * a) * 0.5f;
  const float b = (y - sm) / sm;
  const float linv = (lsl - log2pi - 3.0f * ly - slam * b * b / y) * 0.5f;
  return lnorm + linv;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void unpack4(float (&d)[4], const float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// torch.amax of two values: NaN-propagating (fmaxf drops a NaN)
__device__ __forceinline__ float amax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// the NaN-propagating max over the warp, in every lane (torch.amax)
__device__ __forceinline__ float warp_amax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = amax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// the max over the warp, in every lane
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// the pairwise-tree sum of the warp's 32 values, in lane 0 (other lanes
// hold partial sums)
__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// the pairwise-tree sum of a thread's 4 states
__device__ __forceinline__ float quad_sum(const float (&v)[4]) {
  return (v[0] + v[1]) + (v[2] + v[3]);
}

}  // namespace nc
