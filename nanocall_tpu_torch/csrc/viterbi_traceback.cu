// K2: grouped Viterbi traceback into bit-packed 6-bit codes.
//
// Replaces nanocall_tpu/ops/hmm.py viterbi_traceback_grouped(compact=True)
// + _lookup_bp + grouped_from_state + _pack_codes.  Per read b:
//   end_state = first argmax of final_alpha[b], logp = its max;
//   for t = T-1 .. 1:
//     s_eff = t == length-1 ? end_state : s
//     k     = bps[t-1, b, s_eff]
//     real  = t <= length-1
//     s     = real ? from_state(k, s_eff) : s_eff
//     code[t-1] = real ? (k >> 6) << 4 | (s_eff & 15) : 0
//   path0 = s.
// Four codes pack into three little-endian bytes (code i of a group at bits
// [6i, 6i+6)), pad codes past T-1 are 0: the layout that
// nanocall_tpu.native.path_from_packed_codes reads.
//
// Design: one block per read.  All 1024 threads reduce the final alpha
// (4 states each, then warp shuffles, ties to the lower index, matching
// argmax's first occurrence); one thread then walks the read backwards.
// A direct byte load bps[t-1, b, s] replaces the TPU kernel's two-stage
// one-hot lookup.
//
// What bounds it: the walk is a chain of T dependent byte loads from device
// memory, one per event, so a read takes T load latencies; reads run in
// parallel, one block each.  Nothing here is tuned yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 4096;
constexpr int THREADS = 1024;

__device__ __forceinline__ void take_better(float& best, int& idx, float ob,
                                            int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
viterbi_traceback_kernel(const float* __restrict__ final_alpha,
                         const uint8_t* __restrict__ bps,
                         const int32_t* __restrict__ length, int B, int T,
                         int code_bytes, int32_t* __restrict__ path0,
                         uint8_t* __restrict__ codes,
                         float* __restrict__ logp) {
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* fa = final_alpha + (size_t)b * N;

  float best = fa[4 * tid];
  int idx = 4 * tid;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float v = fa[4 * tid + i];
    if (v > best) {
      best = v;
      idx = 4 * tid + i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_better(best, idx, ob, oi);
  }
  if ((tid & 31) == 0) {
    w_best[tid >> 5] = best;
    w_idx[tid >> 5] = idx;
  }
  __syncthreads();
  if (tid >= 32) return;
  best = w_best[tid];
  idx = w_idx[tid];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_better(best, idx, ob, oi);
  }
  if (tid != 0) return;

  const int end_state = idx;
  logp[b] = best;
  const int len = length[b];
  uint8_t* out = codes + (size_t)b * code_bytes;
  const size_t row_stride = (size_t)B * N;
  const uint8_t* bp_b = bps + (size_t)b * N;
  int s = end_state;
  uint32_t w = 0;
  for (int t = T - 1; t >= 1; --t) {
    const int s_eff = t == len - 1 ? end_state : s;
    const int k = bp_b[(size_t)(t - 1) * row_stride + s_eff];
    const bool real = t <= len - 1;
    const int group = k >> 6;
    const int arg = k & 63;
    const int s_prev = group == 0   ? s_eff
                       : group == 1 ? ((arg << 10) | (s_eff >> 2))
                                    : ((arg << 8) | (s_eff >> 4));
    s = real ? s_prev : s_eff;
    const uint32_t code = real ? (uint32_t)((group << 4) | (s_eff & 15)) : 0u;
    const int i = t - 1;
    w |= code << (6 * (i & 3));
    if ((i & 3) == 0) {
      const int g = i >> 2;
      out[3 * g] = (uint8_t)(w & 0xff);
      out[3 * g + 1] = (uint8_t)((w >> 8) & 0xff);
      out[3 * g + 2] = (uint8_t)((w >> 16) & 0xff);
      w = 0;
    }
  }
  path0[b] = s;
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback(const float* final_alpha,
                                    const uint8_t* bps, const int32_t* length,
                                    int B, int T, int code_bytes,
                                    int32_t* path0, uint8_t* codes,
                                    float* logp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    viterbi_traceback_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, code_bytes, path0, codes, logp);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
