// K6d: grouped log-sum-exp backward pass with the betas stored.
//
// Replaces the reverse lax.scan of nanocall_tpu/ops/hmm.py fwbw_grouped
// (bwd_step, + log_emission inlined), which XLA compiled for the TPU.  Per
// read (row) b, for t = T-2 down to 0, with beta = 0 after the last event:
//   g      = em(t+1, i) + beta[i];  m = max g;  G = exp(g - m)
//   sum4[c]  = G[4c] + G[4c+1] + G[4c+2] + G[4c+3]      (added in that order)
//   sum16[c] = G[16c] + ... + G[16c+15]                  (added in that order)
//   total  = e_stay G + e_step_to (sum4[i%1024] - H G)
//            + e_skip_to (sum16[i%256] - P2mH G - S5T sum4[i%1024])
//   beta[i] = t >= length-1 ? 0 : m + log(total)
// and betas (B, T, n) holds beta after each event (0 at T-1).  This is the
// beta recursion K5 (csrc/em_backward.cu) runs for the fused EM round; the
// legacy round of a --trans run needs the betas themselves, and no
// statistics.
//
// Design: one block per read, 1024 threads x 4 contiguous states, the time
// loop inside the block, as K4.  The 9 per-read tables live in registers;
// G, sum4 and sum16 in shared memory.  A thread's 4 states form one
// contiguous 4-block, so its sum4 is its own; sum16 and the tiled reads
// (i % 1024, i % 256) cross threads.
//
// What bounds it: per step, 3 block barriers, one exp and one log per
// state, the serial 16-term block sum (256 threads work while 768 wait),
// and the 16 KB beta store per read.  Only B of the 132 SMs work when
// B < 132.  Speed work (several reads per block, warp-level block sums,
// fewer barriers) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_grouped_backward_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"

namespace {

using namespace nc;

// bits of the per-state flag byte (ops/hmm.py GROUPED_BWD_FLAG_BITS)
constexpr unsigned F_H = 1u, F_P2 = 2u, F_S5T = 4u;

__global__ void __launch_bounds__(THREADS, 1)
fwbw_backward_kernel(const float* __restrict__ ev_mean,
                     const float* __restrict__ ev_stdv,
                     const float* __restrict__ ev_log_stdv,
                     const int32_t* __restrict__ length, int B, int T,
                     const float* __restrict__ e_stay,
                     const float* __restrict__ e_step_to,
                     const float* __restrict__ e_skip_to,
                     const float* __restrict__ level_mean,
                     const float* __restrict__ level_stdv,
                     const float* __restrict__ log_level_stdv,
                     const float* __restrict__ sd_mean,
                     const float* __restrict__ sd_lambda,
                     const float* __restrict__ log_sd_lambda,
                     const uint8_t* __restrict__ flags, float log2pi,
                     float* __restrict__ betas) {
  __shared__ float sG[N];
  __shared__ float sS4[N4];
  __shared__ float sS16[N16];
  __shared__ float sMax[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * N + 4 * tid;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_lls[4], r_sm[4],
      r_slam[4], r_lsl[4];
  unpack4(r_stay, load4(e_stay + row));
  unpack4(r_step, load4(e_step_to + row));
  unpack4(r_skip, load4(e_skip_to + row));
  unpack4(r_lm, load4(level_mean + row));
  unpack4(r_ls, load4(level_stdv + row));
  unpack4(r_lls, load4(log_level_stdv + row));
  unpack4(r_sm, load4(sd_mean + row));
  unpack4(r_slam, load4(sd_lambda + row));
  unpack4(r_lsl, load4(log_sd_lambda + row));
  const uint32_t fl = *reinterpret_cast<const uint32_t*>(flags + 4 * tid);

  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];
  float* out = betas + (size_t)b * T * N + 4 * tid;

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  *reinterpret_cast<float4*>(out + (size_t)(T - 1) * N) =
      make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t = T - 2; t >= 0; --t) {
    float g[4];
    {
      const float x = evm[t + 1], y = evs[t + 1], ly = evl[t + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[i] = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                        r_slam[i], r_lsl[i], log2pi) +
               beta[i];
    }
    const float mx = warp_amax(amax(amax(g[0], g[1]), amax(g[2], g[3])));
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();
    float m = sMax[0];
#pragma unroll 8
    for (int w = 1; w < WARPS; ++w) m = amax(m, sMax[w]);

    float G[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      G[i] = expf(g[i] - m);
      sG[4 * tid + i] = G[i];
    }
    sS4[tid] = ((G[0] + G[1]) + G[2]) + G[3];
    __syncthreads();
    if (tid < N16) {
      float s = sG[16 * tid];
#pragma unroll
      for (int k = 1; k < 16; ++k) s = s + sG[16 * tid + k];
      sS16[tid] = s;
    }
    __syncthreads();

    const bool last = t >= len - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * tid + i;
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      const float T4 = sS4[j & (N4 - 1)];
      const float T16 = sS16[j & (N16 - 1)];
      const float hG = (f & F_H) ? G[i] : 0.0f;
      const float p2G = (f & F_P2) ? G[i] : 0.0f;
      const float s5T4 = (f & F_S5T) ? T4 : 0.0f;
      const float total = (r_stay[i] * G[i] + r_step[i] * (T4 - hG)) +
                          r_skip[i] * ((T16 - p2G) - s5T4);
      beta[i] = last ? 0.0f : m + logf(total);
    }
    *reinterpret_cast<float4*>(out + (size_t)t * N) =
        make_float4(beta[0], beta[1], beta[2], beta[3]);
  }
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_backward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_stay,
    const float* e_step_to, const float* e_skip_to, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    const uint8_t* flags, float log2pi, float* betas, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && T > 0) {
    fwbw_backward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_stay, e_step_to,
        e_skip_to, level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, flags, log2pi, betas);
  }
  return (int)cudaGetLastError();
}
