// K4: grouped log-sum-exp forward over all T events of a read (the EM
// E-step's forward half).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw_grouped_forward (+ log_emission,
// inlined), a lax.scan body that XLA compiled for the TPU.  Per step
// t = 1..T-1 and destination state j (n = 4096, K = 6):
//   m      = max over j of alpha[j];  E[j] = exp(alpha[j] - m)
//   S4[c]  = sum over r = 0..3  of E[r*1024 + c]   (added in r order)
//   S16[c] = sum over r = 0..15 of E[r*256 + c]    (added in r order)
//   total  = e_stay[j] E[j] + e_step[j] (S4[j>>2] - H[j] E[j])
//            + e_skip[j] (S16[j>>4] - P2mH[j] E[j] - S5[j] S4[j>>2])
//   alpha'[j] = t < length ? (em(t, j) + m) + log(total) : alpha[j]
// with alpha0 = em(0, j) - log(n).  alphas[t] (T, B, n) holds the carry
// after event t, so rows past a read's length repeat its last alpha, as
// the JAX scan's ys do; without an alphas buffer nothing is stored per step.
// log_pr_data = mfin + log(sum_j exp(final[j] - mfin)), the sum as the
// pairwise tree of ops/hmm.py tree_sum.
//
// Design: one block per read, 1024 threads x 4 contiguous states, the time
// loop inside the block (one launch per EM round), as K1.  The 9 per-read
// tables live in registers; E, S4 and S16 in shared memory.  A thread's
// states 4t..4t+3 read S4[t] and S16[t>>2], so after the two strided column
// sums every thread finds its sums in one shared-memory word each.
//
// What bounds it: per step, 3 block barriers, one exp and one log per state,
// the serial 16-term column sum (256 threads work while 768 wait), and the
// 16 KB alpha store per read.  Only B of the 132 SMs work when B < 132.
// Speed work (several reads per block, warp-level column sums, fewer
// barriers) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_grouped_forward_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"

namespace {

using namespace nc;

// bits of the per-state flag byte (ops/hmm.py FWD_FLAG_BITS)
constexpr unsigned F_H = 1u, F_P2 = 2u, F_S5 = 4u;

__global__ void __launch_bounds__(THREADS, 1)
fwbw_forward_kernel(const float* __restrict__ ev_mean,
                    const float* __restrict__ ev_stdv,
                    const float* __restrict__ ev_log_stdv,
                    const int32_t* __restrict__ length, int B, int T,
                    const float* __restrict__ e_stay,
                    const float* __restrict__ e_step,
                    const float* __restrict__ e_skip,
                    const float* __restrict__ level_mean,
                    const float* __restrict__ level_stdv,
                    const float* __restrict__ log_level_stdv,
                    const float* __restrict__ sd_mean,
                    const float* __restrict__ sd_lambda,
                    const float* __restrict__ log_sd_lambda,
                    const uint8_t* __restrict__ flags, float log2pi,
                    float log_n, float* __restrict__ alphas,
                    float* __restrict__ lpd) {
  __shared__ float sE[N];
  __shared__ float sS4[N4];
  __shared__ float sS16[N16];
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * N + 4 * tid;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_lls[4], r_sm[4],
      r_slam[4], r_lsl[4];
  unpack4(r_stay, load4(e_stay + row));
  unpack4(r_step, load4(e_step + row));
  unpack4(r_skip, load4(e_skip + row));
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

  float a[4];
  {
    const float x = evm[0], y = evs[0], ly = evl[0];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                      r_slam[i], r_lsl[i], log2pi) -
             log_n;
    if (alphas != nullptr)
      *reinterpret_cast<float4*>(alphas + row) =
          make_float4(a[0], a[1], a[2], a[3]);
  }

  for (int t = 1; t < T; ++t) {
    float mx = warp_max(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])));
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();
    float m = sMax[0];
#pragma unroll 8
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, sMax[w]);
    float E[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      E[i] = expf(a[i] - m);
      sE[4 * tid + i] = E[i];
    }
    __syncthreads();
    {
      float s = sE[tid];
#pragma unroll
      for (int r = 1; r < 4; ++r) s = s + sE[r * N4 + tid];
      sS4[tid] = s;
    }
    if (tid < N16) {
      float s = sE[tid];
#pragma unroll
      for (int r = 1; r < 16; ++r) s = s + sE[r * N16 + tid];
      sS16[tid] = s;
    }
    __syncthreads();

    const float s4 = sS4[tid];
    const float s16 = sS16[tid >> 2];
    const float x = evm[t], y = evs[t], ly = evl[t];
    const bool active = t < len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      const float hE = (f & F_H) ? E[i] : 0.0f;
      const float p2E = (f & F_P2) ? E[i] : 0.0f;
      const float s5S4 = (f & F_S5) ? s4 : 0.0f;
      const float total = (r_stay[i] * E[i] + r_step[i] * (s4 - hE)) +
                          r_skip[i] * ((s16 - p2E) - s5S4);
      const float em = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                                r_slam[i], r_lsl[i], log2pi);
      if (active) a[i] = (em + m) + logf(total);
    }
    if (alphas != nullptr)
      *reinterpret_cast<float4*>(alphas + (size_t)t * B * N + row) =
          make_float4(a[0], a[1], a[2], a[3]);
  }

  // log_pr_data of the final alpha
  float mx = warp_max(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])));
  if (lane == 0) sMax[warp] = mx;
  __syncthreads();
  float mfin = sMax[0];
#pragma unroll 8
  for (int w = 1; w < WARPS; ++w) mfin = fmaxf(mfin, sMax[w]);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = expf(a[i] - mfin);
  const float ws = warp_tree_sum(quad_sum(v));
  if (lane == 0) sSum[warp] = ws;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_sum(sSum[lane]);
    if (lane == 0) lpd[b] = mfin + logf(s);
  }
}

}  // namespace

// Plain C entry for ctypes.  alphas == nullptr stores no per-step alphas
// (only log_pr_data).  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_stay,
    const float* e_step, const float* e_skip, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    const uint8_t* flags, float log2pi, float log_n, float* alphas,
    float* lpd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && T > 0) {
    fwbw_forward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_stay, e_step, e_skip,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, flags, log2pi, log_n, alphas, lpd);
  }
  return (int)cudaGetLastError();
}
