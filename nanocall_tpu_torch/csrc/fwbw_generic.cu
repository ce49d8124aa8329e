// K6c: exact log-space forward-backward under a loaded transition table.
//
// Replaces nanocall_tpu/ops/hmm.py fwbw (+ _logsumexp_slots and
// log_emission, inlined), two lax.scan bodies that XLA compiled for the
// TPU.  With lse(v) over the deg slots of a (deg, n) table written as
//   m = max over k of v[k] (NaN-propagating); safe = isfinite(m) ? m : 0
//   s = sum over k = 0, 1, .., deg-1 (added in that order) of exp(v[k] - safe)
//   lse = isfinite(m) ? safe + log(s) : m
// the forward, per step t = 1..T-1 and state j (n = 4096), is
//   alpha'[j] = t < length ? em(t, j) + lse(from_logp[k, j]
//                                           + alpha[from_idx[k, j]])
//                          : alpha[j]
// with alpha0 = em(0, j) - log(n), and the backward, for t = T-2 .. 0,
//   g[i]    = em(t+1, i) + beta[i]
//   beta[i] = t >= length-1 ? 0 : lse(to_logp[k, i] + g[to_idx[k, i]])
// with beta = 0 at T-1.  alpha, beta and em (B, T, n) are stored for every
// t (alpha rows past a read's length repeat its last alpha), and
// log_pr_data = mfin + log(sum_j exp(final[j] - mfin)), the sum as the
// pairwise tree of ops/hmm.py tree_sum.
//
// Design: one block per read, 1024 threads x 4 contiguous states, both
// passes in one launch with the time loops inside the block.  The gathered
// vector (alpha forward, g backward) lives in shared memory; the slot
// tables are read from L2 (int4 + float4 per slot and thread, coalesced
// over the states), twice per step, once for the max and once for the sum,
// so that the sum runs in the plain version's order.  The 6 scaled-model
// tables sit in registers and the backward recomputes em(t+1) from them
// (the same bits as the stored em).
//
// What bounds it: per step, 2 x deg x 32 KB of table reads from L2 per
// read, 2 x deg x 4096 shared-memory gathers, and deg exps per state; the
// 3 x 16 KB stores per step and read.  Only B of the 132 SMs work when
// B < 132.  Speed work (several reads per block sharing one table read, an
// online max) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

__global__ void __launch_bounds__(THREADS, 1)
fwbw_generic_kernel(const float* __restrict__ ev_mean,
                    const float* __restrict__ ev_stdv,
                    const float* __restrict__ ev_log_stdv,
                    const int32_t* __restrict__ length, int B, int T,
                    int deg_from, const int32_t* __restrict__ from_idx,
                    const float* __restrict__ from_logp, int deg_to,
                    const int32_t* __restrict__ to_idx,
                    const float* __restrict__ to_logp,
                    const float* __restrict__ level_mean,
                    const float* __restrict__ level_stdv,
                    const float* __restrict__ log_level_stdv,
                    const float* __restrict__ sd_mean,
                    const float* __restrict__ sd_lambda,
                    const float* __restrict__ log_sd_lambda, float log2pi,
                    float log_n, float* __restrict__ alphas,
                    float* __restrict__ betas, float* __restrict__ ems,
                    float* __restrict__ lpd) {
  __shared__ float sx[N];
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * N + 4 * tid;

  float r_lm[4], r_ls[4], r_lls[4], r_sm[4], r_slam[4], r_lsl[4];
  unpack4(r_lm, load4(level_mean + row));
  unpack4(r_ls, load4(level_stdv + row));
  unpack4(r_lls, load4(log_level_stdv + row));
  unpack4(r_sm, load4(sd_mean + row));
  unpack4(r_slam, load4(sd_lambda + row));
  unpack4(r_lsl, load4(log_sd_lambda + row));
  const int4* fidx = reinterpret_cast<const int4*>(from_idx) + tid;
  const float4* flp = reinterpret_cast<const float4*>(from_logp) + tid;
  const int4* tidx = reinterpret_cast<const int4*>(to_idx) + tid;
  const float4* tlp = reinterpret_cast<const float4*>(to_logp) + tid;
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];
  // (b, t, 4 tid) of a (B, T, n) output
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * N + 4 * tid;
  };
  auto em_at = [&](int t, float (&em)[4]) {
    const float x = evm[t], y = evs[t], ly = evl[t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      em[i] = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                       r_slam[i], r_lsl[i], log2pi);
  };

  // forward
  float a[4], em[4];
  em_at(0, em);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = em[i] - log_n;
    sx[4 * tid + i] = a[i];
  }
  store4(at(alphas, 0), a);
  store4(at(ems, 0), em);
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    float r[4];
    lse_slots(fidx, flp, deg_from, sx, r);
    em_at(t, em);
    if (t < len) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = em[i] + r[i];
    }
    store4(at(alphas, t), a);
    store4(at(ems, t), em);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) sx[4 * tid + i] = a[i];
    __syncthreads();
  }

  // log_pr_data of the final alpha
  {
    const float mx = warp_amax(amax(amax(a[0], a[1]), amax(a[2], a[3])));
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();
    float mfin = sMax[0];
#pragma unroll 8
    for (int w = 1; w < WARPS; ++w) mfin = amax(mfin, sMax[w]);
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

  // backward
  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  store4(at(betas, T - 1), beta);
  for (int t = T - 2; t >= 0; --t) {
    em_at(t + 1, em);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) sx[4 * tid + i] = em[i] + beta[i];
    __syncthreads();
    float r[4];
    lse_slots(tidx, tlp, deg_to, sx, r);
    const bool last = t >= len - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) beta[i] = last ? 0.0f : r[i];
    store4(at(betas, t), beta);
  }
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_generic(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg_from,
    const int32_t* from_idx, const float* from_logp, int deg_to,
    const int32_t* to_idx, const float* to_logp, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    float log2pi, float log_n, float* alphas, float* betas, float* ems,
    float* lpd, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    fwbw_generic_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_idx,
        from_logp, deg_to, to_idx, to_logp, level_mean, level_stdv,
        log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
        alphas, betas, ems, lpd);
  }
  return (int)cudaGetLastError();
}
