// K6e: per-step-normalized forward-backward under a loaded transition table
// (the dev tool `run-fwbw --custom-fwbw`).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw_custom (Forward_Backward_Custom.hpp,
// with log_emission inlined), two lax.scan bodies that XLA compiled for the
// TPU.  With lse(v) the slot log-sum-exp of K6c (common.cuh lse_slots) and
//   norm(x) = x - (m + log(s)),  m = max over the n = 4096 states of x
//             (NaN-propagating, no -inf guard),  s = sum of exp(x - m) as
//             the pairwise tree of ops/hmm.py tree_sum,
// the forward, per read, is
//   alpha_0 = -log(n);  beta_0 = norm(em(0) + alpha_0)
//   alpha_t = lse(from_logp[k, j] + beta_{t-1}[from_idx[k, j]])
//   beta_t  = t < length ? norm(em(t) + alpha_t) : beta_{t-1}
// for t = 1..T-1, and the backward
//   gamma_{T-1} = beta_{T-1}
//   gamma_t = t >= length-1 ? beta_t
//           : beta_t + lse(to_logp[k, i] + (gamma_{t+1} - alpha_{t+1})[to_idx[k, i]])
// for t = T-2 .. 0.  alpha, beta and gamma (B, T, n) are stored for every t,
// alpha_t as computed also past the read's length.
//
// Design: as K6c, one block per read, 1024 threads x 4 contiguous states,
// both passes in one launch with the time loops inside the block.  The
// gathered vector (beta forward, gamma - alpha backward) lives in shared
// memory; the slot tables are read from L2 by lse_slots.  norm adds two
// block reductions per forward step, the max and the tree sum, each over the
// 32 warps' partials in shared memory; every warp reduces the partials
// itself, so each reduction costs one barrier.  The backward reads
// alpha_{t+1} and beta_t back from the outputs: each thread reads only the
// columns it stored, so they need no barrier.
//
// What bounds it: per step, 2 x deg x 32 KB of table reads from L2 per read,
// deg x 4096 shared-memory gathers and deg exps per state (plus one for
// norm), three barriers per forward step and two per backward step; the
// 3 x 16 KB of stores per step and the 2 x 16 KB of reloads per backward
// step.  Only B of the 132 SMs work when B < 132.  Speed work is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_custom_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

// norm(x) over the block's 4096 states, for the thread's 4 of them; sMax and
// sSum hold the warps' partial maxima and sums.  Every thread must call it.
__device__ __forceinline__ void block_norm(const float (&x)[4],
                                           float (&out)[4], float* sMax,
                                           float* sSum, int lane, int warp) {
  const float wm = warp_amax(amax(amax(x[0], x[1]), amax(x[2], x[3])));
  if (lane == 0) sMax[warp] = wm;
  __syncthreads();
  const float m = warp_amax(sMax[lane]);
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = expf(x[i] - m);
  const float ws = warp_tree_sum(quad_sum(e));
  if (lane == 0) sSum[warp] = ws;
  __syncthreads();
  const float s = __shfl_sync(FULL, warp_tree_sum(sSum[lane]), 0);
  const float c = m + logf(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = x[i] - c;
}

__global__ void __launch_bounds__(THREADS, 1)
fwbw_custom_kernel(const float* __restrict__ ev_mean,
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
                   float* __restrict__ betas, float* __restrict__ gammas) {
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

  // forward: a = alpha_t, bt = beta_t (the carry)
  float a[4], bt[4], em[4], x[4];
  em_at(0, em);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = -log_n;
    x[i] = em[i] + a[i];
  }
  block_norm(x, bt, sMax, sSum, lane, warp);
  store4(at(alphas, 0), a);
  store4(at(betas, 0), bt);
#pragma unroll
  for (int i = 0; i < 4; ++i) sx[4 * tid + i] = bt[i];
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    lse_slots(fidx, flp, deg_from, sx, a);
    em_at(t, em);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = em[i] + a[i];
    float nb[4];
    // its barriers also order every thread's gathers from sx before the
    // stores into sx below
    block_norm(x, nb, sMax, sSum, lane, warp);
    if (t < len) {
#pragma unroll
      for (int i = 0; i < 4; ++i) bt[i] = nb[i];
    }
    store4(at(alphas, t), a);
    store4(at(betas, t), bt);
#pragma unroll
    for (int i = 0; i < 4; ++i) sx[4 * tid + i] = bt[i];
    __syncthreads();
  }

  // backward: gm = gamma_t, from gamma_{T-1} = beta_{T-1}
  float gm[4] = {bt[0], bt[1], bt[2], bt[3]};
  store4(at(gammas, T - 1), gm);
  for (int t = T - 2; t >= 0; --t) {
    float an[4], bb[4];
    unpack4(an, *reinterpret_cast<const float4*>(at(alphas, t + 1)));
    unpack4(bb, *reinterpret_cast<const float4*>(at(betas, t)));
    __syncthreads();  // the previous step's gathers from sx are done
#pragma unroll
    for (int i = 0; i < 4; ++i) sx[4 * tid + i] = gm[i] - an[i];
    __syncthreads();
    float r[4];
    lse_slots(tidx, tlp, deg_to, sx, r);
    const bool last = t >= len - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) gm[i] = last ? bb[i] : bb[i] + r[i];
    store4(at(gammas, t), gm);
  }
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_custom(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg_from,
    const int32_t* from_idx, const float* from_logp, int deg_to,
    const int32_t* to_idx, const float* to_logp, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    float log2pi, float log_n, float* alphas, float* betas, float* gammas,
    int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    fwbw_custom_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_idx,
        from_logp, deg_to, to_idx, to_logp, level_mean, level_stdv,
        log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
        alphas, betas, gammas);
  }
  return (int)cudaGetLastError();
}
