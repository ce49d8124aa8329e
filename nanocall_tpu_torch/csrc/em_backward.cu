// K5: fused EM backward pass + both M-steps' sufficient statistics.
//
// Replaces nanocall_tpu/train.py _fused_bwd_mstats, a reverse lax.scan that
// XLA compiled for the TPU.  Per read (row) b, for t = T-2 down to 0, with
// beta carried on chip (beta = 0 after the last event) and never stored:
//   g      = em(t+1, i) + beta[i];  m = max g;  G = exp(g - m)
//   sum4[c]  = G[4c] + G[4c+1] + G[4c+2] + G[4c+3]      (added in that order)
//   sum16[c] = G[16c] + ... + G[16c+15]                  (added in that order)
//   total  = e_stay G + e_step_to (sum4[i%1024] - H G)
//            + e_skip_to (sum16[i%256] - P2mH G - S5T sum4[i%1024])
//   beta[i] = t >= length-1 ? 0 : m + log(total)
//   lp_j1  = (alphas[t, b, i] + beta[i]) - lpd[b]
// and, with train_scaling, the posterior exp(lp_j1) (zero outside the row's
// events and for invalid rows) is contracted with the 6 state weights W into
// s0 s1 s2 l0 l1 l2 and folded with the event's uncorrected mean, start and
// stdv into the 14 moments of train.SCAL_NAMES (the t = T-1 term, beta = 0,
// comes first); with train_transitions the stay / step / skip joints of
// transition t are formed in log space (Parameter_Trainer.hpp:479-512) and
// their masked log-sum-exp over the training states is folded into 3
// running totals with logaddexp.  All full-width sums follow the pairwise
// tree of ops/hmm.py tree_sum; nothing uses atomics.
//
// Design: one block per read, 1024 threads x 4 contiguous states; the time
// loop runs inside the block.  The backward's block sums are contiguous, so
// a thread's sum4 is its own; sum16 and the tiled reads (i % 1024, i % 256)
// cross threads and go through shared memory.  The per-read tables (9 of
// them, plus W's 6 rows) are read from global memory at every step (L2
// resident), which keeps the registers free for beta and the statistics;
// alphas[t] is read once.  Thread 0 keeps the 14 + 3 running totals in
// shared memory.
//
// What bounds it: per step, 3 block barriers (+1 for the scaling moments,
// +2 for the transition totals), about 10 transcendental functions per
// state, and 256 KB of table and alpha reads per read.  Only B of the 132
// SMs work when B < 132.  Speed work (tables in registers or shared
// memory, several reads per block, fewer barriers) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fused_bwd_mstats_plain in nanocall_tpu_torch/ops/em.py on the card.

#include "common.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

// bits of the per-state flag byte (ops/em.py BWD_FLAG_BITS)
constexpr unsigned F_H = 1u, F_P2 = 2u, F_S5T = 4u, F_SUB = 8u;
constexpr int NSCAL = 14, NST = 3, NW = 6;

// torch.minimum: NaN-propagating
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.logaddexp on floats
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// thread 0: fold one event's contraction sums s[6] = s0 s1 s2 l0 l1 l2
// into the 14 moments, in _post_stats' op order; `first` assigns
__device__ __forceinline__ void add_stats(float* sc, const float (&s)[NW],
                                          float x, float ts, float y,
                                          float cnt, bool first) {
  const float s0 = s[0], s1 = s[1], s2 = s[2], l0 = s[3], l1 = s[4],
              l2 = s[5];
  const float v[NSCAL] = {s0,           s1,          s2,
                          s0 * ts,      s1 * ts,     (s0 * ts) * ts,
                          s0 * x,       s1 * x,      (s0 * x) * ts,
                          (s0 * x) * x, l2 * y,      l1,
                          l0 / y,       cnt};
#pragma unroll
  for (int k = 0; k < NSCAL; ++k) sc[k] = first ? v[k] : sc[k] + v[k];
}

__global__ void __launch_bounds__(THREADS, 1)
em_backward_kernel(const float* __restrict__ ev_mean,
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
                   const float* __restrict__ W,
                   const float* __restrict__ alphas,
                   const float* __restrict__ lpd,
                   const float* __restrict__ x_unc,
                   const float* __restrict__ t_start,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ log_p_stay,
                   const float* __restrict__ log_p_step4,
                   const uint8_t* __restrict__ flags, int train_scaling,
                   int train_transitions, float log2pi,
                   float* __restrict__ scal_out, float* __restrict__ st_out) {
  __shared__ float sG[N];
  __shared__ float sS4[N4];
  __shared__ float sS16[N16];
  __shared__ float sMax[WARPS];
  __shared__ float sPost[WARPS][NW];
  __shared__ float sTrMax[WARPS][NST];
  __shared__ float sTrSum[WARPS][NST];
  __shared__ float sScal[NSCAL];
  __shared__ float sSt[NST];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * N + 4 * tid;
  const uint32_t fl = *reinterpret_cast<const uint32_t*>(flags + 4 * tid);
  const int len = length[b];
  const bool ok = valid[b] != 0;
  const float lpd_b = lpd[b];
  const float lps = log_p_stay[b], lpst4 = log_p_step4[b];
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const float* Wb = W == nullptr ? nullptr : W + (size_t)b * NW * N;

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < NSCAL; ++k) sScal[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < NST; ++q) sSt[q] = -INFINITY;
  }

  // contract post (the thread's 4 states) with W and reduce over the
  // block; thread 0 folds the sums into the moments of event t
  auto post_stats = [&](const float (&post)[4], int t, bool first) {
    float s[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      float w[4];
      unpack4(w, load4(Wb + (size_t)k * N + 4 * tid));
      const float p[4] = {post[0] * w[0], post[1] * w[1], post[2] * w[2],
                          post[3] * w[3]};
      s[k] = warp_tree_sum(quad_sum(p));
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) sPost[warp][k] = s[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) s[k] = warp_tree_sum(sPost[lane][k]);
      if (lane == 0) {
        const bool w_t = (t < len) && ok;
        add_stats(sScal, s, x_unc[(size_t)b * T + t],
                  t_start[(size_t)b * T + t], evs[t], w_t ? 1.0f : 0.0f,
                  first);
      }
    }
  };

  // t = T-1: beta = 0, no outgoing transition
  if (train_scaling) {
    const float wf = ((T - 1 < len) && ok) ? 1.0f : 0.0f;
    float a[4], post[4];
    unpack4(a, load4(alphas + (size_t)(T - 1) * B * N + 4 * tid +
                     (size_t)b * N));
#pragma unroll
    for (int i = 0; i < 4; ++i) post[i] = expf(a[i] - lpd_b) * wf;
    post_stats(post, T - 1, true);
  }

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = T - 2; t >= 0; --t) {
    // g = em(t+1) + beta; m = max g
    float g[4];
    {
      float lm[4], ls[4], lls[4], sm[4], slam[4], lsl[4];
      unpack4(lm, load4(level_mean + row));
      unpack4(ls, load4(level_stdv + row));
      unpack4(lls, load4(log_level_stdv + row));
      unpack4(sm, load4(sd_mean + row));
      unpack4(slam, load4(sd_lambda + row));
      unpack4(lsl, load4(log_sd_lambda + row));
      const float x = evm[t + 1], y = evs[t + 1], ly = evl[t + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[i] = emission(x, y, ly, lm[i], ls[i], lls[i], sm[i], slam[i],
                        lsl[i], log2pi) +
               beta[i];
    }
    const float mx = warp_max(fmaxf(fmaxf(g[0], g[1]), fmaxf(g[2], g[3])));
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();
    float m = sMax[0];
#pragma unroll 8
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, sMax[w]);

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

    float est[4], estep[4], eskip[4], a[4];
    unpack4(est, load4(e_stay + row));
    unpack4(estep, load4(e_step_to + row));
    unpack4(eskip, load4(e_skip_to + row));
    unpack4(a, load4(alphas + (size_t)t * B * N + row));
    const bool last = t >= len - 1;
    const float safe_m = isfinite(m) ? m : 0.0f;
    float lp_j1[4], T4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * tid + i;
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      T4[i] = sS4[j & (N4 - 1)];
      const float T16 = sS16[j & (N16 - 1)];
      const float hG = (f & F_H) ? G[i] : 0.0f;
      const float p2G = (f & F_P2) ? G[i] : 0.0f;
      const float s5T4 = (f & F_S5T) ? T4[i] : 0.0f;
      const float total = (est[i] * G[i] + estep[i] * (T4[i] - hG)) +
                          eskip[i] * ((T16 - p2G) - s5T4);
      beta[i] = last ? 0.0f : m + logf(total);
      lp_j1[i] = (a[i] + beta[i]) - lpd_b;
    }

    if (train_scaling) {
      const float wf = ((t < len) && ok) ? 1.0f : 0.0f;
      float post[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) post[i] = expf(lp_j1[i]) * wf;
      post_stats(post, t, false);  // one barrier
    }

    if (train_transitions) {
      const bool win = (t < len - 1) && ok;
      float v[NST][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned f = (fl >> (8 * i)) & 0xffu;
        const float lp_stay = tmin(((a[i] + lps) + g[i]) - lpd_b, lp_j1[i]);
        const float lsum4 = safe_m + logf(T4[i]);
        const float lp_steps = ((a[i] + lpst4) + lsum4) - lpd_b;
        const float lp_d01 = tmin(logaddexp(lp_stay, lp_steps), lp_j1[i]);
        const float d = expf(lp_j1[i]) - expf(lp_d01);
        const float lp_d2 = logf(d != d ? d : fmaxf(d, 0.0f));
        const bool w = win && (f & F_SUB);
        v[0][i] = w ? lp_j1[i] : -INFINITY;
        v[1][i] = w ? lp_stay : -INFINITY;
        v[2][i] = w ? lp_d2 : -INFINITY;
      }
      // masked max, then the tree sum of exp(v - max), per total
#pragma unroll
      for (int q = 0; q < NST; ++q) {
        const float mq =
            warp_max(fmaxf(fmaxf(v[q][0], v[q][1]), fmaxf(v[q][2], v[q][3])));
        if (lane == 0) sTrMax[warp][q] = mq;
      }
      __syncthreads();
      float mm[NST], safe[NST];
#pragma unroll
      for (int q = 0; q < NST; ++q) {
        float mq = sTrMax[0][q];
#pragma unroll 8
        for (int w = 1; w < WARPS; ++w) mq = fmaxf(mq, sTrMax[w][q]);
        mm[q] = mq;
        safe[q] = isfinite(mq) ? mq : 0.0f;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = expf(v[q][i] - safe[q]);
        const float ws = warp_tree_sum(quad_sum(e));
        if (lane == 0) sTrSum[warp][q] = ws;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int q = 0; q < NST; ++q) {
          const float s = warp_tree_sum(sTrSum[lane][q]);
          if (lane == 0) {
            const float part = isfinite(mm[q]) ? safe[q] + logf(s) : mm[q];
            sSt[q] = logaddexp(sSt[q], part);
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < NSCAL) scal_out[(size_t)b * NSCAL + tid] = sScal[tid];
  if (tid < NST) st_out[(size_t)b * NST + tid] = sSt[tid];
}

}  // namespace

// Plain C entry for ctypes.  W may be nullptr when train_scaling is 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nc_em_backward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_stay,
    const float* e_step_to, const float* e_skip_to, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    const float* W, const float* alphas, const float* lpd,
    const float* x_unc, const float* t_start, const uint8_t* valid,
    const float* log_p_stay, const float* log_p_step4, const uint8_t* flags,
    int train_scaling, int train_transitions, float log2pi, float* scal,
    float* st, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    em_backward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_stay, e_step_to,
        e_skip_to, level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, W, alphas, lpd, x_unc, t_start, valid, log_p_stay,
        log_p_step4, flags, train_scaling, train_transitions, log2pi, scal,
        st);
  }
  return (int)cudaGetLastError();
}
