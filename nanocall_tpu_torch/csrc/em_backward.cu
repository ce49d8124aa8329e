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
// Design (for the H100): one block per read, 1024 threads x 4 contiguous
// states, the time loop inside the block; the beta recursion is
// csrc/beta_step.cuh's, which K6d shares.
//   - The read's tables live on chip for the whole loop: the 6 model rows
//     (beta_step.cuh) and W's 6 rows (192 KB) in dynamic shared memory,
//     copied with cp.async.bulk on one mbarrier; the three transition
//     tables as 32-entry codebooks per read.
//   - alphas[t-1] (16 KB of the read's row, from HBM) and the next step's
//     events are loaded into registers one step ahead.
//   - 3 block barriers a step (2 without train_transitions): the recursion's
//     two, then the 6 post sums and 3 transition maxima per warp,
//     published together.
//   - The maxima (of g, and the transitions' masked maxima) propagate NaN
//     as torch.amax does, at fmaxf's cost: fmaxf and one vote for NaN
//     (common.cuh warp_max_nan; fmaxf alone drops a NaN).
//   - Each value is computed once: log(sum4[c]), which 4 states read, by
//     the thread that sums it; exp(lp_j1) for both statistics.
//   - No serial fold in the step: each step's per-warp partial sums are
//     reduced across the warps by 9 warps at the next step (after its first
//     barrier) into a per-step buffer `red` (B, T, 9) in global memory;
//     after the loop, threads 0..13 fold one moment each and threads 14..16
//     one logaddexp total each, over the steps in the plain version's
//     order: the same float sequence, so the same bits.
//
// What bounds it: issue on the read's one SM, about 10 transcendental
// functions and 3 IEEE divisions per state and step; then the barriers,
// with one 1024-thread block per SM (the tables take 192 KB).  Only B of
// the 132 SMs work when B < 132.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fused_bwd_mstats_plain in nanocall_tpu_torch/ops/em.py on the card.

#include "beta_step.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

// the transition-training bit of the per-state flag byte (ops/em.py
// BWD_FLAG_BITS), above beta_step.cuh's
constexpr unsigned F_SUB = 8u;
constexpr int NSCAL = 14, NST = 3, NW = 6;
// per-step sums kept for the fold: the 6 post sums, the 3 transition parts
constexpr int NRED = NW + NST;

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

// moment k of one event's contraction sums s = s0 s1 s2 l0 l1 l2, in
// _post_stats' op order
__device__ __forceinline__ float moment(int k, const float (&s)[NW], float x,
                                        float ts, float y, float cnt) {
  switch (k) {
    case 0: return s[0];
    case 1: return s[1];
    case 2: return s[2];
    case 3: return s[0] * ts;
    case 4: return s[1] * ts;
    case 5: return (s[0] * ts) * ts;
    case 6: return s[0] * x;
    case 7: return s[1] * x;
    case 8: return (s[0] * x) * ts;
    case 9: return (s[0] * x) * x;
    case 10: return s[5] * y;
    case 11: return s[4];
    case 12: return s[3] / y;
    default: return cnt;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
em_backward_kernel(const float* __restrict__ ev_mean,
                   const float* __restrict__ ev_stdv,
                   const float* __restrict__ ev_log_stdv,
                   const int32_t* __restrict__ length, int B, int T,
                   const float* __restrict__ e_codes,
                   const uint8_t* __restrict__ pattern,
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
                   float* __restrict__ red, float* __restrict__ scal_out,
                   float* __restrict__ st_out) {
  // MODEL_ROWS model rows, then (with train_scaling) W's NW rows, of N each
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ __align__(16) BetaShared sh;
  __shared__ __align__(16) float sLS4[N4];  // logf(sum4), for the transitions
  // each warp's partial sums of one step: the 6 post sums, then the 3
  // transition sums
  __shared__ float sPart[NRED][WARPS];
  __shared__ float sTrMax[NST][WARPS];
  __shared__ float sTrM[NST];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t bar_addr = smem_addr(&bar);
  const size_t row = (size_t)b * N + 4 * tid;
  const size_t astride = (size_t)B * N;

  if (tid == 0) {
    const uint32_t w_bytes = train_scaling ? NW * N * 4 : 0;
    copy_model_rows(smem, bar_addr, b, w_bytes, level_mean, level_stdv,
                    log_level_stdv, sd_mean, sd_lambda, log_sd_lambda);
    if (train_scaling)
      bulk_copy(smem_addr(smem + MODEL_ROWS * N), W + (size_t)b * NW * N,
                w_bytes, bar_addr);
  }
  if (tid < BWD_BOOKS * BWD_CODES)
    sh.book[tid / BWD_CODES][tid % BWD_CODES] =
        e_codes[(size_t)b * BWD_BOOKS * BWD_CODES + tid];

  const uint32_t fl = *reinterpret_cast<const uint32_t*>(flags + 4 * tid);
  const uint32_t pat = *reinterpret_cast<const uint32_t*>(pattern + 4 * tid);
  const int len = length[b];
  const bool ok = valid[b] != 0;
  const float lpd_b = lpd[b];
  const float lps = log_p_stay[b], lpst4 = log_p_step4[b];
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  float* redb = red + (size_t)b * T * NRED;
  const float* sW = smem + MODEL_ROWS * N + 4 * tid;

  // alphas[T-1] for the t = T-1 term, alphas[T-2] for the first step
  float4 a_last = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (train_scaling) a_last = load4(alphas + (size_t)(T - 1) * astride + row);
  float4 a_cur = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (T >= 2) a_cur = load4(alphas + (size_t)(T - 2) * astride + row);
  float xn = 0.0f, yn = 0.0f, lyn = 0.0f;
  if (T >= 2) {
    xn = evm[T - 1];
    yn = evs[T - 1];
    lyn = evl[T - 1];
  }

  __syncthreads();  // orders the mbarrier's init before every wait; books
  mbar_wait(bar_addr, 0);
  prepare_model_rows(smem, tid, log2pi);

  // contract post (the thread's 4 states) with W; each warp's 6 tree sums
  // go to sPart for the next step's cross-warp reduction
  auto post_sums = [&](const float (&post)[4]) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      float w[4];
      unpack4(w, lds4(sW + k * N));
      const float p[4] = {post[0] * w[0], post[1] * w[1], post[2] * w[2],
                          post[3] * w[3]};
      const float s = warp_tree_sum(quad_sum(p));
      if (lane == 0) sPart[k][warp] = s;
    }
  };
  // the cross-warp sums of step tp's partials (published before the
  // barrier just passed) into red[b, tp]: warp k < NRED reduces row k of
  // sPart.  Every warp runs the shuffles (converged, no collective code);
  // warps NRED.. reduce row 0 again and store nothing.
  auto reduce_pending = [&](int tp, bool post, bool tr) {
    const int k = warp < NRED ? warp : 0;
    const float s = warp_tree_sum(sPart[k][lane]);
    if (lane == 0 && warp < NRED && (warp < NW ? post : tr)) {
      float v = s;
      if (warp >= NW) {
        const float mm = sTrM[warp - NW];
        const float safe = isfinite(mm) ? mm : 0.0f;
        v = isfinite(mm) ? safe + logf(s) : mm;
      }
      redb[(size_t)tp * NRED + warp] = v;
    }
  };

  // t = T-1: beta = 0, no outgoing transition
  if (train_scaling) {
    const float wf = ((T - 1 < len) && ok) ? 1.0f : 0.0f;
    float a[4], post[4];
    unpack4(a, a_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) post[i] = expf(a[i] - lpd_b) * wf;
    post_sums(post);
  }
  int pend_t = T - 1;
  bool pend_post = train_scaling != 0, pend_tr = false;

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = T - 2; t >= 0; --t) {
    // the next step's alpha row and event, one step ahead
    float4 a_nxt = a_cur;
    const float x = xn, y = yn, ly3 = 3.0f * lyn;
    if (t > 0) {
      a_nxt = load4(alphas + (size_t)(t - 1) * astride + row);
      xn = evm[t];
      yn = evs[t];
      lyn = evl[t];
    }

    // g = em(t+1) + beta, then beta (2 barriers; the pending cross-warp
    // sums after the first)
    float g[4];
    beta_g(smem, tid, x, y, ly3, beta, log2pi, g);
    const float m = beta_step(
        g, t >= len - 1, fl, pat, sh, train_transitions ? sLS4 : nullptr, tid,
        beta, [&] { reduce_pending(pend_t, pend_post, pend_tr); });

    float a[4], lp_j1[4];
    unpack4(a, a_cur);
#pragma unroll
    for (int i = 0; i < 4; ++i) lp_j1[i] = (a[i] + beta[i]) - lpd_b;

    float e_j1[4];  // exp(lp_j1), for both statistics
#pragma unroll
    for (int i = 0; i < 4; ++i) e_j1[i] = expf(lp_j1[i]);
    if (train_scaling) {
      const float wf = ((t < len) && ok) ? 1.0f : 0.0f;
      float post[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) post[i] = e_j1[i] * wf;
      post_sums(post);
    }

    if (train_transitions) {
      const bool win = (t < len - 1) && ok;
      const float safe_m = isfinite(m) ? m : 0.0f;
      float v[NST][4], LS4[4];
      unpack4(LS4, lds4(sLS4 + ((4 * tid) & (N4 - 1))));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned f = (fl >> (8 * i)) & 0xffu;
        const float lp_stay = tmin(((a[i] + lps) + g[i]) - lpd_b, lp_j1[i]);
        const float lsum4 = safe_m + LS4[i];
        const float lp_steps = ((a[i] + lpst4) + lsum4) - lpd_b;
        const float lp_d01 = tmin(logaddexp(lp_stay, lp_steps), lp_j1[i]);
        const float d = e_j1[i] - expf(lp_d01);
        const float lp_d2 = logf(d != d ? d : fmaxf(d, 0.0f));
        const bool w = win && (f & F_SUB);
        v[0][i] = w ? lp_j1[i] : -INFINITY;
        v[1][i] = w ? lp_stay : -INFINITY;
        v[2][i] = w ? lp_d2 : -INFINITY;
      }
#pragma unroll
      for (int q = 0; q < NST; ++q) {
        const float mq = warp_max_nan4(v[q]);
        if (lane == 0) sTrMax[q][warp] = mq;
      }
      __syncthreads();  // 3
      // masked max over the block, then each warp's tree sum of
      // exp(v - max); the cross-warp sum waits for the next step
#pragma unroll
      for (int q = 0; q < NST; ++q) {
        const float mm =
            warp_max_nan(sTrMax[q][lane], sTrMax[q][lane] != sTrMax[q][lane]);
        const float safe = isfinite(mm) ? mm : 0.0f;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = expf(v[q][i] - safe);
        const float ws = warp_tree_sum(quad_sum(e));
        if (lane == 0) sPart[NW + q][warp] = ws;
        if (tid == 0) sTrM[q] = mm;
      }
    }
    pend_t = t;
    pend_post = train_scaling != 0;
    pend_tr = train_transitions != 0;
    a_cur = a_nxt;
  }
  __syncthreads();
  reduce_pending(pend_t, pend_post, pend_tr);
  __syncthreads();  // red's writes are visible to the block after it

  // the fold, over the steps in the plain version's order
  if (tid < NSCAL) {
    float sc = 0.0f;
    if (train_scaling) {
#pragma unroll 4
      for (int t = T - 1; t >= 0; --t) {
        float s[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) s[k] = redb[(size_t)t * NRED + k];
        const size_t e = (size_t)b * T + t;
        const float cnt = ((t < len) && ok) ? 1.0f : 0.0f;
        const float v = moment(tid, s, x_unc[e], t_start[e], evs[t], cnt);
        sc = t == T - 1 ? v : sc + v;
      }
    }
    scal_out[(size_t)b * NSCAL + tid] = sc;
  } else if (tid < NSCAL + NST) {
    const int q = tid - NSCAL;
    float acc = -INFINITY;
    if (train_transitions) {
#pragma unroll 4
      for (int t = T - 2; t >= 0; --t)
        acc = logaddexp(acc, redb[(size_t)t * NRED + NW + q]);
    }
    st_out[(size_t)b * NST + q] = acc;
  }
}

}  // namespace

// Plain C entry for ctypes.  e_codes (B, 3, 32) and pattern (4096,) are
// ops/hmm.py bwd_codebooks' transition codebooks and pattern bytes; W may
// be nullptr when train_scaling is 0; red (B, T, 9) float32 is scratch.
// The model rows and W must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int nc_em_backward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_codes,
    const uint8_t* pattern, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, const float* W, const float* alphas,
    const float* lpd, const float* x_unc, const float* t_start,
    const uint8_t* valid, const float* log_p_stay, const float* log_p_step4,
    const uint8_t* flags, int train_scaling, int train_transitions,
    float log2pi, float* red, float* scal, float* st, int device,
    void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    const int smem = nc::MODEL_BYTES + (train_scaling ? NW * nc::N * 4 : 0);
    const cudaError_t err = cudaFuncSetAttribute(
        em_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    em_backward_kernel<<<B, nc::THREADS, smem, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_codes, pattern,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, W, alphas, lpd, x_unc, t_start, valid, log_p_stay,
        log_p_step4, flags, train_scaling, train_transitions, log2pi, red,
        scal, st);
  }
  return (int)cudaGetLastError();
}
