// The grouped backward (beta) recursion, shared by K5 (em_backward.cu, the
// fused EM backward pass) and K6d (fwbw_backward.cu, the betas stored).
//
// One block per read, 1024 threads x 4 contiguous states.  Per step, with
// beta the next event's and em the next event's emissions:
//   g      = em(t+1, i) + beta[i];  m = max g  (NaN-propagating)
//   G      = exp(g - m)
//   sum4[c]  = G[4c] + G[4c+1] + G[4c+2] + G[4c+3]      (added in that order)
//   sum16[c] = G[16c] + ... + G[16c+15]                  (added in that order)
//   total  = e_stay G + e_step_to (sum4[i%1024] - H G)
//            + e_skip_to (sum16[i%256] - P2mH G - S5T sum4[i%1024])
//   beta[i] = last ? 0 : m + log(total)
// in the op order of ops/hmm.py fwbw_grouped_backward_plain and ops/em.py
// fused_bwd_mstats_plain, so that with -fmad=false both kernels are
// bit-identical to their plain versions.
//
// The read's 6 model rows live in dynamic shared memory (copied once by
// cp.async.bulk; each thread then takes the emission's loop-invariant
// parts of its own 4 states in place, common.cuh emission_pre).  The three
// transition tables are read as 32-entry codebooks per read over the
// states' overlap-condition patterns (ops/hmm.py bwd_codebooks).  A step
// has 2 block barriers: the max of g; then sum4 and sum16 (sum16[c]
// continues sum4[4c]'s chain through the 3 threads after it by shuffles:
// block_sum's float sequence, and no 16 KB G buffer).  The max is fmaxf
// with one vote for NaN (common.cuh warp_max_nan): torch.amax's value but
// for a zero's sign and a NaN's payload, neither of which shows through
// exp(g - m) or m + log(total).

#pragma once

#include "common.cuh"

namespace nc {

// bits of the per-state flag byte (ops/hmm.py GROUPED_BWD_FLAG_BITS; K5
// adds its own above them)
constexpr unsigned BWD_F_H = 1u, BWD_F_P2 = 2u, BWD_F_S5T = 4u;
// the transition codebooks' width (ops/hmm.py BWD_CODES) and count
constexpr int BWD_CODES = 32, BWD_BOOKS = 3;
// model rows in shared memory: level_mean, level_stdv, -log_level_stdv,
// sd_mean, sd_lambda, log_sd_lambda - log2pi
constexpr int MODEL_ROWS = 6;
constexpr uint32_t MODEL_BYTES = MODEL_ROWS * N * 4;

// the step's shared memory
struct BetaShared {
  float s4[N4];
  float s16[N16];
  float max[WARPS];
  float book[BWD_BOOKS][BWD_CODES];
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Thread 0: the mbarrier at `bar` expects MODEL_BYTES + extra_bytes, and
// the read's 6 model rows (row `b` of each (B, N) table) are copied to
// rows 0..5 of `rows`; the caller copies its extra bytes on the same
// barrier.
__device__ __forceinline__ void copy_model_rows(
    float* rows, uint32_t bar, int b, uint32_t extra_bytes,
    const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda) {
  mbar_init_expect(bar, MODEL_BYTES + extra_bytes);
  const float* const src[MODEL_ROWS] = {level_mean, level_stdv,
                                        log_level_stdv, sd_mean,
                                        sd_lambda, log_sd_lambda};
#pragma unroll
  for (int k = 0; k < MODEL_ROWS; ++k)
    bulk_copy(smem_addr(rows + k * N), src[k] + (size_t)b * N, N * 4, bar);
}

// After the copy's phase: the thread's 4 states of rows 2 and 5 become
// -log_level_stdv and log_sd_lambda - log2pi (the first operation of each
// chain, so emission_pre's bits are emission()'s).  Each thread touches
// only its own states, which it alone reads later.
__device__ __forceinline__ void prepare_model_rows(float* rows, int tid,
                                                   float log2pi) {
  float4* nlls = reinterpret_cast<float4*>(rows + 2 * N) + tid;
  float4* c1 = reinterpret_cast<float4*>(rows + 5 * N) + tid;
  const float4 v = *nlls, w = *c1;
  *nlls = make_float4(-v.x, -v.y, -v.z, -v.w);
  *c1 = make_float4(w.x - log2pi, w.y - log2pi, w.z - log2pi, w.w - log2pi);
}

// g = em + beta for the thread's 4 states at the event (x, y, ly3 = 3 log y)
__device__ __forceinline__ void beta_g(const float* rows, int tid, float x,
                                       float y, float ly3,
                                       const float (&beta)[4], float log2pi,
                                       float (&g)[4]) {
  float lm[4], ls[4], nlls[4], sm[4], slam[4], c1[4];
  unpack4(lm, lds4(rows + 0 * N + 4 * tid));
  unpack4(ls, lds4(rows + 1 * N + 4 * tid));
  unpack4(nlls, lds4(rows + 2 * N + 4 * tid));
  unpack4(sm, lds4(rows + 3 * N + 4 * tid));
  unpack4(slam, lds4(rows + 4 * N + 4 * tid));
  unpack4(c1, lds4(rows + 5 * N + 4 * tid));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    g[i] = emission_pre(x, y, ly3, lm[i], ls[i], nlls[i], sm[i], slam[i],
                        c1[i], log2pi) +
           beta[i];
}

// One step from g to beta (the recursion above), over the block: every
// thread calls it.  after_max() runs after the first barrier; ls4, when not
// null, receives log(sum4) at [tid] before the second.  fl and pat are the
// thread's 4 flag and pattern bytes.  Returns m.
template <class AfterMax>
__device__ __forceinline__ float beta_step(const float (&g)[4], bool last,
                                           uint32_t fl, uint32_t pat,
                                           BetaShared& sh, float* ls4,
                                           int tid, float (&beta)[4],
                                           AfterMax after_max) {
  const int lane = tid & 31, warp = tid >> 5;
  const float mx = warp_max_nan4(g);
  if (lane == 0) sh.max[warp] = mx;
  __syncthreads();  // 1
  const float m = warp_max_nan(sh.max[lane], sh.max[lane] != sh.max[lane]);
  after_max();

  float G[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) G[i] = expf(g[i] - m);
  const float s4 = ((G[0] + G[1]) + G[2]) + G[3];
  sh.s4[tid] = s4;
  if (ls4 != nullptr) ls4[tid] = logf(s4);
  {
    // sum16 of the 16 states of threads 4c..4c+3: sum4 of thread 4c,
    // then the next threads' states one by one, in order
    const int qi = tid & 3;
    float s = s4;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float prev = __shfl_up_sync(FULL, s, 1);
      if (qi == k) s = (((prev + G[0]) + G[1]) + G[2]) + G[3];
    }
    if (qi == 3) sh.s16[tid >> 2] = s;
  }
  __syncthreads();  // 2

  float T4[4], T16[4];
  unpack4(T4, lds4(sh.s4 + ((4 * tid) & (N4 - 1))));
  unpack4(T16, lds4(sh.s16 + ((4 * tid) & (N16 - 1))));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned f = (fl >> (8 * i)) & 0xffu;
    const unsigned p = (pat >> (8 * i)) & 0xffu;
    const float hG = (f & BWD_F_H) ? G[i] : 0.0f;
    const float p2G = (f & BWD_F_P2) ? G[i] : 0.0f;
    const float s5T4 = (f & BWD_F_S5T) ? T4[i] : 0.0f;
    const float total =
        (sh.book[0][p] * G[i] + sh.book[1][p] * (T4[i] - hG)) +
        sh.book[2][p] * ((T16[i] - p2G) - s5T4);
    beta[i] = last ? 0.0f : m + logf(total);
  }
  return m;
}

}  // namespace nc
