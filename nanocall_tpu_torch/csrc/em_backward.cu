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
// K5m (em_backward_wave_kernel) is K5 with the 4096 states split over M =
// 2 .. 64 ranks (the EM round under nanocall_tpu/parallel/mesh.py:126
// shard_train_inputs; parallel/statepar.py drives it after K4m).  A block
// is one (read, rank) pair of a cooperative grid and runs the whole reverse
// pass, with K1m's exchange (wave_exchange.cuh).  The threads keep K5's
// layout over the whole row, 4 contiguous states a thread; the rank's W
// states are those of threads W / 4 rank .. W / 4 (rank + 1) - 1 (its
// "own" threads, in its own warps).  Each step:
//   - the own threads compute g = em(t+1) + beta for their states (the
//     emission's 3 divisions are computed once on the row) and store them
//     into the rank's (2, B, W) g buffer at the step's parity; the block
//     publishes its counter and waits for the peers';
//   - every thread loads its 4 states of the whole g column in place
//     (relaxed loads), and the block runs K5's recursion over all of it:
//     the max with its NaN vote, G, sum4, sum16 and log(sum4); sum16[c]
//     and sum4[i % 1024] of a rank's states reach into every slice for W
//     >= 256;
//   - the own threads take beta, lp_j1 and, from their slice of K4m's
//     alphas, the statistics of their states: the 6 post sums as the
//     pairwise tree over the rank's contiguous states, a whole subtree of
//     K5's; with train_transitions, each own warp's masked maxima, the
//     rank's 3 partial maxima published by a second exchange (a counter
//     phase of its own), the masked max over all states from the M
//     ranks', then the subtree sums of exp(v - max);
//   - the per-step partials go to the rank's record red (B, T, 12), their
//     cross-warp sums at the next step, as K5's.
// After the last step every rank publishes its counter once more; the
// row's first rank waits for every peer, combines the M ranks' partials of
// each step pairwise in rank order (a warp an item: the tree of
// hmm.combine_rank_sums), which gives K5's per-step sums bit for bit, and
// folds the 14 moments and 3 log totals over the steps in K5's order.
// What bounds it: the block's recursion over all 4096 states a step (an
// exp, a log a state), the own threads' emission and statistics for W
// states, and two exchanges a step (one without train_transitions).
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fused_bwd_mstats_plain in nanocall_tpu_torch/ops/em.py on the card.

#include "beta_step.cuh"
#include "device_guard.cuh"
#include "wave_exchange.cuh"

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

// the columns of K5m's per-step record: the 6 post sums and 3 transition
// sums over the rank's states, then the 3 masked maxima over all states
// (ops/em.py NRED_WAVE)
constexpr int NRED_WAVE = NRED + NST;

// The ranks of a K5m launch (as K1m's WaveRank): one entry a rank of the
// data row (the M entries, then the ranks this launch runs, as int64), in
// device memory of the launch's card; every pointer on the rank's own card.
// The rank's own inputs (pattern, flags, log rates) are null in a peer's
// entry: a launch reads only its peers' g, maxima, red and counters.
struct EMWaveRank {
  const float* ev_mean;  // (B, T) drift-corrected events, (B,) lengths
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  const float* e_codes;    // (B, 3, 32) the whole tables' codebooks
  const uint8_t* pattern;  // (W,) of the rank's states
  const uint8_t* sflags;   // (W,) of the rank's states, with the subset
  const float* model[MODEL_ROWS];  // (B, W) of the rank's states
  const float* W;          // (B, 6, W), or null without train_scaling
  const float* alphas;     // (T, B, W), K4m's slice
  const float* lpd;        // (B,)
  const float* x_unc;      // (B, T)
  const float* t_start;    // (B, T)
  const uint8_t* valid;    // (B,)
  const float* log_p_stay;   // (B,)
  const float* log_p_step4;  // (B,)
  float* g;                // (2, B, W): g of the s-th step at s & 1
  float* maxima;           // (B, 3): the step's partial masked maxima
  float* red;              // (B, T, NRED_WAVE)
  int32_t* flags;          // (B,) counter
  float* scal;             // (B, 14), the first rank's
  float* st;               // (B, 3), the first rank's
};

// The pairwise-tree sum of the first 1 << levels lanes of each group of
// that many in the warp, in the group's first lane
__device__ __forceinline__ float sub_tree_sum(float v, int levels) {
  for (int off = 1; off < (1 << levels); off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// K5m: the reverse pass of read wave_lo + blockIdx.x for the rank named by
// entry blockIdx.y of the launch's ranks (after the M = N >> slice_shift
// entries of `wave`), which holds the states [rank W, (rank + 1) W), W =
// 1 << slice_shift.  Dynamic shared memory: the rank's 6 model rows, then
// (train_scaling) its W's 6 rows, W floats each.
template <bool SYS>
__global__ void __launch_bounds__(THREADS, 1)
em_backward_wave_kernel(const EMWaveRank* __restrict__ wave, int B, int T,
                        int wave_lo, int slice_shift, int train_scaling,
                        int train_transitions, float log2pi,
                        long long timeout_ns, int32_t* timed_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Exchange x;
  __shared__ float* sPeerMax[MAX_RANKS];
  __shared__ float* sPeerRed[MAX_RANKS];
  __shared__ __align__(8) uint64_t bar;
  __shared__ __align__(16) BetaShared sh;
  __shared__ __align__(16) float sLS4[N4];
  __shared__ float sPart[NRED][WARPS];
  __shared__ float sTrMax[NST][WARPS];
  __shared__ float sTrM[NST];

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, U = W >> 2;
  const int rank =
      (int)reinterpret_cast<const long long*>(wave + ranks)[blockIdx.y];
  const int b = wave_lo + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const EMWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
  // the own threads u0 .. u0 + U - 1, in nw own warps from ow0; the tree
  // of a warp's part takes lv levels, its sum lands in lane sub_lane
  const int u0 = (rank << slice_shift) >> 2;
  const bool own = (unsigned)(tid - u0) < (unsigned)U;
  const int u = own ? tid - u0 : 0;
  const int ow0 = u0 >> 5;
  const int nw = U >= 32 ? U >> 5 : 1;
  const int lv = U >= 32 ? 5 : 31 - __clz(U);
  const int sub_lane = U >= 32 ? 0 : (u0 & 31);
  const int nw_lv = 31 - __clz(nw);
  const bool own_warp = (unsigned)(warp - ow0) < (unsigned)nw;
  const size_t bw = (size_t)B * W;

  if (tid < ranks) {
    x.col[tid] = wave[tid].g + (size_t)b * W;
    x.flag[tid] = wave[tid].flags + b;
    sPeerMax[tid] = wave[tid].maxima + (size_t)b * NST;
    sPeerRed[tid] = wave[tid].red + (size_t)b * T * NRED_WAVE;
  }
  if (tid == 0) {
    x.timed_out = timed_out;
    x.timeout_ns = timeout_ns;
    x.ranks = ranks;
    x.rank = rank;
    x.read = b;
    const uint32_t row_bytes = W * 4;
    mbar_init_expect(bar_addr,
                     (MODEL_ROWS + (train_scaling ? NW : 0)) * row_bytes);
#pragma unroll
    for (int k = 0; k < MODEL_ROWS; ++k)
      bulk_copy(smem_addr(smem + k * W), e.model[k] + (size_t)b * W,
                row_bytes, bar_addr);
    if (train_scaling)
      bulk_copy(smem_addr(smem + MODEL_ROWS * W), e.W + (size_t)b * NW * W,
                NW * row_bytes, bar_addr);
  }
  if (tid < BWD_BOOKS * BWD_CODES)
    sh.book[tid / BWD_CODES][tid % BWD_CODES] =
        e.e_codes[(size_t)b * BWD_BOOKS * BWD_CODES + tid];

  uint32_t fl = 0, pat = 0;
  if (own) {
    fl = *reinterpret_cast<const uint32_t*>(e.sflags + 4 * u);
    pat = *reinterpret_cast<const uint32_t*>(e.pattern + 4 * u);
  }
  const int len = e.length[b];
  const bool ok = e.valid[b] != 0;
  const float lpd_b = e.lpd[b];
  const float lps = own ? e.log_p_stay[b] : 0.0f;
  const float lpst4 = own ? e.log_p_step4[b] : 0.0f;
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  float* redb = e.red + (size_t)b * T * NRED_WAVE;
  const float* sW = smem + MODEL_ROWS * W + 4 * u;
  const size_t arow = (size_t)b * W + 4 * u;
  const int P = train_transitions ? 2 : 1;  // counter phases a step

  float4 a_last = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (train_scaling && own) a_last = load4(e.alphas + (T - 1) * bw + arow);
  float4 a_cur = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (T >= 2 && own) a_cur = load4(e.alphas + (T - 2) * bw + arow);
  float xn = 0.0f, yn = 0.0f, lyn = 0.0f;
  if (T >= 2) {
    xn = evm[T - 1];
    yn = evs[T - 1];
    lyn = evl[T - 1];
  }

  __syncthreads();  // orders the mbarrier's init before every wait; books
  mbar_wait(bar_addr, 0);
  if (own) {
    // -log_level_stdv and log_sd_lambda - log2pi, as prepare_model_rows
    float4* nlls = reinterpret_cast<float4*>(smem + 2 * W) + u;
    float4* c1 = reinterpret_cast<float4*>(smem + 5 * W) + u;
    const float4 v = *nlls, w = *c1;
    *nlls = make_float4(-v.x, -v.y, -v.z, -v.w);
    *c1 = make_float4(w.x - log2pi, w.y - log2pi, w.z - log2pi,
                      w.w - log2pi);
  }

  // the own warps' subtree sums of a value over the rank's states
  auto part_sum = [&](float v) {
    return sub_tree_sum(v, lv);
  };
  // post (the thread's 4 states, 0 outside the rank's) against W: each own
  // warp's 6 subtree sums into sPart
  auto post_sums = [&](const float (&post)[4]) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (own) unpack4(w, lds4(sW + k * W));
      const float p[4] = {post[0] * w[0], post[1] * w[1], post[2] * w[2],
                          post[3] * w[3]};
      const float s = part_sum(quad_sum(p));
      if (lane == sub_lane) sPart[k][warp] = s;
    }
  };
  // the cross-warp sums of step tp's partials over the own warps into
  // red[tp]: warp k < NRED reduces row k of sPart, and warps NW.. store
  // the step's maxima beside them
  auto reduce_pending = [&](int tp, bool post, bool tr) {
    const int k = warp < NRED ? warp : 0;
    const float v = lane < nw ? sPart[k][ow0 + lane] : 0.0f;
    const float s = sub_tree_sum(v, nw_lv);
    if (lane == 0 && warp < NRED && (warp < NW ? post : tr)) {
      redb[(size_t)tp * NRED_WAVE + warp] = s;
      if (warp >= NW)
        redb[(size_t)tp * NRED_WAVE + NRED + warp - NW] = sTrM[warp - NW];
    }
  };

  // t = T-1: beta = 0, no outgoing transition
  if (train_scaling && own_warp) {
    const float wf = ((T - 1 < len) && ok && own) ? 1.0f : 0.0f;
    float a[4], post[4];
    unpack4(a, a_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) post[i] = expf(a[i] - lpd_b) * wf;
    post_sums(post);
  }
  int pend_t = T - 1;
  bool pend_post = train_scaling != 0, pend_tr = false;

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int step = 0;
  for (int t = T - 2; t >= 0; --t, ++step) {
    float4 a_nxt = a_cur;
    const float xe = xn, ye = yn, ly3 = 3.0f * lyn;
    if (t > 0) {
      if (own) a_nxt = load4(e.alphas + (size_t)(t - 1) * bw + arow);
      xn = evm[t];
      yn = evs[t];
      lyn = evl[t];
    }
    const size_t gpar = (size_t)(step & 1) * bw;
    // g = em(t+1) + beta of the rank's states, published
    if (own) {
      float lm[4], ls[4], nlls[4], sm[4], slam[4], c1[4], g[4];
      unpack4(lm, lds4(smem + 0 * W + 4 * u));
      unpack4(ls, lds4(smem + 1 * W + 4 * u));
      unpack4(nlls, lds4(smem + 2 * W + 4 * u));
      unpack4(sm, lds4(smem + 3 * W + 4 * u));
      unpack4(slam, lds4(smem + 4 * W + 4 * u));
      unpack4(c1, lds4(smem + 5 * W + 4 * u));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[i] = emission_pre(xe, ye, ly3, lm[i], ls[i], nlls[i], sm[i],
                            slam[i], c1[i], log2pi) +
               beta[i];
      store4(e.g + gpar + arow, g);
    }
    __syncthreads();
    if (tid == 0) st_flag<SYS>(x.flag[x.rank], P * step + 1);
    if (warp == 0) {
      __syncwarp();
      wait_peers<SYS>(x, P * step + 1, lane);
    }
    __syncthreads();
    // the whole g column, the thread's 4 states 4 tid ..
    float g[4];
    {
      const int j0 = 4 * tid;
      const float* src = x.col[j0 >> slice_shift] + gpar + (j0 & (W - 1));
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ld_column<SYS>(src + i);
    }
    // K5's recursion over the whole column; the pending partials' cross-
    // warp sums after its first barrier
    float bfull[4];
    const float m = beta_step(
        g, t >= len - 1, fl, pat, sh, train_transitions ? sLS4 : nullptr,
        tid, bfull, [&] { reduce_pending(pend_t, pend_post, pend_tr); });
    float v[NST][4];
    if (own_warp) {
      float a[4], lp_j1[4], e_j1[4];
      unpack4(a, a_cur);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (own) beta[i] = bfull[i];
        lp_j1[i] = (a[i] + beta[i]) - lpd_b;
        e_j1[i] = expf(lp_j1[i]);
      }
      if (train_scaling) {
        const float wf = ((t < len) && ok && own) ? 1.0f : 0.0f;
        float post[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) post[i] = e_j1[i] * wf;
        post_sums(post);
      }
      if (train_transitions) {
        const bool win = (t < len - 1) && ok && own;
        const float safe_m = isfinite(m) ? m : 0.0f;
        float LS4[4];
        unpack4(LS4, lds4(sLS4 + ((4 * tid) & (N4 - 1))));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned f = (fl >> (8 * i)) & 0xffu;
          const float lp_stay =
              tmin(((a[i] + lps) + g[i]) - lpd_b, lp_j1[i]);
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
      }
    }
    if (train_transitions) {
      __syncthreads();  // the own warps' maxima
      if (warp == 0) {
        // the rank's partial maxima, published; then every rank's
        float mq[NST];
#pragma unroll
        for (int q = 0; q < NST; ++q) {
          const float vq = lane < nw ? sTrMax[q][ow0 + lane] : -INFINITY;
          mq[q] = warp_max_nan(vq, vq != vq);
        }
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < NST; ++q) sPeerMax[x.rank][q] = mq[q];
          st_flag<SYS>(x.flag[x.rank], P * step + 2);
        }
        __syncwarp();
        wait_peers<SYS>(x, P * step + 2, lane);
#pragma unroll
        for (int q = 0; q < NST; ++q) {
          float vq = -INFINITY;
          bool nan = false;
          for (int p = lane; p < ranks; p += 32) {
            const float w = ld_column<SYS>(sPeerMax[p] + q);
            vq = fmaxf(vq, w);
            nan = nan || w != w;
          }
          const float mm = warp_max_nan(vq, nan);
          if (lane == 0) sTrM[q] = mm;
        }
      }
      __syncthreads();  // the masked maxima over every rank
      if (own_warp) {
#pragma unroll
        for (int q = 0; q < NST; ++q) {
          const float mm = sTrM[q];
          const float safe = isfinite(mm) ? mm : 0.0f;
          float ex[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ex[i] = own ? expf(v[q][i] - safe) : 0.0f;
          const float ws = part_sum(quad_sum(ex));
          if (lane == sub_lane) sPart[NW + q][warp] = ws;
        }
      }
    }
    pend_t = t;
    pend_post = train_scaling != 0;
    pend_tr = train_transitions != 0;
    a_cur = a_nxt;
  }
  __syncthreads();
  reduce_pending(pend_t, pend_post, pend_tr);
  __syncthreads();  // the record's writes, before the counter
  if (tid == 0) st_flag<SYS>(x.flag[x.rank], P * (T - 1) + 1);
  if (rank != 0) return;
  if (warp == 0) {
    __syncwarp();
    wait_peers<SYS>(x, P * (T - 1) + 1, lane);
  }
  __syncthreads();

  // the row's first rank: each step's partials of the M ranks combined
  // pairwise in rank order (a warp an item, lane p holding rank p's, or
  // ranks 2p and 2p + 1 added first at 64 ranks), into its own record
  const int per_lane = ranks > 32 ? 2 : 1;
  const int lanes = ranks / per_lane;
  const int lanes_lv = 31 - __clz(lanes);
  for (int item = warp; item < T * NRED; item += WARPS) {
    const int t = item / NRED, k = item % NRED;
    if (k < NW ? !train_scaling : (!train_transitions || t > T - 2))
      continue;  // warp-uniform
    float vk = 0.0f;
    if (lane < lanes) {
      const size_t off = (size_t)t * NRED_WAVE + k;
      vk = ld_column<SYS>(sPeerRed[per_lane * lane] + off);
      if (per_lane == 2)
        vk = vk + ld_column<SYS>(sPeerRed[2 * lane + 1] + off);
    }
    const float s = sub_tree_sum(vk, lanes_lv);
    if (lane == 0) {
      float out = s;
      if (k >= NW) {
        const float mm = redb[(size_t)t * NRED_WAVE + NRED + k - NW];
        const float safe = isfinite(mm) ? mm : 0.0f;
        out = isfinite(mm) ? safe + logf(s) : mm;
      }
      redb[(size_t)t * NRED_WAVE + k] = out;
    }
  }
  __syncthreads();  // the combined record's writes are visible to the block

  // the fold, over the steps in the plain version's order
  if (tid < NSCAL) {
    float sc = 0.0f;
    if (train_scaling) {
#pragma unroll 4
      for (int t = T - 1; t >= 0; --t) {
        float s[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) s[k] = redb[(size_t)t * NRED_WAVE + k];
        const size_t ei = (size_t)b * T + t;
        const float cnt = ((t < len) && ok) ? 1.0f : 0.0f;
        const float v = moment(tid, s, e.x_unc[ei], e.t_start[ei], evs[t],
                               cnt);
        sc = t == T - 1 ? v : sc + v;
      }
    }
    e.scal[(size_t)b * NSCAL + tid] = sc;
  } else if (tid < NSCAL + NST) {
    const int q = tid - NSCAL;
    float acc = -INFINITY;
    if (train_transitions) {
#pragma unroll 4
      for (int t = T - 2; t >= 0; --t)
        acc = logaddexp(acc, redb[(size_t)t * NRED_WAVE + NW + q]);
    }
    e.st[(size_t)b * NST + q] = acc;
  }
}

using EMWaveKernel = decltype(&em_backward_wave_kernel<false>);

EMWaveKernel em_wave_kernel(int sys) {
  return sys ? em_backward_wave_kernel<true> : em_backward_wave_kernel<false>;
}

int em_wave_smem(int train_scaling, int slice_shift) {
  return (MODEL_ROWS + (train_scaling ? NW : 0)) * (4 << slice_shift);
}

}  // namespace

// K5m's wave: the most blocks of its instance (sys, train_scaling, at
// slices of 1 << slice_shift states) that one card holds at once (blocks
// an SM at its threads and shared memory, times the SMs) into *blocks; an
// error where the card has no cooperative launch.
extern "C" int nc_em_backward_wave_resident(int sys, int train_scaling,
                                            int slice_shift, int device,
                                            int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  if (slice_shift < 6 || slice_shift > 11) return (int)cudaErrorInvalidValue;
  const EMWaveKernel kernel = em_wave_kernel(sys);
  const int smem = em_wave_smem(train_scaling, slice_shift);
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        nc::THREADS, smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K5m: the reverse pass of the reads [lo, lo + n_reads) for n_local ranks
// of a data row, one cooperative grid (n_reads, n_local) on `stream`.
// `ranks` (device memory of this card) holds the row's M = 4096 >>
// slice_shift EMWaveRank entries, then the n_local ranks to run as int64;
// the entries' tensors lie on their ranks' cards, reachable from this one
// (peer access); the model rows, W, alphas and g 16-byte aligned, the
// counters zero before the launch.  sys: the exchange at system scope.
// timed_out: as K1m's.  Returns the launch's error: a grid larger than the
// card holds at once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_em_backward_wave(const void* ranks, int n_local, int B,
                                   int T, int lo, int n_reads,
                                   int slice_shift, int train_scaling,
                                   int train_transitions, int sys,
                                   float log2pi, long long timeout_ns,
                                   int32_t* timed_out, int device,
                                   void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 ||
      n_local > (nc::N >> slice_shift) || timed_out == nullptr ||
      !(train_scaling || train_transitions))
    return (int)cudaErrorInvalidValue;
  const EMWaveKernel kernel = em_wave_kernel(sys);
  const int smem = em_wave_smem(train_scaling, slice_shift);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_reads, n_local);
  cfg.blockDim = dim3(nc::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const EMWaveRank*>(ranks), B, T, lo,
                           slice_shift, train_scaling, train_transitions,
                           log2pi, timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

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
