// K6e: per-step-normalized forward-backward under a loaded transition table
// (the dev tool `run-fwbw --custom-fwbw`), the resident kernel (a table
// with K6c's packed layout, ops/hmm.py fwbw_route).  A table that streams
// takes the one-card split (fwbw_split.cu).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw_custom (Forward_Backward_Custom.hpp,
// with log_emission inlined), two lax.scan bodies that XLA compiled for the
// TPU.  With lse(v) the slot log-sum-exp of K6c (fwbw_generic.cu) and
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
// One block per read, 1024 threads, both passes in one launch with the
// time loops inside the block; the gathered vector (beta forward, gamma -
// alpha backward) lives in shared memory; em(t) is computed per step from
// the 6 model rows held in registers (K6e has no em output).  The backward
// reads alpha_{t+1} and beta_t back from the outputs: each thread reads
// only the states it stored, so they need no barrier.
//
// The resident kernel (fwbw_custom_resident_kernel) is K6c's resident
// design (resident_slots.cuh: the layout of ops/hmm.py pack_fwbw_sides, 4
// codebooks a slot, the side copy, the slot arithmetic):
//   - The prologue copies the from side into shared memory with
//     cp.async.bulk onto an mbarrier; after the forward (and a barrier that
//     ends its gathers) the same region is refilled with the to side.  No
//     slot-table byte is read from global memory after either copy.
//   - Thread tid holds the states 1024 i + tid, i < 4.  norm's tree sum
//     needs no staging in state order for that: the tree's four subtrees
//     of 1024 states are the blocks i, each the pairwise tree of its
//     states 1024 i + tid in tid order, which is the warp's shuffles over
//     its lanes, then the 32 warps' sums.  So each thread reduces its 4
//     states separately, one warp_tree_sum each, and the block adds the
//     four blocks' sums as (S0 + S1) + (S2 + S3): tree_sum's float sequence.
//   - Barriers: 3 per forward step (the max; the four blocks' warp sums;
//     the new beta in the double-buffered vector, which also votes on
//     whether it holds NaN or +inf), 1 per backward step (gamma - alpha in
//     the buffer, with the same vote).  Only after such a vote (or with
//     NaN or +inf in the codebooks) can a candidate be NaN, and only then
//     does the step take the NaN-propagating max.
//   - Steps past a read's end skip what they do not change: beta is frozen
//     from t = length on, so alpha_t for t > max(length, 1) repeats alpha
//     of that step and is stored without the slot loop; gamma_t = beta_t
//     for t >= length - 1 is stored without the gather.
//   - The r73 tables' 21 slots a side take an instance without bounds
//     tests (<21>), any other slot count the instance <0>, as K6c: <0>
//     takes 1.24x <21>'s time on the same 21-slot table (SASS forward
//     loops of 2043 and 1520 instructions).
// What bounds it: issue on the read's one SM, about 20 instructions per
// slot and state (resident_slots.cuh lse_resident), as K6c's resident
// kernel, whose time on the same inputs it takes 1.09x (norm's exp and
// reductions, the emission from registers).  Only B of the 132 SMs work
// when B < 132: the dev tool runs one read (B = 1).  Tried and not kept:
// 2 barriers a forward step (the gathers forming x - c themselves: one
// more add per candidate) took 1.01x this design's time.  (Times:
// tools/torch_decode_times.py --custom, NVIDIA H100 80GB HBM3, 700 W, in
// turns.)
//
// Per-read tables (ops/hmm.py make_trans_ops_batch): as K6c's resident
// kernel (fwbw_generic.cu), the kernel has a second instance
// (fwbw_custom_resident_batch_kernel) whose block b takes its read's own
// packed layout and codebooks of both sides; from_idx / to_idx are every
// read's, and the one-table instances compile as before.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_custom_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "device_guard.cuh"
#include "resident_slots.cuh"

namespace {

using namespace nc;

// norm(x) of the resident mapping (the thread's states 1024 i + tid):
// the max, then the four blocks' pairwise trees of exp(x - m), each over
// the warp's lanes then the 32 warps (sSum[i] holds block i's warp sums),
// added as (S0 + S1) + (S2 + S3).  Two barriers; every thread must call it.
__device__ __forceinline__ void block_norm_resident(const float (&x)[4],
                                                    float (&out)[4],
                                                    float* sMax,
                                                    float (*sSum)[WARPS],
                                                    int lane, int warp) {
  const float wm = warp_amax(amax(amax(x[0], x[1]), amax(x[2], x[3])));
  if (lane == 0) sMax[warp] = wm;
  __syncthreads();
  const float m = warp_amax(sMax[lane]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ws = warp_tree_sum(expf(x[i] - m));
    if (lane == 0) sSum[i][warp] = ws;
  }
  __syncthreads();
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = warp_tree_sum(sSum[i][lane]);
  const float s = __shfl_sync(FULL, (q[0] + q[1]) + (q[2] + q[3]), 0);
  const float c = m + logf(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = x[i] - c;
}

// Dynamic shared memory as K6c's resident kernel: the gathered vector
// (2 x N float32, double-buffered), then one side's codebooks and packed
// table (resident_slots.cuh), deg the larger side's.  DEG > 0: both sides
// have DEG slots.  The body, inlined into K6e's two resident kernels.
// kBatch: per-read layouts, packed (B, deg, N) and codebooks (B, deg,
// GROUPS x CODES) a side, of which read b copies its own.
template <int DEG, bool kBatch>
__device__ __forceinline__ void fwbw_custom_resident_body(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg_from,
    const uint16_t* __restrict__ from_packed,
    const float* __restrict__ from_book, int deg_to,
    const uint16_t* __restrict__ to_packed,
    const float* __restrict__ to_book, const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ alphas, float* __restrict__ betas,
    float* __restrict__ gammas) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float sMax[WARPS];
  __shared__ float sSum[4][WARPS];
  float* xbuf = reinterpret_cast<float*>(smem);
  float* book = xbuf + 2 * N;
  const int deg_max = deg_from > deg_to ? deg_from : deg_to;
  uint16_t* table =
      reinterpret_cast<uint16_t*>(book + deg_max * GROUPS * CODES);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t rowb = (size_t)b * N;
  const uint32_t bar_addr = smem_addr(&bar);

  // the from side into shared memory (resident_slots.cuh)
  if (tid == 0) {
    mbar_init_expect(bar_addr, side_bytes(deg_from));
    copy_side(book, table, deg_from,
              from_packed + (kBatch ? (size_t)b * deg_from * N : 0),
              from_book + (kBatch ? (size_t)b * deg_from * GROUPS * CODES
                                  : 0),
              bar_addr);
  }

  // the model rows of the thread's states, the emission's loop-invariant
  // parts taken out once (common.cuh emission_pre)
  float lm[4], ls[4], nlls[4], sm[4], slam[4], c1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t j = rowb + i * N4 + tid;
    lm[i] = level_mean[j];
    ls[i] = level_stdv[j];
    nlls[i] = -log_level_stdv[j];
    sm[i] = sd_mean[j];
    slam[i] = sd_lambda[j];
    c1[i] = log_sd_lambda[j] - log2pi;
  }
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];
  // the thread's 4 states of row t of a (B, T, n) output: 4 * i on
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * N + tid;
  };
  auto store_states = [&](float* p, const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i * N4] = v[i];
  };
  // an output row this launch stored, read back by the thread that stored
  // it (L2, not the read-only path)
  auto load_states = [&](const float* p, float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldcg(p + i * N4);
  };
  // em(t) + alpha for the event (x, y, 3 log y)
  auto em_plus = [&](float x, float y, float ly3, const float (&a)[4],
                     float (&out)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = emission_pre(x, y, ly3, lm[i], ls[i], nlls[i], sm[i], slam[i],
                            c1[i], log2pi) + a[i];
  };
  // the thread's entries (slot 0, state tid)
  const uint16_t* ent = table + tid;

  // forward: a = alpha_t, bt = beta_t (the carry)
  float a[4], bt[4], x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = -log_n;
  em_plus(evm[0], evs[0], 3.0f * evl[0], a, x);
  block_norm_resident(x, bt, sMax, sSum, lane, warp);
  store_states(at(alphas, 0), a);
  store_states(at(betas, 0), bt);
  float* cur = xbuf;
  float* nxt = xbuf + N;
  store_states(cur + tid, bt);
  bool prone = __syncthreads_or(any_prone(bt)) != 0;
  mbar_wait(bar_addr, 0);  // the norm's barriers ordered the init before it
  const bool from_prone = book_prone(book, deg_from, tid);
  // beta is frozen from t = len on, so alpha_t for t > t_alpha repeats
  // alpha of step t_alpha
  const int t_alpha = len > 1 ? len : 1;
  for (int t = 1; t < T; ++t) {
    if (t <= t_alpha) {
      const float ex = evm[t], ey = evs[t], el = evl[t];
      lse4_resident<DEG>(from_prone || prone, ent, book, cur, deg_from, a);
      if (t < len) {
        em_plus(ex, ey, 3.0f * el, a, x);
        // its first barrier also ends every thread's gathers from cur
        block_norm_resident(x, bt, sMax, sSum, lane, warp);
        // nxt was last read in step t-1, which every thread has left
        store_states(nxt + tid, bt);
        prone = __syncthreads_or(any_prone(bt)) != 0;
        float* const done = cur;
        cur = nxt;
        nxt = done;
      }
    }
    store_states(at(alphas, t), a);
    store_states(at(betas, t), bt);
  }

  // the to side into the same region, once every gather of the from side
  // has ended
  __syncthreads();
  if (tid == 0) {
    fence_proxy_async();
    mbar_expect(bar_addr, side_bytes(deg_to));
    copy_side(book, table, deg_to,
              to_packed + (kBatch ? (size_t)b * deg_to * N : 0),
              to_book + (kBatch ? (size_t)b * deg_to * GROUPS * CODES : 0),
              bar_addr);
  }

  // backward: gm = gamma_{t+1}, from gamma_{T-1} = beta_{T-1}; for
  // t >= len - 1, gamma_t = beta_t = the frozen beta.  A read of length 0
  // freezes beta from t = 1 on, as one of length 1, so its frozen rows end
  // at t = 0 (not t = -1: that row is the read before's)
  float gm[4] = {bt[0], bt[1], bt[2], bt[3]};
  const int t_top = min(T - 2, max(len, 1) - 2);
  for (int t = T - 1; t > t_top; --t) store_states(at(gammas, t), bt);
  mbar_wait(bar_addr, 1);
  const bool to_prone = book_prone(book, deg_to, tid);
  // alpha_{t+1} and beta_t of the step, loaded one step ahead
  float an[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (t_top >= 0) {
    load_states(at(alphas, t_top + 1), an);
    load_states(at(betas, t_top), bb);
  }
  int par = 0;
  for (int t = t_top; t >= 0; --t) {
    float g[4], bc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g[i] = gm[i] - an[i];
      bc[i] = bb[i];
    }
    if (t > 0) {
      load_states(at(alphas, t), an);
      load_states(at(betas, t - 1), bb);
    }
    // buffer par was last gathered in step t+2, before step t+1's barrier
    float* gb = xbuf + par * N;
    store_states(gb + tid, g);
    prone = __syncthreads_or(any_prone(g)) != 0;
    float r[4];
    lse4_resident<DEG>(to_prone || prone, ent, book, gb, deg_to, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) gm[i] = bc[i] + r[i];
    store_states(at(gammas, t), gm);
    par ^= 1;
  }
}

// The resident K6e under one table's layout for every read.
template <int DEG>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_custom_resident_kernel(const float* __restrict__ ev_mean,
                            const float* __restrict__ ev_stdv,
                            const float* __restrict__ ev_log_stdv,
                            const int32_t* __restrict__ length, int B, int T,
                            int deg_from,
                            const uint16_t* __restrict__ from_packed,
                            const float* __restrict__ from_book, int deg_to,
                            const uint16_t* __restrict__ to_packed,
                            const float* __restrict__ to_book,
                            const float* __restrict__ level_mean,
                            const float* __restrict__ level_stdv,
                            const float* __restrict__ log_level_stdv,
                            const float* __restrict__ sd_mean,
                            const float* __restrict__ sd_lambda,
                            const float* __restrict__ log_sd_lambda,
                            float log2pi, float log_n,
                            float* __restrict__ alphas,
                            float* __restrict__ betas,
                            float* __restrict__ gammas) {
  fwbw_custom_resident_body<DEG, false>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
      from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
      log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
      alphas, betas, gammas);
}

// The resident K6e under per-read layouts.
template <int DEG>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_custom_resident_batch_kernel(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg_from,
    const uint16_t* __restrict__ from_packed,
    const float* __restrict__ from_book, int deg_to,
    const uint16_t* __restrict__ to_packed,
    const float* __restrict__ to_book, const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ alphas, float* __restrict__ betas,
    float* __restrict__ gammas) {
  fwbw_custom_resident_body<DEG, true>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
      from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
      log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
      alphas, betas, gammas);
}

}  // namespace

// The resident kernel: each side's `packed` (deg, N) uint16 and `book`
// (deg, GROUPS * CODES) float32 as ops/hmm.py pack_fwbw_sides lays them
// out (per_read: (B, deg, N) and (B, deg, GROUPS * CODES), read b's its
// own), all 16-byte aligned, 1 to MAX_DEG slots a side.  Its dynamic
// shared memory is set for every launch.
extern "C" int nc_fwbw_custom_resident(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg_from,
    const uint16_t* from_packed, const float* from_book, int deg_to,
    const uint16_t* to_packed, const float* to_book,
    const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean,
    const float* sd_lambda, const float* log_sd_lambda, float log2pi,
    float log_n, float* alphas, float* betas, float* gammas, int per_read,
    int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (deg_from < 1 || deg_from > MAX_DEG || deg_to < 1 || deg_to > MAX_DEG)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && T > 0) {
    const int deg = deg_from > deg_to ? deg_from : deg_to;
    const int smem = 2 * nc::N * 4 + deg * (GROUPS * CODES * 4 + nc::N * 2);
    const bool r73 = deg_from == 21 && deg_to == 21;
    auto kernel =
        per_read ? (r73 ? fwbw_custom_resident_batch_kernel<21>
                        : fwbw_custom_resident_batch_kernel<0>)
                 : (r73 ? fwbw_custom_resident_kernel<21>
                        : fwbw_custom_resident_kernel<0>);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, nc::THREADS, smem, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
        from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
        log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
        alphas, betas, gammas);
  }
  return (int)cudaGetLastError();
}
