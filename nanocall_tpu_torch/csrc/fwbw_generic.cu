// K6c: exact log-space forward-backward under a loaded transition table,
// the resident kernel (a table with K6c's packed layout; ops/hmm.py
// fwbw_route).  A table that streams takes the one-card split
// (fwbw_split.cu).
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
// One block per read, 1024 threads x 4 states, both passes in one launch
// with the time loops inside the block; the gathered vector (alpha
// forward, g backward) lives in shared memory.
//
// The resident kernel (fwbw_resident_kernel) holds a whole side's table in
// shared memory; its layout, side copy and slot arithmetic are
// resident_slots.cuh's, which K6e's resident kernel shares.  A table has that layout (ops/hmm.py pack_slots with
// groups = GROUPS) when every slot holds at most 16 distinct float32 bit
// patterns in each block of n / GROUPS states, on both sides: entry [k, j]
// is 16 bits, the state in the low 12 and a code into the codebook of
// (slot k, j's block) in the high 4.  The block holds 2 deg n B of table,
// deg x GROUPS x 16 float32 of codebooks and two 16 KiB buffers of the
// gathered vector: at most MAX_DEG = 23 slots fit the 227 KB of one block
// (168 KiB + 5.25 KiB of codebooks at the r73 tables' 21).
//   - Copies: the prologue copies the from side with cp.async.bulk onto an
//     mbarrier while the threads compute every em(t) of the read (stored;
//     the passes read it back one step ahead, so the 6 model tables leave
//     the registers); after the forward the same region is refilled with the
//     to side, overlapped with the log_pr_data reduction.  No slot-table
//     byte is read from global memory after either copy.
//   - Thread tid holds the states 1024 i + tid, i < 4 (block i of the
//     codebooks): a warp's entry reads are 64 contiguous bytes and its
//     codebook reads fall in one block's 16 words, free of bank conflicts.
//   - One read of the table per step: for each of its 4 states a thread
//     takes the deg candidates lp + x[idx] into registers once, then the
//     max and the slot-ordered sum of exp(v - safe) from them.  The r73
//     tables' 21 slots a side take an instance without bounds tests
//     (fwbw_resident_kernel<21>): 1048 SASS instructions in its forward
//     loop against 1479 in the instance for any slot count (<0>), which
//     takes 1.2x its time on the same 21-slot table at 512 reads x 128
//     events on an H100 (tools/torch_decode_times.py, in turns against a
//     build that dispatches every table to <0>).
//   - The gathered vector is double-buffered: one barrier a step in each
//     direction, which also reduces whether the new vector holds NaN or
//     +inf (__syncthreads_or).  Only then (or when the codebooks hold NaN or
//     +inf) can a candidate be NaN, and only then does the step take the
//     NaN-propagating max.
//   - A step past a read's end (t >= length forward, t >= length-1
//     backward) keeps alpha or sets beta to 0 without the slot loop.
// What bounds it: issue on the read's one SM, about 20 instructions per
// slot and state (3 shared loads, the entry's cut, the max, the precise
// expf and the sums).  Only B of the 132 SMs work when B < 132.
//
// Per-read tables (ops/hmm.py make_trans_ops_batch, JAX's
// make_trans_ops_batch: read b runs under its own kinetics): the kernel
// has a second instance (fwbw_resident_batch_kernel) whose block b takes
// its read's own packed layout and codebooks of both sides, at b deg N (b
// deg GROUPS CODES) from the start of the (B, ...) tables; from_idx /
// to_idx are every read's.  The body is shared and inlined, so the
// one-table instances compile as before; each side is copied once a pass,
// as before, from distinct addresses.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "device_guard.cuh"
#include "resident_slots.cuh"

namespace {

using namespace nc;

// Dynamic shared memory: the gathered vector (2 x N float32,
// double-buffered), the codebooks (deg x GROUPS x CODES float32), the
// packed table (deg x N uint16), deg the larger side's; one side at a time.
// Thread tid holds the states 1024 i + tid, i < 4 (block i of the
// codebooks): a warp's entry reads are 64 contiguous bytes and its
// codebook reads one block's 16 words.  DEG > 0: both sides have DEG slots.
// The body, inlined into K6c's two resident kernels.  kBatch: per-read
// layouts, packed (B, deg, N) and codebooks (B, deg, GROUPS x CODES) a
// side, of which read b copies its own.
template <int DEG, bool kBatch>
__device__ __forceinline__ void fwbw_resident_body(
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
    float* __restrict__ ems, float* __restrict__ lpd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];
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

  const int len = length[b];
  // the thread's 4 states of row t of a (B, T, n) output: 4 * i on
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * N + tid;
  };
  auto store_states = [&](float* p, const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i * N4] = v[i];
  };
  // the stored em of row t, read back by this thread (L2, not the
  // read-only path: this launch wrote it)
  auto load_em = [&](int t, float (&v)[4]) {
    const float* p = at(ems, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldcg(p + i * N4);
  };
  // the thread's entries (slot 0, state tid) and its state's codebooks
  // (slot 0, block 0)
  const uint16_t* ent = table + tid;

  // every em(t) of the read, stored: the passes read it back
  float a[4];
  {
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
    for (int t = 0; t < T; ++t) {
      const float x = evm[t], y = evs[t], ly3 = 3.0f * evl[t];
      float em[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        em[i] = emission_pre(x, y, ly3, lm[i], ls[i], nlls[i], sm[i],
                             slam[i], c1[i], log2pi);
      store_states(at(ems, t), em);
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = em[i] - log_n;
      }
    }
  }

  // forward
  store_states(at(alphas, 0), a);
  float* cur = xbuf;
  float* nxt = xbuf + N;
  store_states(cur + tid, a);
  __syncthreads();  // also orders the barrier's init before every wait
  mbar_wait(bar_addr, 0);
  const bool from_prone = book_prone(book, deg_from, tid);
  bool prone = __syncthreads_or(any_prone(a)) != 0;
  float emn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (T > 1) load_em(1, emn);
  for (int t = 1; t < T; ++t) {
    const float em[4] = {emn[0], emn[1], emn[2], emn[3]};
    if (t + 1 < T) load_em(t + 1, emn);
    if (t < len) {
      float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      lse4_resident<DEG>(from_prone || prone, ent, book, cur, deg_from, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = em[i] + r[i];
    }
    store_states(at(alphas, t), a);
    // nxt was last read in step t-1, which every thread has left: the
    // barrier below (of step t-1) separates the two
    store_states(nxt + tid, a);
    prone = __syncthreads_or(any_prone(a)) != 0;
    float* const done = cur;
    cur = nxt;
    nxt = done;
  }

  // the to side into the same region (every read of the from side ended at
  // the barrier above), while the block reduces log_pr_data: the max, then
  // exp(final - mfin) staged in state order in xbuf for the pairwise tree
  // over 4 contiguous states a thread, the warp, the warps
  if (tid == 0) {
    fence_proxy_async();
    mbar_expect(bar_addr, side_bytes(deg_to));
    copy_side(book, table, deg_to,
              to_packed + (kBatch ? (size_t)b * deg_to * N : 0),
              to_book + (kBatch ? (size_t)b * deg_to * GROUPS * CODES : 0),
              bar_addr);
  }
  {
    const float mx = warp_amax(amax(amax(a[0], a[1]), amax(a[2], a[3])));
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();
    const float mfin = warp_amax(sMax[lane]);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = expf(a[i] - mfin);
    store_states(xbuf + tid, v);
    __syncthreads();
    unpack4(v, *reinterpret_cast<const float4*>(xbuf + 4 * tid));
    const float ws = warp_tree_sum(quad_sum(v));
    if (lane == 0) sSum[warp] = ws;
    __syncthreads();  // also ends every read of xbuf before the backward
    if (warp == 0) {
      const float s = warp_tree_sum(sSum[lane]);
      if (lane == 0) lpd[b] = mfin + logf(s);
    }
  }

  // backward: g of step t goes to buffer par, gathered after its barrier
  mbar_wait(bar_addr, 1);
  const bool to_prone = book_prone(book, deg_to, tid);
  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  store_states(at(betas, T - 1), beta);
  if (T > 1) load_em(T - 1, emn);
  int par = 0;
  for (int t = T - 2; t >= 0; --t) {
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = emn[i] + beta[i];
    if (t > 0) load_em(t, emn);
    float* gb = xbuf + par * N;
    store_states(gb + tid, g);
    prone = __syncthreads_or(any_prone(g)) != 0;
    if (t >= len - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) beta[i] = 0.0f;
    } else {
      lse4_resident<DEG>(to_prone || prone, ent, book, gb, deg_to, beta);
    }
    store_states(at(betas, t), beta);
    par ^= 1;
  }
}

// The resident K6c under one table's layout for every read.
template <int DEG>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_resident_kernel(const float* __restrict__ ev_mean,
                     const float* __restrict__ ev_stdv,
                     const float* __restrict__ ev_log_stdv,
                     const int32_t* __restrict__ length, int B, int T,
                     int deg_from, const uint16_t* __restrict__ from_packed,
                     const float* __restrict__ from_book, int deg_to,
                     const uint16_t* __restrict__ to_packed,
                     const float* __restrict__ to_book,
                     const float* __restrict__ level_mean,
                     const float* __restrict__ level_stdv,
                     const float* __restrict__ log_level_stdv,
                     const float* __restrict__ sd_mean,
                     const float* __restrict__ sd_lambda,
                     const float* __restrict__ log_sd_lambda, float log2pi,
                     float log_n, float* __restrict__ alphas,
                     float* __restrict__ betas, float* __restrict__ ems,
                     float* __restrict__ lpd) {
  fwbw_resident_body<DEG, false>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
      from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
      log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
      alphas, betas, ems, lpd);
}

// The resident K6c under per-read layouts.
template <int DEG>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_resident_batch_kernel(
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
    float* __restrict__ ems, float* __restrict__ lpd) {
  fwbw_resident_body<DEG, true>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
      from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
      log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
      alphas, betas, ems, lpd);
}

}  // namespace

// The resident kernel: each side's `packed` (deg, N) uint16 and `book`
// (deg, GROUPS * CODES) float32 as ops/hmm.py pack_slots lays them out with
// groups = GROUPS (per_read: (B, deg, N) and (B, deg, GROUPS * CODES), read
// b's its own), all 16-byte aligned, 1 to MAX_DEG slots a side.  Its
// dynamic shared memory is set for every launch.
extern "C" int nc_fwbw_resident(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg_from,
    const uint16_t* from_packed, const float* from_book, int deg_to,
    const uint16_t* to_packed, const float* to_book,
    const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean,
    const float* sd_lambda, const float* log_sd_lambda, float log2pi,
    float log_n, float* alphas, float* betas, float* ems, float* lpd,
    int per_read, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (deg_from < 1 || deg_from > MAX_DEG || deg_to < 1 || deg_to > MAX_DEG)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && T > 0) {
    const int deg = deg_from > deg_to ? deg_from : deg_to;
    const int smem = 2 * nc::N * 4 + deg * (GROUPS * CODES * 4 + nc::N * 2);
    // the r73 tables' 21 slots a side: the slot loops without bounds tests
    // (the header: 1.2x faster than <0> on them)
    const bool r73 = deg_from == 21 && deg_to == 21;
    auto kernel =
        per_read
            ? (r73 ? fwbw_resident_batch_kernel<21>
                   : fwbw_resident_batch_kernel<0>)
            : (r73 ? fwbw_resident_kernel<21> : fwbw_resident_kernel<0>);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, nc::THREADS, smem, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg_from, from_packed,
        from_book, deg_to, to_packed, to_book, level_mean, level_stdv,
        log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
        alphas, betas, ems, lpd);
  }
  return (int)cudaGetLastError();
}
