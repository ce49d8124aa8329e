// The body of K6cm (fwbw_generic_wave.cu: K6c with the states split over
// M ranks, the legacy EM round on the mesh's state axis) and of the
// one-card split of the streaming K6c and K6e (fwbw_split.cu: a read's
// 4096 states cut over a thread block cluster of C blocks on one card),
// inlined into both sources' kernels.  Each source's header holds its
// design; this file holds the arithmetic and the exchange they share.
//
// The forms (FORM):
//   - FORM_WAVE, K6cm: a rank's (deg, W) cut of the table, its (B, W)
//     model and its (B, T, W) slices of the outputs, row stride W.
//   - FORM_GENERIC, K6c on one card: block (c, g) of a cluster steps the
//     states [c W, (c + 1) W) of K6c, reading its cut of the (deg, N) table
//     (or read b's (B, deg, N) log-probs, BATCH) and of the (B, N) model at
//     the cut's column offset, row stride N, and writing its columns of the
//     (B, T, N) alpha, beta and em in place; block 0 writes log Pr[data].
//   - FORM_CUSTOM, K6e on one card, likewise: alpha, beta and gamma in
//     place (gamma through the entry's `col`), em in a (B, T, N) scratch.
// S states a thread (u + i W / S, i < S; FORM_WAVE: S = 4), R reads a
// block (the one-card split: R = 1).
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so every form is bit-identical to its
// plain version in nanocall_tpu_torch/ops/hmm.py on the card.

#pragma once

#include "resident_slots.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// the most reads a block takes (ops/hmm.py FWBW_WAVE_MAX_READS)
constexpr int MAX_READS = 8;

constexpr int FORM_WAVE = 0;
constexpr int FORM_GENERIC = 1;
constexpr int FORM_CUSTOM = 2;

// The ranks of a K6cm launch (as K6am's GenericWaveRank): one entry a rank
// of the data row (the M entries, then the ranks this launch runs, as
// int64), in device memory of the launch's card; every pointer on the
// rank's own card.  The one-card forms: one entry a block of the cluster,
// every pointer at the block's first state (c W on), the row strides N.
struct FwbwWaveRank {
  const float* ev_mean;  // (B, T) events and (B,) lengths, the row's
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  // the rank's cut of each side: RESIDENT the (deg, W) packed uint16 and
  // the (deg, GROUPS * CODES) codebooks, else (deg, W) int32 / float32
  const void* from_table;
  const float* from_values;
  const void* to_table;
  const float* to_values;
  // (B, W): level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
  // log_sd_lambda of the rank's states
  const float* model[6];
  float* alpha;    // (B, T, W): the rank's slices of the outputs
  float* beta;
  float* em;
  float* col;      // (2, B, W): its slice of exchange k at k & 1; K6e on
                   // one card: its columns of gamma
  float* part;     // (2, B): its partial max and sum of the final alpha
  float* lpd;      // (B,)
  int32_t* flags;  // (B,): the counter (a read group's first read's)
};

// cycles of the SPLIT instances: wait, slot loop, push, steps stamped
__device__ unsigned long long k6cm_split[4];

// the pairwise-tree sum of the first 1 << levels lanes, in lane 0
__device__ __forceinline__ float lane_tree_sum(float v, int levels) {
  for (int off = 1; off < (1 << levels); off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// the lanes of the warp that hold read r of a block of R reads (lanes r,
// r + R, ..)
__device__ __forceinline__ unsigned read_lanes(int R, int r) {
  return (0xffffffffu / ((1u << R) - 1u)) << r;
}

// lse over the deg slots of lp[k] + x[idx[k]] of one state of a (deg, W)
// int32 / float32 cut (idx, lp at the state's entry of slot 0, slot k's
// k * stride on), in ops/hmm.py logsumexp_slots' order: the max
// (NaN-propagating), then the slot-ordered sum of exp(v - safe).  SUB: the
// gathered value is x[idx[k]] - c (K6e's beta from its column and its
// log-normaliser: the bits of the stored beta)
template <bool SUB>
__device__ __forceinline__ float lse_streaming(const int32_t* idx,
                                               const float* lp, int deg,
                                               int stride, const float* x,
                                               float c) {
  auto gathered = [&](int k) {
    const float g = x[__ldg(idx + (size_t)k * stride)];
    return SUB ? g - c : g;
  };
  float m = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const float v = __ldg(lp + (size_t)k * stride) + gathered(k);
    m = k == 0 ? v : amax(m, v);
  }
  const float safe = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const float e = expf((__ldg(lp + (size_t)k * stride) + gathered(k)) -
                         safe);
    s = k == 0 ? e : s + e;
  }
  return isfinite(m) ? safe + logf(s) : m;
}

// lse_streaming of a thread's S states u + i Q (idx, lp at state u's entry
// of slot 0), one state at a time: the loop is not unrolled, so the
// results rotate through out[] (static indices: registers)
template <bool SUB, int S>
__device__ __forceinline__ void lse_states(const int32_t* idx,
                                           const float* lp, int Q, int deg,
                                           int stride, const float* x,
                                           float c, float (&out)[S]) {
#pragma unroll 1
  for (int i = 0; i < S; ++i) {
    const float v =
        lse_streaming<SUB>(idx + i * Q, lp + i * Q, deg, stride, x, c);
#pragma unroll
    for (int q = 0; q + 1 < S; ++q) out[q] = out[q + 1];
    out[S - 1] = v;
  }
}

// The lse of a thread's 4 states of the resident cut, the slice's states
// s, s + Q, s + 2 Q, s + 3 Q (ent at state s's entry of slot 0, book at
// slot 0's codebooks, lo the slice's first state in the column: state s +
// i Q reads the codebook of its block of 1024, which every lane of the
// warp shares), one state at a time: the loop is not unrolled, so the
// results rotate through out[] (static indices: registers), as
// resident_slots.cuh lse4_states.
template <bool kNan, int DEG>
__device__ __forceinline__ void lse4_cut(const uint16_t* ent,
                                         const float* book, int lo, int Q,
                                         const float* x, int deg, int stride,
                                         float (&out)[4]) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const float r = lse_resident<kNan, DEG>(
        ent + i * Q, book + ((lo + i * Q) >> 10) * CODES, x, deg, stride);
    out[0] = out[1];
    out[1] = out[2];
    out[2] = out[3];
    out[3] = r;
  }
}

// the pairwise tree of a thread's S subtree sums (states [i Q, (i + 1) Q)
// of the slice), as tree_sum adds the slice's S quarters or halves
template <int S>
__device__ __forceinline__ float fold_states(const float (&v)[S]) {
  if constexpr (S == 4) return (v[0] + v[1]) + (v[2] + v[3]);
  if constexpr (S == 2) return v[0] + v[1];
  return v[0];
}

// The bytes of a side's cut: its codebooks and its (deg, W) entries.
__host__ __device__ __forceinline__ uint32_t cut_bytes(int deg, int W) {
  return (uint32_t)(deg * (GROUPS * CODES * 4 + W * 2));
}

// The floats of the column buffers of R reads (CLUSTER: both parities),
// read r's column_stride(R) r on: N floats and 32 / R more, so that the R
// lanes of a warp that gather one index of their R reads' columns (and the
// 32 / R consecutive indices of a read's lanes) fall in distinct banks;
// then (CLUSTER and RESIDENT) the vote words of both parities: 32 R a
// parity (the M ranks' R W / 128 warps), then the threads' em buffers,
// then (K6e on one card) the normalisation's area (norm_floats).
__host__ __device__ __forceinline__ int column_stride(int R) {
  return N + 32 / R;
}

__host__ __device__ __forceinline__ int column_floats(int R, bool cluster) {
  return (cluster ? 2 : 1) * R * column_stride(R);
}

__host__ __device__ __forceinline__ int vote_words(int R, bool cluster,
                                                   bool resident) {
  return cluster && resident ? 2 * 32 * R : 0;
}

// the em buffers of the block's threads: S floats a thread and parity
__host__ __device__ __forceinline__ int em_floats(int threads, int S = 4) {
  return 2 * S * threads;
}

// K6e's normalisation on one card, for R reads over C blocks: two
// mbarriers (4 floats), each read's C partial maxima and C partial sums
// at both parities, and the warps' partial maxima of each read
__host__ __device__ __forceinline__ int norm_floats(int R, int C) {
  return 4 + 2 * 2 * R * C + R * WARPS;
}

// 4 bytes from global memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// until this thread's cp.async copies are in
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// K6cm (FORM_WAVE): both passes of R = 1 << lg_reads reads for one rank,
// which holds the states [rank W, (rank + 1) W), W = 1 << slice_shift, on
// R W / 4 threads.  Read group g holds the reads wave_lo + g R .. (those
// below wave_hi).  The exchange: CLUSTER, a group's M ranks one cluster of
// a grid (M, groups), block (r, g) the rank r of group g; else a
// cooperative grid (groups, ranks this launch runs), block (g, j) group g
// for the rank named by entry j of the launch's ranks (after the M = N >>
// slice_shift entries of `wave`).  Dynamic shared memory: the columns
// (column_floats), the vote words (vote_words), the em buffers
// (em_floats), then RESIDENT the codebooks (deg x GROUPS x CODES float32)
// and the rank's cut (deg x W uint16), deg the larger side's, or (K6e on
// one card) norm_floats.  DEG > 0: both sides have DEG slots.  The one-card
// forms take CLUSTER, not RESIDENT, and R W / S threads.
template <bool SYS, bool RESIDENT, bool CLUSTER, int DEG, bool SPLIT,
          int FORM, int S, bool BATCH>
__device__ __forceinline__ void fwbw_wave_body(
    const FwbwWaveRank* __restrict__ wave, int B, int T, int wave_lo,
    int wave_hi, int slice_shift, int lg_reads, int deg_from, int deg_to,
    float log2pi, float log_n, long long timeout_ns, int32_t* timed_out) {
  constexpr bool ONE = FORM != FORM_WAVE;
  constexpr bool CUSTOM = FORM == FORM_CUSTOM;
  constexpr int LG_S = S == 4 ? 2 : S == 2 ? 1 : 0;
  static_assert(S == 4 || S == 2 || S == 1, "1, 2 or 4 states a thread");
  static_assert(!ONE || (CLUSTER && !RESIDENT && !SYS),
                "the one-card forms stream their table over a cluster");
  static_assert(ONE || (S == 4 && !BATCH), "K6cm: 4 states, one table");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Exchange x;
  __shared__ __align__(8) uint64_t bar;
  // CLUSTER: exchange k's completion in buffer k & 1
  __shared__ __align__(8) uint64_t xbar[2];
  // the warps' partials of each read (and of each of a thread's S states)
  __shared__ float sWarp[MAX_READS * 4][WARPS];
  // CLUSTER: each read's partial max and sum of the final alpha
  __shared__ float sPub[2][MAX_READS];
  __shared__ float sM[MAX_READS];
  const int deg_max = deg_from > deg_to ? deg_from : deg_to;
  const int ranks = N >> slice_shift;
  const int R = 1 << lg_reads;
  const int W = 1 << slice_shift;
  const int tid = threadIdx.x;
  const int nthreads = (W >> LG_S) << lg_reads;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int r = tid & (R - 1), u = tid >> lg_reads;
  const int Q = W >> LG_S, CS = column_stride(R);
  // the row stride of the outputs, the model and the table
  const int OS = ONE ? N : W;
  float* const column = reinterpret_cast<float*>(smem);
  float* const votes = column + column_floats(R, CLUSTER);
  float* const emb = votes + vote_words(R, CLUSTER, RESIDENT);
  float* const book = emb + em_floats(nthreads, S);
  uint16_t* const table =
      reinterpret_cast<uint16_t*>(book + deg_max * GROUPS * CODES);
  const int rank =
      CLUSTER ? (int)blockIdx.x
              : (int)reinterpret_cast<const long long*>(wave + ranks)
                    [blockIdx.y];
  const int b0 = wave_lo + ((int)(CLUSTER ? blockIdx.y : blockIdx.x)
                            << lg_reads);
  const int nr = min(R, wave_hi - b0);  // the group's reads
  const bool real = r < nr;
  const int b = real ? b0 + r : b0;
  const FwbwWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
  // the thread's first state in the column (its state i lies i Q on)
  const int j = (rank << slice_shift) + u;
  const size_t colstride = (size_t)B * W;
  // CLUSTER: an exchange's bytes into each block; the last exchange.  K6e
  // on one card: T forward exchanges (x and the ranks' partial maxima),
  // then T - 1 backward ones (the column alone)
  const uint32_t xbytes = (uint32_t)(nr * N * 4) +
                          (RESIDENT ? 32u * 4u * (uint32_t)R : 0u);
  const int last_k = CUSTOM ? 2 * T - 2 : 2 * T - 3;
  auto bytes_of = [&](int k) -> uint32_t {
    if constexpr (CUSTOM)
      return xbytes + (k < T ? (uint32_t)(nr * ranks * 4) : 0u);
    return xbytes;
  };
  // K6e on one card: its normalisation's mbarriers (the ranks' partial
  // sums of step t at t & 1), the ranks' partial maxima and sums of each
  // read at both parities, the warps' partial maxima
  float* const norm = book;
  uint64_t* const nbar = reinterpret_cast<uint64_t*>(norm);
  float* const pmax = norm + 4;
  float* const psum = pmax + 2 * R * ranks;
  float* const wmax = psum + 2 * R * ranks;
  if constexpr (CLUSTER) {
    if (tid == 0) {
      mbar_init(smem_addr(&xbar[0]), 1);
      mbar_init(smem_addr(&xbar[1]), 1);
      if constexpr (CUSTOM) {
        mbar_init(smem_addr(&nbar[0]), 1);
        mbar_init(smem_addr(&nbar[1]), 1);
      }
      fence_mbarrier_init();
      if constexpr (CUSTOM) {
        const uint32_t sbytes = (uint32_t)(nr * ranks * 4);
        mbar_expect(smem_addr(&xbar[0]), bytes_of(0));
        mbar_expect(smem_addr(&nbar[0]), sbytes);
        if (T > 1) {
          mbar_expect(smem_addr(&xbar[1]), bytes_of(1));
          mbar_expect(smem_addr(&nbar[1]), sbytes);
        }
      } else if (T > 1) {
        mbar_expect(smem_addr(&xbar[0]), xbytes);
        mbar_expect(smem_addr(&xbar[1]), xbytes);
      }
    }
  } else {
    for (int p = tid; p < ranks; p += nthreads) {
      x.col[p] = wave[p].col;
      x.flag[p] = wave[p].flags + b0;
    }
    if (tid == 0) {
      x.timed_out = timed_out;
      x.timeout_ns = timeout_ns;
      x.ranks = ranks;
      x.rank = rank;
      x.read = b0;
    }
  }
  // one side's cut into shared memory, reported to the mbarrier
  auto copy_cut = [&](int deg, const void* packed, const float* cb) {
    bulk_copy(smem_addr(book), cb, deg * GROUPS * CODES * 4, bar_addr);
    for (int k = 0; k < deg; ++k)
      bulk_copy(smem_addr(table + k * W),
                static_cast<const uint16_t*>(packed) + (size_t)k * W, W * 2,
                bar_addr);
  };
  if (RESIDENT && tid == 0) {
    mbar_init_expect(bar_addr, cut_bytes(deg_from, W));
    copy_cut(deg_from, e.from_table, e.from_values);
  }

  const int len = real ? e.length[b] : 0;
  // the thread's first state of row t of a (B, T, W) output (one card:
  // its columns of a (B, T, N) one)
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * OS + u;
  };
  auto store = [&](float* p, const float (&v)[S]) {
    if (real) {
#pragma unroll
      for (int i = 0; i < S; ++i) p[i * Q] = v[i];
    }
  };
  // the stored em of row t, read back by this thread a step ahead into
  // its em buffer t & 1 by cp.async (from L2: this launch wrote it), so
  // that no register holds it through the slot loop
  auto fetch_em = [&](int t) {
    if (real) {
      const uint32_t dst = smem_addr(emb + ((t & 1) * nthreads + tid) * S);
      const float* src = at(e.em, t);
#pragma unroll
      for (int i = 0; i < S; ++i) cp_async4(dst + 4 * i, src + i * Q);
    }
  };
  // em of row t, fetched before (0 in a lane past the row's end)
  auto take_em = [&](int t, float (&v)[S]) {
    if (real) {
      cp_async_wait_all();
      const float* p = emb + ((t & 1) * nthreads + tid) * S;
      if constexpr (S == 4) {
        unpack4(v, *reinterpret_cast<const float4*>(p));
      } else {
#pragma unroll
        for (int i = 0; i < S; ++i) v[i] = p[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < S; ++i) v[i] = 0.0f;
    }
  };

  // every em(t) of the thread's states, stored; alpha(0) (K6e: its x(0) =
  // em(0) + alpha(0), alpha(0) = -log n)
  float a[S];
  {
    const size_t row = (size_t)b * OS + u;
    float m[6][S];
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int i = 0; i < S; ++i) m[q][i] = __ldg(e.model[q] + row + i * Q);
    const float* evm = e.ev_mean + (size_t)b * T;
    const float* evs = e.ev_stdv + (size_t)b * T;
    const float* evl = e.ev_log_stdv + (size_t)b * T;
    for (int t = 0; t < (real ? T : 1); ++t) {
      const float xe = evm[t], ye = evs[t], le = evl[t];
      float em[S];
#pragma unroll
      for (int i = 0; i < S; ++i)
        em[i] = emission(xe, ye, le, m[0][i], m[1][i], m[2][i], m[3][i],
                         m[4][i], m[5][i], log2pi);
      store(at(e.em, t), em);
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < S; ++i) a[i] = em[i] - log_n;
      }
    }
  }

  // CLUSTER: the thread's S values of exchange k into every block's
  // column buffer k & 1 of its read, and (RESIDENT) the warp's vote word
  // (lane p pushing it into block p)
  auto push = [&](int k, const float (&v)[S]) {
    const int q = k & 1;
    const uint32_t mb = smem_addr(&xbar[q]);
    if (real) {
      const uint32_t dst = smem_addr(column + (q * R + r) * CS + j);
      for (int p = 0; p < ranks; ++p) {
        const uint32_t d = cluster_map(dst, p), m = cluster_map(mb, p);
#pragma unroll
        for (int i = 0; i < S; ++i) st_async(d + 4 * i * Q, v[i], m);
      }
    }
    if constexpr (RESIDENT) {
      const bool pr =
          __any_sync(FULL, nan_prone(v[0]) || nan_prone(v[1]) ||
                               nan_prone(v[2]) || nan_prone(v[3]));
      if (lane < ranks)
        st_async(cluster_map(smem_addr(votes + q * 32 * R + rank * nwarps +
                                       warp),
                             lane),
                 pr ? 1.0f : 0.0f, cluster_map(mb, lane));
    }
  };
  // CLUSTER: until exchange k is in (its mbarrier's phase k >> 1), thread
  // 0 then arming the buffer for exchange k + 2; RESIDENT: whether a vote
  // word of it is set.  The warp passes the wait together, so that a lane
  // past the row's end (which pushes nothing and, streaming, meets no other
  // warp-wide call a step) cannot fall a phase behind its warp's lanes
  auto take = [&](int k) -> bool {
    const int q = k & 1;
    const uint32_t mb = smem_addr(&xbar[q]);
    mbar_wait_cluster(mb, (k >> 1) & 1);
    __syncwarp();
    if (tid == 0 && k + 2 <= last_k) mbar_rearm(mb, bytes_of(k + 2));
    if constexpr (RESIDENT) {
      bool p = false;
      for (int i = lane; i < 32 * R; i += 32)
        p = p || votes[q * 32 * R + i] != 0.0f;
      return __any_sync(FULL, p);
    }
    return false;
  };
  // cooperative: the thread's 4 values of exchange k into the rank's
  // buffer k & 1
  auto store_own = [&](int k, const float (&v)[S]) {
    store(e.col + (size_t)(k & 1) * colstride + (size_t)b * W + u, v);
  };
  // cooperative: publish the rank's slices of exchange k (every thread's
  // stored) behind counter value c, wait for the peers', load the group's
  // whole columns into shared memory; RESIDENT: whether a value of them is
  // NaN or +inf (the vote covers every rank's slices)
  auto exchange = [&](int k, int c) -> bool {
    __syncthreads();
    if (tid == 0) st_flag<SYS>(x.flag[x.rank], c);
    if (warp == 0) {
      __syncwarp();
      wait_ranks<SYS>(x, x.flag, c, lane);
    }
    __syncthreads();
    const size_t src = (size_t)(k & 1) * colstride + (size_t)b0 * W;
    bool p = false;
    for (int i = 4 * tid; i < nr * N; i += 4 * nthreads) {
      const int ii = i & (N - 1);
      const float4 v = ld_column4<SYS>(x.col[ii >> slice_shift] + src +
                                       (size_t)(i >> 12) * W +
                                       (ii & (W - 1)));
      *reinterpret_cast<float4*>(column + (i >> 12) * CS + ii) = v;
      p = p || nan_prone(v.x) || nan_prone(v.y) || nan_prone(v.z) ||
          nan_prone(v.w);
    }
    if (RESIDENT) return __syncthreads_or(p) != 0;
    __syncthreads();
    return false;
  };
  // the slot log-sum-exp of the thread's S states from the column `cur`
  // over one side (RESIDENT: the cut in shared memory, nan its vote; else
  // the (deg, W) cut `idx` / `lp` from L2, BATCH read b's log-probs; SUB:
  // the gathered value less c)
  auto lse4 = [&](bool nan, const float* cur, int deg, const void* idx,
                  const float* lp, float (&out)[S]) {
    if constexpr (RESIDENT) {
      if (nan)
        lse4_cut<true, DEG>(table + u, book, rank << slice_shift, Q, cur,
                            deg, W, out);
      else
        lse4_cut<false, DEG>(table + u, book, rank << slice_shift, Q, cur,
                             deg, W, out);
    } else {
      lse_states<false, S>(
          static_cast<const int32_t*>(idx) + u,
          lp + u + (BATCH ? (size_t)b * deg * N : 0), Q, deg, OS, cur, 0.0f,
          out);
    }
  };
  // whether a side's codebooks in shared memory hold NaN or +inf
  auto book_vote = [&](int deg) {
    bool p = false;
    for (int i = tid; i < deg * GROUPS * CODES; i += nthreads)
      p = p || nan_prone(book[i]);
    return __syncthreads_or(p) != 0;
  };
  // SPLIT: cycles of thread 0's wait, slot loop and push
  unsigned long long c_wait = 0, c_slot = 0, c_push = 0;
  auto stamp = [&]() -> long long { return SPLIT ? clock64() : 0; };

  if constexpr (CUSTOM) {
    // K6e's forward: at step t the gathered column is that of step t - 1,
    // x (= em + alpha) whose beta is x - c (c that step's log-normaliser),
    // or a read's frozen beta (c = 0) past its end; the step pushes its
    // own x with the block's partial max of it (exchange t), then the
    // block's partial tree sum of exp(x - m) (its mbarrier nbar[t & 1]),
    // and every block folds the C partials in rank order
    cluster_arrive();
    cluster_wait();
    const int t_alpha = len > 1 ? len : 1;
    float xs[S], bt[S];
    float c_prev = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      xs[i] = a[i];
      a[i] = -log_n;
      bt[i] = 0.0f;
    }
    if (1 < len) fetch_em(1);
    for (int t = 0; t < T; ++t) {
      const bool live = t == 0 || t < len;
      if (t > 0) {
        // column t - 1 came in with take(t - 1) of the step before
        if (t <= t_alpha) {
          lse_states<true, S>(
              static_cast<const int32_t*>(e.from_table) + u,
              e.from_values + u + (BATCH ? (size_t)b * deg_from * N : 0), Q,
              deg_from, OS, column + (((t - 1) & 1) * R + r) * CS, c_prev,
              a);
        }
        if (live) {
          float em[S];
          take_em(t, em);
          if (t + 1 < len) fetch_em(t + 1);
#pragma unroll
          for (int i = 0; i < S; ++i) xs[i] = em[i] + a[i];
        }
      }
      float v[S];
#pragma unroll
      for (int i = 0; i < S; ++i) v[i] = live ? xs[i] : bt[i];
      push(t, v);
      // the block's partial max of each read, pushed with its column
      const int q = t & 1;
      float mx = v[0];
#pragma unroll
      for (int i = 1; i < S; ++i) mx = amax(mx, v[i]);
      for (int off = 16; off >= R; off >>= 1)
        mx = amax(mx, __shfl_xor_sync(FULL, mx, off));
      if (lane < R) wmax[lane * WARPS + warp] = mx;
      __syncthreads();
      for (int rr = warp; rr < R; rr += nwarps) {
        const float pm =
            warp_amax(lane < nwarps ? wmax[rr * WARPS + lane] : -INFINITY);
        if (lane < ranks && rr < nr)
          st_async(cluster_map(smem_addr(pmax + (q * R + rr) * ranks + rank),
                               lane),
                   pm, cluster_map(smem_addr(&xbar[q]), lane));
      }
      take(t);
      const float* pm = pmax + (q * R + r) * ranks;
      float m = pm[0];
      for (int p = 1; p < ranks; ++p) m = amax(m, pm[p]);
      // the block's partial tree sum of exp(x - m), its S subtrees over
      // its read's lanes, then the warps
#pragma unroll
      for (int i = 0; i < S; ++i) {
        float ws = expf(v[i] - m);
        for (int off = R; off < 32; off <<= 1)
          ws = ws + __shfl_down_sync(FULL, ws, off);
        if (lane < R) sWarp[4 * lane + i][warp] = ws;
      }
      __syncthreads();
      for (int rr = warp; rr < R; rr += nwarps) {
        float sub[S];
#pragma unroll
        for (int i = 0; i < S; ++i)
          sub[i] = lane_tree_sum(
              lane < nwarps ? sWarp[4 * rr + i][lane] : 0.0f,
              31 - __clz(nwarps));
        const float s = __shfl_sync(FULL, fold_states<S>(sub), 0);
        if (lane < ranks && rr < nr)
          st_async(cluster_map(smem_addr(psum + (q * R + rr) * ranks + rank),
                               lane),
                   s, cluster_map(smem_addr(&nbar[q]), lane));
      }
      mbar_wait_cluster(smem_addr(&nbar[q]), (t >> 1) & 1);
      __syncwarp();
      if (tid == 0 && t + 2 < T)
        mbar_rearm(smem_addr(&nbar[q]), (uint32_t)(nr * ranks * 4));
      // the C partial sums pairwise in rank order (hmm.combine_rank_sums)
      const float* ps = psum + (q * R + r) * ranks;
      float f[MAX_CLUSTER];
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p) f[p] = p < ranks ? ps[p] : 0.0f;
#pragma unroll
      for (int w = 1; w < MAX_CLUSTER; w <<= 1)
#pragma unroll
        for (int p = 0; p + w < MAX_CLUSTER; p += 2 * w)
          if (p + w < ranks) f[p] = f[p] + f[p + w];
      const float cn = m + logf(f[0]);
      if (live) {
#pragma unroll
        for (int i = 0; i < S; ++i) bt[i] = xs[i] - cn;
      }
      c_prev = live ? cn : 0.0f;
      store(at(e.alpha, t), a);
      store(at(e.beta, t), bt);
    }
    // K6e's backward: exchange T + (T - 2 - t) brings gamma(t + 1) -
    // alpha(t + 1); alpha(t + 1) and beta(t) read back by the thread that
    // stored them (L2, not the read-only path)
    float gm[S];
#pragma unroll
    for (int i = 0; i < S; ++i) gm[i] = bt[i];
    store(at(e.col, T - 1), gm);
    for (int t = T - 2; t >= 0; --t) {
      const int k = T + (T - 2 - t);
      float g[S], bb[S];
      const float* an = at(e.alpha, t + 1);
      const float* bp = at(e.beta, t);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        g[i] = gm[i] - (real ? __ldcg(an + i * Q) : 0.0f);
        bb[i] = real ? __ldcg(bp + i * Q) : 0.0f;
      }
      push(k, g);
      take(k);
      if (t >= len - 1) {
#pragma unroll
        for (int i = 0; i < S; ++i) gm[i] = bb[i];
      } else {
        float rs[S];
        lse4(false, column + ((k & 1) * R + r) * CS, deg_to, e.to_table,
             e.to_values, rs);
#pragma unroll
        for (int i = 0; i < S; ++i) gm[i] = bb[i] + rs[i];
      }
      store(at(e.col, t), gm);
    }
    // no block leaves while a peer may still write its shared memory
    cluster_arrive();
    cluster_wait();
    return;
  }

  // forward: exchange k = t - 1 brings column t - 1
  store(at(e.alpha, 0), a);
  if (!CLUSTER && T > 1) store_own(0, a);
  if constexpr (CLUSTER) {
    // every block of the cluster runs, its mbarriers initialised and armed;
    // also orders the cut's mbarrier's init before every wait
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();  // also orders the mbarrier's init before every wait
  }
  bool side_prone = false;
  if (RESIDENT) {
    mbar_wait(bar_addr, 0);
    side_prone = book_vote(deg_from);
  }
  if (CLUSTER && T > 1) push(0, a);
  // em(t) is fetched for the steps t < len that use it
  if (1 < len) fetch_em(1);
  for (int t = 1; t < T; ++t) {
    const int k = t - 1;
    const long long s0 = stamp();
    const float* cur;
    bool prone;
    if constexpr (CLUSTER) {
      prone = take(k) || side_prone;
      cur = column + ((k & 1) * R + r) * CS;
    } else {
      prone = exchange(k, k + 1) || side_prone;
      cur = column + r * CS;
    }
    const long long s1 = stamp();
    if (t < len) {
      float res[S];
      lse4(prone, cur, deg_from, e.from_table, e.from_values, res);
      float em[S];
      take_em(t, em);
      if (t + 1 < len) fetch_em(t + 1);
#pragma unroll
      for (int i = 0; i < S; ++i) a[i] = em[i] + res[i];
    }
    store(at(e.alpha, t), a);
    const long long s2 = stamp();
    if (t < T - 1) {
      if constexpr (CLUSTER)
        push(t, a);
      else
        store_own(t, a);
    }
    if constexpr (SPLIT) {
      c_wait += s1 - s0;
      c_slot += s2 - s1;
      c_push += stamp() - s2;
    }
  }

  // the to side into the same region (every read of the from side ended at
  // the barrier), while the ranks reduce log_pr_data: the partial maxima,
  // their max, then the partial tree sums of exp(final - max), for each of
  // the group's reads
  __syncthreads();
  if (RESIDENT && tid == 0) {
    fence_proxy_async();
    mbar_expect(bar_addr, cut_bytes(deg_to, W));
    copy_cut(deg_to, e.to_table, e.to_values);
  }
  {
    // the warp's partial max of each read (lanes r, r + R, ..), in lane r
    bool nan = false;
#pragma unroll
    for (int i = 0; i < S; ++i) nan = nan || a[i] != a[i];
    const unsigned nan_lanes = __ballot_sync(FULL, nan);
    float mx;
    if constexpr (S == 4) {
      mx = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
    } else {
      mx = a[0];
#pragma unroll
      for (int i = 1; i < S; ++i) mx = fmaxf(mx, a[i]);
    }
    for (int off = 16; off >= R; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    if (lane < R)
      sWarp[4 * lane][warp] =
          (nan_lanes & read_lanes(R, lane)) ? __int_as_float(0x7fffffff)
                                            : mx;
    __syncthreads();
    for (int rr = warp; rr < R; rr += nwarps) {
      const float vm = lane < nwarps ? sWarp[4 * rr][lane] : -INFINITY;
      const float pm = warp_max_nan(vm, vm != vm);
      if (lane == 0) {
        if (CLUSTER)
          sPub[0][rr] = pm;
        else if (rr < nr)
          e.part[b0 + rr] = pm;
      }
    }
    if constexpr (CLUSTER) {
      cluster_arrive();
      cluster_wait();
      for (int rr = warp; rr < R; rr += nwarps) {
        float out[1];
        cluster_max<1>(smem_addr(&sPub[0][rr]), ranks, lane, out);
        if (lane == 0) sM[rr] = out[0];
      }
    } else {
      __syncthreads();
      if (tid == 0) st_flag<SYS>(x.flag[x.rank], T);
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, x.flag, T, lane);
        for (int rr = 0; rr < nr; ++rr) {
          float v = -INFINITY;
          bool nan = false;
          for (int p = lane; p < ranks; p += 32) {
            const float w = ld_column<SYS>(wave[p].part + b0 + rr);
            v = fmaxf(v, w);
            nan = nan || w != w;
          }
          const float mm = warp_max_nan(v, nan);
          if (lane == 0) sM[rr] = mm;
        }
      }
    }
    __syncthreads();
    const float mfin = sM[r];
    // state i of the threads: the subtree of the slice's states [i Q, (i +
    // 1) Q), over its read's lanes, then the warps; then the S subtrees
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float ws = expf(a[i] - mfin);
      for (int off = R; off < 32; off <<= 1)
        ws = ws + __shfl_down_sync(FULL, ws, off);
      if (lane < R) sWarp[4 * lane + i][warp] = ws;
    }
    __syncthreads();
    for (int rr = warp; rr < R; rr += nwarps) {
      float sub[S];
#pragma unroll
      for (int i = 0; i < S; ++i)
        sub[i] = lane_tree_sum(lane < nwarps ? sWarp[4 * rr + i][lane] : 0.0f,
                               31 - __clz(nwarps));
      const float s = fold_states<S>(sub);
      if (lane == 0) {
        if (CLUSTER)
          sPub[1][rr] = s;
        else if (rr < nr)
          e.part[B + b0 + rr] = s;
      }
    }
    if constexpr (CLUSTER) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
      if (tid == 0) st_flag<SYS>(x.flag[x.rank], T + 1);
      if (warp == 0) {
        __syncwarp();
        wait_fold_ranks<SYS>(x, x.flag, T + 1, lane);
      }
    }
    if (warp == 0 && (!ONE || rank == 0)) {
      // each read's M partial sums pairwise in rank order (at 64 ranks a
      // lane adds ranks 2l and 2l + 1 first); on one card block 0 writes it
      const int per_lane = ranks > 32 ? 2 : 1;
      const int lanes = ranks / per_lane;
      for (int rr = 0; rr < nr; ++rr) {
        float v = 0.0f;
        if (lane < lanes) {
          if constexpr (CLUSTER) {
            v = ld_cluster(cluster_map(smem_addr(&sPub[1][rr]), lane));
          } else {
            v = ld_column<SYS>(wave[per_lane * lane].part + B + b0 + rr);
            if (per_lane == 2)
              v = v + ld_column<SYS>(wave[2 * lane + 1].part + B + b0 + rr);
          }
        }
        const float s = lane_tree_sum(v, 31 - __clz(lanes));
        if (lane == 0) e.lpd[b0 + rr] = sM[rr] + logf(s);
      }
    }
  }

  // backward: exchange k = 2 T - 3 - t brings g of event t + 1
  if (RESIDENT) {
    mbar_wait(bar_addr, 1);
    side_prone = book_vote(deg_to);
  }
  float beta[S];
#pragma unroll
  for (int i = 0; i < S; ++i) beta[i] = 0.0f;
  store(at(e.beta, T - 1), beta);
  // g of event t + 1 counts only where t < len - 1: em(t + 1) is fetched
  // for t + 1 < len, else g is beta's 0
  if (T - 1 < len) fetch_em(T - 1);
  for (int t = T - 2; t >= 0; --t) {
    const int k = 2 * T - 3 - t;
    float g[S];
    if (t + 1 < len) take_em(t + 1, g);
    if (t < len) fetch_em(t);
#pragma unroll
    for (int i = 0; i < S; ++i) g[i] = t + 1 < len ? g[i] + beta[i] : 0.0f;
    const long long s0 = stamp();
    const float* cur;
    bool prone;
    if constexpr (CLUSTER) {
      push(k, g);
    } else {
      store_own(k, g);
    }
    const long long s1 = stamp();
    if constexpr (CLUSTER) {
      prone = take(k) || side_prone;
      cur = column + ((k & 1) * R + r) * CS;
    } else {
      prone = exchange(k, k + 3) || side_prone;
      cur = column + r * CS;
    }
    const long long s2 = stamp();
    if (t >= len - 1) {
#pragma unroll
      for (int i = 0; i < S; ++i) beta[i] = 0.0f;
    } else {
      lse4(prone, cur, deg_to, e.to_table, e.to_values, beta);
    }
    store(at(e.beta, t), beta);
    if constexpr (SPLIT) {
      c_push += s1 - s0;
      c_wait += s2 - s1;
      c_slot += stamp() - s2;
    }
  }
  if constexpr (CLUSTER) {
    // no block leaves while a peer may still write its shared memory
    cluster_arrive();
    cluster_wait();
  }
  if constexpr (SPLIT) {
    if (tid == 0) {
      atomicAdd(&k6cm_split[0], c_wait);
      atomicAdd(&k6cm_split[1], c_slot);
      atomicAdd(&k6cm_split[2], c_push);
      atomicAdd(&k6cm_split[3], 2ull * (T - 1));
    }
  }
}

}  // namespace
