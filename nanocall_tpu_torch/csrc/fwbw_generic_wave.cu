// K6cm: K6c (fwbw_generic.cu, the exact log-space forward-backward under a
// loaded transition table) with the 4096 states split over M = 2 .. 64
// ranks: the legacy EM round's rows at the CLI priors under nanocall_tpu/
// parallel/mesh.py:126 shard_train_inputs (parallel/statepar.py drives it;
// K4m and K6dm run the round's other rows).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw (+ _logsumexp_slots and
// log_emission) under that placement, where GSPMD splits its scans' state
// axis over 'model'.  The recursions are K6c's (fwbw_generic.cu's header):
// per step, for each state, the slot log-sum-exp over the (deg, n) tables
//   alpha'[j] = t < length ? em(t, j) + lse(from_logp[k, j]
//                                           + alpha[from_idx[k, j]])
//                          : alpha[j]
//   beta[i]   = t >= length-1 ? 0 : lse(to_logp[k, i] + g[to_idx[k, i]]),
//   g = em(t+1) + beta,
// and log_pr_data = mfin + log(sum_j exp(final[j] - mfin)).
//
// Design (for the H100).  Every row that takes K6cm runs under one table
// (the CLI priors'; a rank's cut of it is the same for every read), so a
// block may take R reads of the data row for its rank (R a power of two;
// ops/hmm.py fwbw_wave_reads: on the cluster path 2 where a block of one
// read fills its SM, the resident cut of 2048 states, else 1, which packs
// the SMs with whole clusters; on the cooperative path as many as N / W
// and the block's shared memory allow, up to 8: one rendezvous a step
// serves them all; each chosen by timing 1, 2, 4 and 8 at 512 x 128,
// tools/torch_decode_times.py --legacy-mesh) on R x W / 4 threads, thread
// tid stepping the 4 states u + i W / 4 (i < 4) of the rank's slice
// [rank W, (rank + 1) W) for read r = tid % R, u = tid / R: K6c's 4 states
// a thread in K6c's layout (a read's consecutive lanes step consecutive
// states, so that the structured tables' gathers spread over the banks),
// the one cut in shared memory serving R reads, and the R reads of a
// state in adjacent lanes, so that a warp's entry and codebook reads of a
// slot (the streaming form's idx / lp loads too) serve its R reads at
// once; each read's column lies 32 / R banks on from the one before
// (column_stride), so that the R lanes' gathers of one index do not
// conflict.  A read past a row's end
// (the last group of a row whose read count is not a multiple of R) is a
// lane that stores and pushes nothing.  A loaded table's from- and
// to-states lie anywhere, so each step, in both directions, a block needs
// the whole column of the gathered vector (alpha forward, g backward) of
// each of its reads in its shared memory.  The exchanges are numbered k =
// 0, 1, .. (the forward's columns 0 .. T - 2, then the backward's g of
// events T - 1 .. 1), exchange k in buffer k & 1.
//   - CLUSTER (one card, M <= 8): a read group's M blocks are one thread
//     block cluster.  Each thread pushes its 4 values of exchange k into
//     every block's buffer k & 1 by st.async, reporting each value's 4
//     bytes to that block's mbarrier of the buffer, and each warp pushes its NaN
//     vote word (below) the same way every step, so an exchange's bytes
//     are fixed: the group's reads times N floats, plus 32 R vote words
//     when resident.  A block arms its own mbarrier for those bytes and
//     waits on it alone: no rendezvous of the cluster a step.  The double
//     buffer stays safe without one: a thread pushes exchange k + 1 only
//     after its own reads of buffer k & 1 (its slot loop of step k), so
//     when a block sees exchange k + 1 complete, every thread of every
//     peer has finished reading its buffer k & 1, and only then does the
//     block compute and push exchange k + 2 into it.  For the same reason
//     phase k + 2 of an mbarrier cannot complete before every thread of
//     its block has passed its wait on phase k, and thread 0 re-arms
//     buffer k & 1 for exchange k + 2 right after its own wait.  A lane
//     past the row's end pushes nothing, so no peer waits for it; each
//     warp passes a wait together (__syncwarp), and a warp's lane of read
//     0 always pushes, so no lane falls a phase behind.  One cluster
//     barrier before the first push (the mbarriers' init), two in log
//     Pr[data]'s fold and one at the end (no block leaves while a peer may
//     still write its shared memory).
//   - Else (across cards, or 16 to 64 ranks) a cooperative grid a wave:
//     each rank's slice of the vector in its (2, B, W) buffer in global
//     memory behind the group's first read's counter (the cooperative
//     counter: k + 1 forward, k + 3 backward), the group's columns loaded
//     whole from the ranks' buffers.
//   - The table: RESIDENT, the rank's (deg, W) cut of K6c's packed layout
//     (hmm.pack_fwbw_sides: 16-bit entries, 4 codebooks of 16 a slot, one
//     per block of 1024 states) in shared memory, one side at a time (the
//     from side by cp.async.bulk in the prologue, the to side refilled
//     after the forward, under log_pr_data's reduction); the slot
//     arithmetic is resident_slots.cuh's (lse_resident at the cut's
//     stride).  A warp's lanes step states of one block of 1024 at a time:
//     its codebook reads fall in one block's 16 words.  Else
//     (streaming) the (deg, W) int32 / float32 cut read from L2 twice a
//     step (the max, then the sum), as K6c's streaming kernel reads the
//     whole table.
//   - The NaN vote that lets the resident form take fmaxf is per block:
//     on the cluster path the OR of the warps' vote words of the exchange
//     (a warp's word set when one of its values is NaN or +inf), on the
//     cooperative path a block vote over the loaded columns; with the
//     codebooks' own vote.  A vote raised by one read only sends the
//     block's other reads to the NaN-propagating max, which gives the same
//     bits.
//   - A step past a read's end (t >= length forward, t >= length-1
//     backward) skips the slot loop (a read's ranks share its length), but
//     the block still takes part in the exchange until its longest read
//     ends (T - 1 steps each way).
//   - The emissions of every event are computed once in the prologue and
//     stored (the em output); the passes fetch them back one step ahead by
//     cp.async into a buffer of the thread's own in shared memory (no
//     register holds them through the slot loop), only for the steps
//     that use them: em(t) for t < length.
//   - log Pr[data]: for each read, each rank's NaN-voted partial max of its
//     final alpha, the max over the ranks' partials, then each rank's
//     pairwise tree sum of exp(alpha - max) over its states (its slice is
//     a whole subtree of ops/hmm.py tree_sum's, and so is each quarter of
//     it that the threads' state i covers: the lanes of its read in the
//     warp, then the warps, then the 4 quarters), the M partial sums
//     combined pairwise in rank order by every rank (hmm.combine_rank_sums).
// So every rank computes K6c's bits for its states, NaN bits included.
// What bounds it: K6c's slot loop over the SM's states (issue), plus the
// exchange's latency twice a step; in the streaming form the cut's bytes
// from L2.
//
// The SPLIT instances (built only by tools/torch_decode_times.py
// --legacy-mesh, with NC_SPLIT defined) stamp clock64() around a cluster
// step's wait, slot loop and push in thread 0 of every block and add the
// cycles to k6cm_split (nc_fwbw_generic_wave_split reads and clears it).
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_generic_wave_plain (and fwbw_plain) in nanocall_tpu_torch/ops/
// hmm.py on the card.

#include "device_guard.cuh"
#include "resident_slots.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// the most reads a block takes (ops/hmm.py FWBW_WAVE_MAX_READS)
constexpr int MAX_READS = 8;

// The ranks of a K6cm launch (as K6am's GenericWaveRank): one entry a rank
// of the data row (the M entries, then the ranks this launch runs, as
// int64), in device memory of the launch's card; every pointer on the
// rank's own card.
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
  float* col;      // (2, B, W): its slice of exchange k at k & 1
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
// k * stride on), in common.cuh lse_slots' order: the max
// (NaN-propagating), then the slot-ordered sum of exp(v - safe)
__device__ __forceinline__ float lse_streaming(const int32_t* idx,
                                               const float* lp, int deg,
                                               int stride, const float* x) {
  float m = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const float v = __ldg(lp + (size_t)k * stride) +
                    x[__ldg(idx + (size_t)k * stride)];
    m = k == 0 ? v : amax(m, v);
  }
  const float safe = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const float e = expf((__ldg(lp + (size_t)k * stride) +
                          x[__ldg(idx + (size_t)k * stride)]) -
                         safe);
    s = k == 0 ? e : s + e;
  }
  return isfinite(m) ? safe + logf(s) : m;
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

// The bytes of a side's cut: its codebooks and its (deg, W) entries.
__host__ __device__ __forceinline__ uint32_t cut_bytes(int deg, int W) {
  return (uint32_t)(deg * (GROUPS * CODES * 4 + W * 2));
}

// The floats of the column buffers of R reads (CLUSTER: both parities),
// read r's column_stride(R) r on: N floats and 32 / R more, so that the R
// lanes of a warp that gather one index of their R reads' columns (and the
// 32 / R consecutive indices of a read's lanes) fall in distinct banks;
// then (CLUSTER and RESIDENT) the vote words of both parities: 32 R a
// parity (the M ranks' R W / 128 warps), then the threads' em buffers.
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

// the em buffers of the block's threads: 4 floats a thread and parity
__host__ __device__ __forceinline__ int em_floats(int threads) {
  return 2 * 4 * threads;
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

// K6cm: both passes of R = 1 << lg_reads reads for one rank, which holds
// the states [rank W, (rank + 1) W), W = 1 << slice_shift, on R W / 4
// threads.  Read group g holds the reads wave_lo + g R .. (those below
// wave_hi).  The exchange: CLUSTER, a group's M ranks one cluster of a
// grid (M, groups), block (r, g) the rank r of group g; else a cooperative
// grid (groups, ranks this launch runs), block (g, j) group g for the rank
// named by entry j of the launch's ranks (after the M = N >> slice_shift
// entries of `wave`).  Dynamic shared memory: the columns (column_floats),
// the vote words (vote_words), the em buffers (em_floats), then RESIDENT
// the codebooks (deg x GROUPS x
// CODES float32) and the rank's cut (deg x W uint16), deg the larger
// side's.  DEG > 0: both sides have DEG slots.
template <bool SYS, bool RESIDENT, bool CLUSTER, int DEG, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_generic_wave_kernel(const FwbwWaveRank* __restrict__ wave, int B,
                         int T, int wave_lo, int wave_hi, int slice_shift,
                         int lg_reads, int deg_from, int deg_to,
                         float log2pi, float log_n, long long timeout_ns,
                         int32_t* timed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Exchange x;
  __shared__ __align__(8) uint64_t bar;
  // CLUSTER: exchange k's completion in buffer k & 1
  __shared__ __align__(8) uint64_t xbar[2];
  // the warps' partials of each read (and of each of a thread's 4 states)
  __shared__ float sWarp[MAX_READS * 4][WARPS];
  // CLUSTER: each read's partial max and sum of the final alpha
  __shared__ float sPub[2][MAX_READS];
  __shared__ float sM[MAX_READS];
  const int deg_max = deg_from > deg_to ? deg_from : deg_to;
  const int ranks = N >> slice_shift;
  const int R = 1 << lg_reads;
  const int W = 1 << slice_shift;
  const int tid = threadIdx.x;
  const int nthreads = (W >> 2) << lg_reads;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int r = tid & (R - 1), u = tid >> lg_reads;
  const int Q = W >> 2, CS = column_stride(R);
  float* const column = reinterpret_cast<float*>(smem);
  float* const votes = column + column_floats(R, CLUSTER);
  float* const emb = votes + vote_words(R, CLUSTER, RESIDENT);
  float* const book = emb + em_floats(nthreads);
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
  // CLUSTER: an exchange's bytes into each block; the last exchange
  const uint32_t xbytes = (uint32_t)(nr * N * 4) +
                          (RESIDENT ? 32u * 4u * (uint32_t)R : 0u);
  const int last_k = 2 * T - 3;
  if constexpr (CLUSTER) {
    if (tid == 0) {
      mbar_init(smem_addr(&xbar[0]), 1);
      mbar_init(smem_addr(&xbar[1]), 1);
      fence_mbarrier_init();
      if (T > 1) {
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
  // the thread's first state of row t of a (B, T, W) output
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * W + u;
  };
  auto store = [&](float* p, const float (&v)[4]) {
    if (real) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i * Q] = v[i];
    }
  };
  // the stored em of row t, read back by this thread a step ahead into
  // its em buffer t & 1 by cp.async (from L2: this launch wrote it), so
  // that no register holds it through the slot loop
  auto fetch_em = [&](int t) {
    if (real) {
      const uint32_t dst = smem_addr(emb + ((t & 1) * nthreads + tid) * 4);
      const float* src = at(e.em, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async4(dst + 4 * i, src + i * Q);
    }
  };
  // em of row t, fetched before (0 in a lane past the row's end)
  auto take_em = [&](int t, float (&v)[4]) {
    if (real) {
      cp_async_wait_all();
      unpack4(v, *reinterpret_cast<const float4*>(
                     emb + ((t & 1) * nthreads + tid) * 4));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = 0.0f;
    }
  };

  // every em(t) of the thread's states, stored; alpha(0)
  float a[4];
  {
    const size_t row = (size_t)b * W + u;
    float m[6][4];
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[q][i] = __ldg(e.model[q] + row + i * Q);
    const float* evm = e.ev_mean + (size_t)b * T;
    const float* evs = e.ev_stdv + (size_t)b * T;
    const float* evl = e.ev_log_stdv + (size_t)b * T;
    for (int t = 0; t < (real ? T : 1); ++t) {
      const float xe = evm[t], ye = evs[t], le = evl[t];
      float em[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        em[i] = emission(xe, ye, le, m[0][i], m[1][i], m[2][i], m[3][i],
                         m[4][i], m[5][i], log2pi);
      store(at(e.em, t), em);
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = em[i] - log_n;
      }
    }
  }

  // CLUSTER: the thread's 4 values of exchange k into every block's
  // column buffer k & 1 of its read, and (RESIDENT) the warp's vote word
  // (lane p pushing it into block p)
  auto push = [&](int k, const float (&v)[4]) {
    const int q = k & 1;
    const uint32_t mb = smem_addr(&xbar[q]);
    if (real) {
      const uint32_t dst = smem_addr(column + (q * R + r) * CS + j);
      for (int p = 0; p < ranks; ++p) {
        const uint32_t d = cluster_map(dst, p), m = cluster_map(mb, p);
#pragma unroll
        for (int i = 0; i < 4; ++i) st_async(d + 4 * i * Q, v[i], m);
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
    if (tid == 0 && k + 2 <= last_k) mbar_rearm(mb, xbytes);
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
  auto store_own = [&](int k, const float (&v)[4]) {
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
  // the slot log-sum-exp of the thread's 4 states from the column `cur`
  // over one side (RESIDENT: the cut in shared memory, nan its vote; else
  // the (deg, W) cut `idx` / `lp` from L2)
  auto lse4 = [&](bool nan, const float* cur, int deg, const void* idx,
                  const float* lp, float (&out)[4]) {
    if constexpr (RESIDENT) {
      if (nan)
        lse4_cut<true, DEG>(table + u, book, rank << slice_shift, Q, cur,
                            deg, W, out);
      else
        lse4_cut<false, DEG>(table + u, book, rank << slice_shift, Q, cur,
                             deg, W, out);
    } else {
      const int32_t* id = static_cast<const int32_t*>(idx) + u;
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        const float v =
            lse_streaming(id + i * Q, lp + u + i * Q, deg, W, cur);
        out[0] = out[1];
        out[1] = out[2];
        out[2] = out[3];
        out[3] = v;
      }
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
      float res[4];
      lse4(prone, cur, deg_from, e.from_table, e.from_values, res);
      float em[4];
      take_em(t, em);
      if (t + 1 < len) fetch_em(t + 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = em[i] + res[i];
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
    const bool nan = a[0] != a[0] || a[1] != a[1] || a[2] != a[2] ||
                     a[3] != a[3];
    const unsigned nan_lanes = __ballot_sync(FULL, nan);
    float mx = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
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
    // 1) Q), over its read's lanes, then the warps; then the 4 subtrees
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ws = expf(a[i] - mfin);
      for (int off = R; off < 32; off <<= 1)
        ws = ws + __shfl_down_sync(FULL, ws, off);
      if (lane < R) sWarp[4 * lane + i][warp] = ws;
    }
    __syncthreads();
    for (int rr = warp; rr < R; rr += nwarps) {
      float sub[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sub[i] = lane_tree_sum(lane < nwarps ? sWarp[4 * rr + i][lane] : 0.0f,
                               31 - __clz(nwarps));
      const float s = (sub[0] + sub[1]) + (sub[2] + sub[3]);
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
    if (warp == 0) {
      // each read's M partial sums pairwise in rank order (at 64 ranks a
      // lane adds ranks 2l and 2l + 1 first)
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
  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  store(at(e.beta, T - 1), beta);
  // g of event t + 1 counts only where t < len - 1: em(t + 1) is fetched
  // for t + 1 < len, else g is beta's 0
  if (T - 1 < len) fetch_em(T - 1);
  for (int t = T - 2; t >= 0; --t) {
    const int k = 2 * T - 3 - t;
    float g[4];
    if (t + 1 < len) take_em(t + 1, g);
    if (t < len) fetch_em(t);
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = t + 1 < len ? g[i] + beta[i] : 0.0f;
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
      for (int i = 0; i < 4; ++i) beta[i] = 0.0f;
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

using FwbwWaveKernel =
    decltype(&fwbw_generic_wave_kernel<false, true, false, 0, false>);

#ifdef NC_SPLIT
constexpr bool kSplit = true;
#else
constexpr bool kSplit = false;
#endif

// the exchange's instances of a form: a cluster a read group (one card;
// the SPLIT build's stamped instances), else the cooperative grid at gpu
// or system scope
template <bool RESIDENT, int DEG>
FwbwWaveKernel wave_instance(int sys, int cluster) {
  if (cluster) return fwbw_generic_wave_kernel<false, RESIDENT, true, DEG,
                                               kSplit>;
  return sys ? fwbw_generic_wave_kernel<true, RESIDENT, false, DEG, false>
             : fwbw_generic_wave_kernel<false, RESIDENT, false, DEG, false>;
}

// K6cm's instance: the resident cut (21 slots a side: the slot loops
// without bounds tests, as K6c's) or the streaming one, and its exchange
FwbwWaveKernel fwbw_wave_kernel(int resident, int deg_from, int deg_to,
                                int sys, int cluster) {
  if (!resident) return wave_instance<false, 0>(sys, cluster);
  return deg_from == 21 && deg_to == 21 ? wave_instance<true, 21>(sys, cluster)
                                        : wave_instance<true, 0>(sys, cluster);
}

// K6cm's dynamic shared memory (ops/hmm.py fwbw_wave_smem): the columns
// and vote words of R reads, and resident the codebooks and the rank's cut
// of the larger side
int fwbw_wave_smem(int resident, int deg, int slice_shift, int lg_reads,
                   int cluster) {
  const int R = 1 << lg_reads;
  return (column_floats(R, cluster) + vote_words(R, cluster, resident) +
          em_floats(R << (slice_shift - 2))) * 4 +
         (resident ? (int)cut_bytes(deg, 1 << slice_shift) : 0);
}

// the launch of the shape ops/hmm.py fwbw_wave_grid gives: a grid (x, y)
// of blocks of `block` threads, cooperative, or (cluster) of clusters of x
// blocks
void fwbw_wave_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int grid_x, int grid_y, int block, int smem,
                      int cluster) {
  cfg = {};
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.gridDim = dim3(grid_x, grid_y);
  if (cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid_x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

bool bad_degs(int resident, int deg_from, int deg_to) {
  const int most = resident ? MAX_DEG : 256;
  return deg_from < 1 || deg_from > most || deg_to < 1 || deg_to > most;
}

// reads a block: a power of two up to MAX_READS and N / W, a block of 32
// to 1024 threads
bool bad_reads(int slice_shift, int lg_reads) {
  const int threads_shift = slice_shift - 2 + lg_reads;
  return lg_reads < 0 || (1 << lg_reads) > MAX_READS ||
         lg_reads > 12 - slice_shift || threads_shift < 5 ||
         threads_shift > 10;
}

// a launch shape other than the kernel's layout takes: blocks of R W / 4
// threads; (cluster) a grid (M, read groups), else (read groups, n_local)
bool bad_grid(int n_reads, int n_local, int slice_shift, int lg_reads,
              int grid_x, int grid_y, int block, int cluster) {
  const int groups = (n_reads + (1 << lg_reads) - 1) >> lg_reads;
  return block != 1 << (slice_shift - 2 + lg_reads) ||
         grid_x != (cluster ? N >> slice_shift : groups) ||
         grid_y != (cluster ? groups : n_local);
}

}  // namespace

// K6cm's wave: the most blocks of its instance (sys, resident, at deg
// slots, the larger side's, slices of 1 << slice_shift states and 1 <<
// lg_reads reads a block) that one card holds at once (blocks an SM at its
// threads and shared memory, times the SMs) into *blocks; (cluster) the
// blocks of the clusters of M ranks it holds at once.  (grid_x, grid_y)
// and block: fwbw_wave_grid's shape of a launch of one read group.  An
// error where the card has no cooperative launch (or, cluster, where the
// clusters do not fit).
extern "C" int nc_fwbw_generic_wave_resident(int sys, int resident, int deg,
                                             int slice_shift, int lg_reads,
                                             int grid_x, int grid_y,
                                             int block, int cluster,
                                             int device, int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  const int ranks = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || bad_degs(resident, deg, deg) ||
      bad_reads(slice_shift, lg_reads) ||
      bad_grid(1 << lg_reads, ranks, slice_shift, lg_reads, grid_x, grid_y,
               block, cluster) ||
      (cluster && (sys || ranks > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwbwWaveKernel kernel =
      fwbw_wave_kernel(resident, deg, deg, sys, cluster);
  const int smem =
      fwbw_wave_smem(resident, deg, slice_shift, lg_reads, cluster);
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop && !cluster) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    fwbw_wave_config(cfg, attr, grid_x, grid_y, block, smem, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * ranks;
    return (int)err;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block, smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K6cm: both passes of the reads [lo, lo + n_reads) for n_local ranks of a
// data row on `stream`, 1 << lg_reads reads a block of R W / 4 threads:
// one cooperative grid (read groups, n_local), or (cluster: every rank of
// the row, on this card, M <= MAX_CLUSTER) a grid of the groups' clusters;
// (grid_x, grid_y) and block as ops/hmm.py fwbw_wave_grid gives them (any
// other shape is refused).
// `ranks` (device memory of this card) holds the row's M = 4096 >>
// slice_shift FwbwWaveRank entries, then the n_local ranks to run as
// int64; the entries' cuts, (B, W) models, (B, T, W) outputs, (2, B, W)
// columns, (2, B) partials and (B,) counters (zero before the launch; the
// cluster path reads none) lie on their ranks' cards, reachable from this
// one (peer access).  resident: the cuts are each side's packed entries
// and codebooks (16-byte aligned), 1 to MAX_DEG slots a side; else the
// int32 / float32 cuts of 1 to 256.  sys: the exchange at system scope.
// timed_out: as K1m's.  Returns the launch's error: a cooperative grid
// larger than the card holds at once is refused
// (cudaErrorCooperativeLaunchTooLarge), and so is shared memory beyond a
// block's.
extern "C" int nc_fwbw_generic_wave(
    const void* ranks, int n_local, int B, int T, int lo, int n_reads,
    int slice_shift, int lg_reads, int grid_x, int grid_y, int block,
    int deg_from, int deg_to, int sys, int resident, int cluster,
    float log2pi, float log_n,
    long long timeout_ns, int32_t* timed_out, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int M = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 || n_local > M ||
      timed_out == nullptr || bad_degs(resident, deg_from, deg_to) ||
      bad_reads(slice_shift, lg_reads) ||
      bad_grid(n_reads, n_local, slice_shift, lg_reads, grid_x, grid_y,
               block, cluster) ||
      (cluster && (sys || n_local != M || M > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwbwWaveKernel kernel =
      fwbw_wave_kernel(resident, deg_from, deg_to, sys, cluster);
  const int smem = fwbw_wave_smem(
      resident, deg_from > deg_to ? deg_from : deg_to, slice_shift,
      lg_reads, cluster);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fwbw_wave_config(cfg, attr, grid_x, grid_y, block, smem, cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const FwbwWaveRank*>(ranks), B, T, lo,
                           lo + n_reads, slice_shift, lg_reads, deg_from,
                           deg_to, log2pi, log_n, timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

#ifdef NC_SPLIT
// The SPLIT build's cycles since the last call (wait, slot loop, push,
// steps stamped, summed over the blocks' thread 0) into out[4], cleared.
extern "C" int nc_fwbw_generic_wave_split(int device,
                                          unsigned long long* out) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaMemcpyFromSymbol(out, k6cm_split, sizeof(k6cm_split));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(k6cm_split, zero, sizeof(zero));
  return (int)err;
}
#endif
