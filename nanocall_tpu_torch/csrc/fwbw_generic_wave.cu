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
// Design (for the H100).  A block is one (read, rank) pair and runs both
// passes on W / 2 threads, thread tid stepping the states 2 tid, 2 tid + 1
// of the rank's slice [rank W, (rank + 1) W), as K6am does (1024 threads
// at M = 2, 512 at 4).  A loaded table's from- and to-states lie anywhere,
// so each step, in both directions, the block needs the whole column of
// the gathered vector (alpha forward, g backward) in its shared memory.
// It comes by one of K6am's two exchanges (wave_exchange.cuh).  On one
// card with M <= 8 (CLUSTER) a read's M blocks are one thread block
// cluster: each thread pushes its 2 values into every block's double-
// buffered column (st.shared::cluster), one cluster barrier a step,
// arrived at after the push and waited on before the column is read; one
// launch takes a row's reads.  Else (across cards, or 16 to 64 ranks) a
// cooperative grid a wave: the rank's slice of the vector in its (2, B, W)
// buffer in global memory behind a counter a step, the whole column loaded
// from the ranks' buffers.  The exchanges are numbered k = 0, 1, .. (the
// forward's columns 0 .. T - 2, then the backward's g of events T - 1 ..
// 1), exchange k in buffer k & 1 (the cooperative counter: k + 1 forward,
// k + 3 backward).
//   - The table: RESIDENT, the rank's (deg, W) cut of K6c's packed layout
//     (hmm.pack_fwbw_sides: 16-bit entries, 4 codebooks of 16 a slot, one
//     per block of 1024 states) in shared memory, one side at a time (the
//     from side by cp.async.bulk in the prologue, the to side refilled
//     after the forward, under log_pr_data's reduction): 21 x W x 2 B,
//     84 KiB at W = 2048, beside the 32 KiB column; the slot arithmetic is
//     resident_slots.cuh's (lse_resident at the cut's stride).  A thread's
//     2 states lie in one block of 1024: its codebook reads fall in one
//     block's 16 words.  Else (streaming) the (deg, W) int32 / float32
//     cut read from L2 twice a step (the max, then the sum), as K6c's
//     streaming kernel reads the whole table.
//   - The NaN vote that lets the resident form take fmaxf is global: on
//     the cluster path a warp holding a NaN or +inf marks the exchange in
//     every block with its push (prone_at), on the cooperative path a block
//     vote runs over the loaded column; with the codebooks' own vote.
//   - A step past a read's end (t >= length forward, t >= length-1
//     backward) skips the slot loop on every rank alike (one read's ranks
//     share its length), but still takes part in the exchange.
//   - The emissions of every event are computed once in the prologue and
//     stored (the em output); the passes read them back one step ahead.
//   - log Pr[data]: each rank's NaN-voted partial max of its final alpha,
//     the max over the ranks' partials, then each rank's pairwise tree sum
//     of exp(alpha - max) over its states (its slice is a whole subtree of
//     ops/hmm.py tree_sum's), the M partial sums combined pairwise in rank
//     order by every rank (hmm.combine_rank_sums): two more exchanges.
// So every rank computes K6c's bits for its states, NaN bits included.
// What bounds it: K6c's slot loop over the SM's states (issue), plus the
// exchange's latency twice a step; in the streaming form the cut's bytes
// from L2.
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
  int32_t* flags;  // (B,): the counter
};

// the pairwise-tree sum of the first 1 << levels lanes, in lane 0
__device__ __forceinline__ float lane_tree_sum(float v, int levels) {
  for (int off = 1; off < (1 << levels); off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
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

// The bytes of a side's cut: its codebooks and its (deg, W) entries.
__host__ __device__ __forceinline__ uint32_t cut_bytes(int deg, int W) {
  return (uint32_t)(deg * (GROUPS * CODES * 4 + W * 2));
}

// K6cm: both passes of one read for one rank, which holds the states
// [rank W, (rank + 1) W), W = 1 << slice_shift, on W / 2 threads.  The
// exchange: CLUSTER, the read's M ranks one cluster of a grid (M, reads),
// block (r, i) the rank r of read wave_lo + i; else a cooperative grid
// (reads, ranks this launch runs), block (i, j) the read wave_lo + i for
// the rank named by entry j of the launch's ranks (after the M = N >>
// slice_shift entries of `wave`).  Dynamic shared memory: the column
// (CLUSTER: 2 x N float32, double-buffered; else N), then RESIDENT the
// codebooks (deg x GROUPS x CODES float32) and the rank's cut (deg x W
// uint16), deg the larger side's.  DEG > 0: both sides have DEG slots.
template <bool SYS, bool RESIDENT, bool CLUSTER, int DEG>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_generic_wave_kernel(const FwbwWaveRank* __restrict__ wave, int B,
                         int T, int wave_lo, int slice_shift, int deg_from,
                         int deg_to, float log2pi, float log_n,
                         long long timeout_ns, int32_t* timed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Exchange x;
  __shared__ __align__(8) uint64_t bar;
  // CLUSTER: k + 1 once a value of exchange k (buffer k & 1) is NaN or +inf
  __shared__ int prone_at[2];
  __shared__ float sWarp[WARPS];
  // CLUSTER: the rank's partial max and sum of the final alpha
  __shared__ float sPub[2];
  __shared__ float sM;
  const int deg_max = deg_from > deg_to ? deg_from : deg_to;
  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, H = W >> 1;
  float* const column = reinterpret_cast<float*>(smem);
  float* const book = column + (CLUSTER ? 2 : 1) * N;
  uint16_t* const table =
      reinterpret_cast<uint16_t*>(book + deg_max * GROUPS * CODES);
  const int rank =
      CLUSTER ? (int)blockIdx.x
              : (int)reinterpret_cast<const long long*>(wave + ranks)
                    [blockIdx.y];
  const int b = wave_lo + (int)(CLUSTER ? blockIdx.y : blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = H >> 5;  // the block's warps (W >= 64)
  const FwbwWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
  // the thread's first state in the column, and its codebooks (block j >>
  // 10 of slot 0)
  const int j = (rank << slice_shift) + 2 * tid;
  const float* const bk = book + (j >> 10) * CODES;
  const size_t colstride = (size_t)B * W;
  if constexpr (CLUSTER) {
    if (tid < 2) prone_at[tid] = 0;
  } else {
    for (int p = tid; p < ranks; p += H) {
      x.col[p] = wave[p].col + (size_t)b * W;
      x.flag[p] = wave[p].flags + b;
    }
    if (tid == 0) {
      x.timed_out = timed_out;
      x.timeout_ns = timeout_ns;
      x.ranks = ranks;
      x.rank = rank;
      x.read = b;
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

  const int len = e.length[b];
  // the thread's 2 states of row t of a (B, T, W) output
  auto at = [&](float* base, int t) {
    return base + ((size_t)b * T + t) * W + 2 * tid;
  };
  auto store2 = [&](float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  };
  // the stored em of row t, read back by this thread (L2: this launch
  // wrote it)
  auto load_em = [&](int t, float (&v)[2]) {
    const float2 w = __ldcg(reinterpret_cast<const float2*>(at(e.em, t)));
    v[0] = w.x;
    v[1] = w.y;
  };

  // every em(t) of the thread's states, stored; alpha(0)
  float a[2];
  {
    const size_t row = (size_t)b * W + 2 * tid;
    float m[6][2];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(e.model[q] +
                                                             row));
      m[q][0] = v.x;
      m[q][1] = v.y;
    }
    const float* evm = e.ev_mean + (size_t)b * T;
    const float* evs = e.ev_stdv + (size_t)b * T;
    const float* evl = e.ev_log_stdv + (size_t)b * T;
    for (int t = 0; t < T; ++t) {
      const float xe = evm[t], ye = evs[t], le = evl[t];
      float em[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        em[i] = emission(xe, ye, le, m[0][i], m[1][i], m[2][i], m[3][i],
                         m[4][i], m[5][i], log2pi);
      store2(at(e.em, t), em[0], em[1]);
      if (t == 0) {
        a[0] = em[0] - log_n;
        a[1] = em[1] - log_n;
      }
    }
  }

  // CLUSTER: the thread's 2 values of exchange k into every block's column
  // buffer k & 1, and (RESIDENT) the exchange marked prone where a value
  // of the warp is NaN or +inf (lane p marking it in block p)
  auto push = [&](int k, float v0, float v1) {
    const uint32_t dst = smem_addr(column + (k & 1) * N + j);
    for (int p = 0; p < ranks; ++p)
      st_cluster2(cluster_map(dst, p), v0, v1);
    if (RESIDENT && __any_sync(FULL, nan_prone(v0) || nan_prone(v1)) &&
        lane < ranks)
      st_cluster(cluster_map(smem_addr(&prone_at[k & 1]), lane), k + 1);
  };
  // cooperative: the thread's 2 values of exchange k into the rank's
  // buffer k & 1
  auto store_own = [&](int k, float v0, float v1) {
    store2(e.col + (size_t)(k & 1) * colstride + (size_t)b * W + 2 * tid,
           v0, v1);
  };
  // cooperative: publish the rank's slice of exchange k (every thread's
  // stored) behind counter value c, wait for the peers', load the whole
  // column into shared memory; RESIDENT: whether a value of it is NaN or
  // +inf (the vote covers every rank's slice)
  auto exchange = [&](int k, int c) -> bool {
    __syncthreads();
    if (tid == 0) st_flag<SYS>(x.flag[x.rank], c);
    if (warp == 0) {
      __syncwarp();
      wait_ranks<SYS>(x, x.flag, c, lane);
    }
    __syncthreads();
    const size_t src = (size_t)(k & 1) * colstride;
    bool p = false;
    for (int i = 4 * tid; i < N; i += 4 * H) {
      const float4 v =
          ld_column4<SYS>(x.col[i >> slice_shift] + src + (i & (W - 1)));
      *reinterpret_cast<float4*>(column + i) = v;
      p = p || nan_prone(v.x) || nan_prone(v.y) || nan_prone(v.z) ||
          nan_prone(v.w);
    }
    if (RESIDENT) return __syncthreads_or(p) != 0;
    __syncthreads();
    return false;
  };
  // the slot log-sum-exp of the thread's 2 states from the column `cur`
  // over one side (RESIDENT: the cut in shared memory, nan its vote; else
  // the (deg, W) cut `idx` / `lp` from L2)
  auto lse2 = [&](bool nan, const float* cur, int deg, const void* idx,
                  const float* lp, float (&r)[2]) {
    if constexpr (RESIDENT) {
      const uint16_t* ent = table + 2 * tid;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r[i] = nan ? lse_resident<true, DEG>(ent + i, bk, cur, deg, W)
                   : lse_resident<false, DEG>(ent + i, bk, cur, deg, W);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r[i] = lse_streaming(static_cast<const int32_t*>(idx) + 2 * tid + i,
                             lp + 2 * tid + i, deg, W, cur);
    }
  };
  // whether a side's codebooks in shared memory hold NaN or +inf
  auto book_vote = [&](int deg) {
    bool p = false;
    for (int i = tid; i < deg * GROUPS * CODES; i += H)
      p = p || nan_prone(book[i]);
    return __syncthreads_or(p) != 0;
  };

  // forward: exchange k = t - 1 brings column t - 1
  store2(at(e.alpha, 0), a[0], a[1]);
  if (!CLUSTER && T > 1) store_own(0, a[0], a[1]);
  if constexpr (CLUSTER) {
    // every block of the cluster runs, its prone_at zeroed; also orders the
    // mbarrier's init before every wait
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
  if (CLUSTER && T > 1) {
    push(0, a[0], a[1]);
    cluster_arrive();
  }
  float emn[2] = {0.0f, 0.0f};
  if (T > 1) load_em(1, emn);
  for (int t = 1; t < T; ++t) {
    const int k = t - 1;
    const float em0 = emn[0], em1 = emn[1];
    if (t + 1 < T) load_em(t + 1, emn);
    const float* cur = column;
    bool prone = false;
    if constexpr (CLUSTER) {
      cluster_wait();  // every block's push of column t - 1 is in
      cur = column + (k & 1) * N;
      prone = RESIDENT && (side_prone || prone_at[k & 1] == k + 1);
    } else {
      prone = exchange(k, k + 1) || side_prone;
    }
    if (t < len) {
      float r[2];
      lse2(prone, cur, deg_from, e.from_table, e.from_values, r);
      a[0] = em0 + r[0];
      a[1] = em1 + r[1];
    }
    store2(at(e.alpha, t), a[0], a[1]);
    if (t < T - 1) {
      if constexpr (CLUSTER) {
        push(t, a[0], a[1]);
        cluster_arrive();
      } else {
        store_own(t, a[0], a[1]);
      }
    }
  }

  // the to side into the same region (every read of the from side ended at
  // the barrier), while the ranks reduce log_pr_data: the partial maxima,
  // their max, then the partial tree sums of exp(final - max)
  __syncthreads();
  if (RESIDENT && tid == 0) {
    fence_proxy_async();
    mbar_expect(bar_addr, cut_bytes(deg_to, W));
    copy_cut(deg_to, e.to_table, e.to_values);
  }
  {
    const float mx = warp_max_nan(fmaxf(a[0], a[1]),
                                  a[0] != a[0] || a[1] != a[1]);
    if (lane == 0) sWarp[warp] = mx;
    __syncthreads();
    if (warp == 0) {
      const float vm = lane < nw ? sWarp[lane] : -INFINITY;
      const float pm = warp_max_nan(vm, vm != vm);
      if (lane == 0) {
        if (CLUSTER)
          sPub[0] = pm;
        else
          e.part[b] = pm;
      }
    }
    if constexpr (CLUSTER) {
      cluster_arrive();
      cluster_wait();
      if (warp == 0) {
        float out[1];
        cluster_max<1>(smem_addr(&sPub[0]), ranks, lane, out);
        if (lane == 0) sM = out[0];
      }
    } else {
      __syncthreads();
      if (tid == 0) st_flag<SYS>(x.flag[x.rank], T);
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, x.flag, T, lane);
        float v = -INFINITY;
        bool nan = false;
        for (int p = lane; p < ranks; p += 32) {
          const float w = ld_column<SYS>(wave[p].part + b);
          v = fmaxf(v, w);
          nan = nan || w != w;
        }
        const float mm = warp_max_nan(v, nan);
        if (lane == 0) sM = mm;
      }
    }
    __syncthreads();
    const float mfin = sM;
    const float ws = warp_tree_sum(expf(a[0] - mfin) + expf(a[1] - mfin));
    if (lane == 0) sWarp[warp] = ws;
    __syncthreads();
    if (warp == 0) {
      const float s =
          lane_tree_sum(lane < nw ? sWarp[lane] : 0.0f, 31 - __clz(nw));
      if (lane == 0) {
        if (CLUSTER)
          sPub[1] = s;
        else
          e.part[B + b] = s;
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
      // the M partial sums pairwise in rank order (at 64 ranks a lane
      // adds ranks 2l and 2l + 1 first)
      const int per_lane = ranks > 32 ? 2 : 1;
      const int lanes = ranks / per_lane;
      float v = 0.0f;
      if (lane < lanes) {
        if constexpr (CLUSTER) {
          v = ld_cluster(cluster_map(smem_addr(&sPub[1]), lane));
        } else {
          v = ld_column<SYS>(wave[per_lane * lane].part + B + b);
          if (per_lane == 2)
            v = v + ld_column<SYS>(wave[2 * lane + 1].part + B + b);
        }
      }
      const float s = lane_tree_sum(v, 31 - __clz(lanes));
      if (lane == 0) e.lpd[b] = mfin + logf(s);
    }
  }

  // backward: exchange k = 2 T - 3 - t brings g of event t + 1
  if (RESIDENT) {
    mbar_wait(bar_addr, 1);
    side_prone = book_vote(deg_to);
  }
  float beta[2] = {0.0f, 0.0f};
  store2(at(e.beta, T - 1), 0.0f, 0.0f);
  if (T > 1) load_em(T - 1, emn);
  for (int t = T - 2; t >= 0; --t) {
    const int k = 2 * T - 3 - t;
    const float g0 = emn[0] + beta[0], g1 = emn[1] + beta[1];
    if (t > 0) load_em(t, emn);
    const float* cur = column;
    bool prone = false;
    if constexpr (CLUSTER) {
      push(k, g0, g1);
      cluster_arrive();
      cluster_wait();
      cur = column + (k & 1) * N;
      prone = RESIDENT && (side_prone || prone_at[k & 1] == k + 1);
    } else {
      store_own(k, g0, g1);
      prone = exchange(k, k + 3) || side_prone;
    }
    if (t >= len - 1) {
      beta[0] = 0.0f;
      beta[1] = 0.0f;
    } else {
      lse2(prone, cur, deg_to, e.to_table, e.to_values, beta);
    }
    store2(at(e.beta, t), beta[0], beta[1]);
  }
  if constexpr (CLUSTER) {
    // no block leaves while a peer may still read its shared memory
    cluster_arrive();
    cluster_wait();
  }
}

using FwbwWaveKernel =
    decltype(&fwbw_generic_wave_kernel<false, true, false, 0>);

// the exchange's instances of a form: a cluster a read (one card), else the
// cooperative grid at gpu or system scope
template <bool RESIDENT, int DEG>
FwbwWaveKernel wave_instance(int sys, int cluster) {
  if (cluster) return fwbw_generic_wave_kernel<false, RESIDENT, true, DEG>;
  return sys ? fwbw_generic_wave_kernel<true, RESIDENT, false, DEG>
             : fwbw_generic_wave_kernel<false, RESIDENT, false, DEG>;
}

// K6cm's instance: the resident cut (21 slots a side: the slot loops
// without bounds tests, as K6c's) or the streaming one, and its exchange
FwbwWaveKernel fwbw_wave_kernel(int resident, int deg_from, int deg_to,
                                int sys, int cluster) {
  if (!resident) return wave_instance<false, 0>(sys, cluster);
  return deg_from == 21 && deg_to == 21 ? wave_instance<true, 21>(sys, cluster)
                                        : wave_instance<true, 0>(sys, cluster);
}

// K6cm's dynamic shared memory: the column (cluster: both parities), and
// resident the codebooks and the rank's cut of the larger side
int fwbw_wave_smem(int resident, int deg, int slice_shift, int cluster) {
  return (cluster ? 2 : 1) * N * 4 +
         (resident ? (int)cut_bytes(deg, 1 << slice_shift) : 0);
}

// the launch's shape: a cooperative grid (reads, ranks), or (cluster) a
// grid (ranks, reads) of clusters of the read's M ranks
void fwbw_wave_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int n_reads, int n_local, int slice_shift, int smem,
                      int cluster) {
  cfg = {};
  cfg.blockDim = dim3(1 << (slice_shift - 1));
  cfg.dynamicSmemBytes = smem;
  if (cluster) {
    cfg.gridDim = dim3(n_local, n_reads);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_local;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    cfg.gridDim = dim3(n_reads, n_local);
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

}  // namespace

// K6cm's wave: the most blocks of its instance (sys, resident, at deg
// slots, the larger side's, and slices of 1 << slice_shift states) that
// one card holds at once (blocks an SM at W / 2 threads and its shared
// memory, times the SMs) into *blocks; (cluster) the blocks of the
// clusters of M ranks it holds at once.  An error where the card has no
// cooperative launch (or, cluster, where the clusters do not fit).
extern "C" int nc_fwbw_generic_wave_resident(int sys, int resident, int deg,
                                             int slice_shift, int cluster,
                                             int device, int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  const int ranks = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || bad_degs(resident, deg, deg) ||
      (cluster && (sys || ranks > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwbwWaveKernel kernel =
      fwbw_wave_kernel(resident, deg, deg, sys, cluster);
  const int smem = fwbw_wave_smem(resident, deg, slice_shift, cluster);
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
    fwbw_wave_config(cfg, attr, 1, ranks, slice_shift, smem, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * ranks;
    return (int)err;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 1 << (slice_shift - 1), smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K6cm: both passes of the reads [lo, lo + n_reads) for n_local ranks of a
// data row on `stream`, blocks of W / 2 threads: one cooperative grid
// (n_reads, n_local), or (cluster: every rank of the row, on this card,
// M <= MAX_CLUSTER) a grid of the reads' clusters.  `ranks` (device memory
// of this card) holds the row's M = 4096 >> slice_shift FwbwWaveRank
// entries, then the n_local ranks to run as int64; the entries' cuts,
// (B, W) models, (B, T, W) outputs, (2, B, W) columns, (2, B) partials and
// (B,) counters (zero before the launch; the cluster path reads none) lie
// on their ranks' cards, reachable from this one (peer access).  resident:
// the cuts are each side's packed entries and codebooks (16-byte aligned),
// 1 to MAX_DEG slots a side; else the int32 / float32 cuts of 1 to 256.
// sys: the exchange at system scope.  timed_out: as K1m's.  Returns the
// launch's error: a cooperative grid larger than the card holds at once is
// refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_fwbw_generic_wave(
    const void* ranks, int n_local, int B, int T, int lo, int n_reads,
    int slice_shift, int deg_from, int deg_to, int sys, int resident,
    int cluster, float log2pi, float log_n, long long timeout_ns,
    int32_t* timed_out, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int M = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 || n_local > M ||
      timed_out == nullptr || bad_degs(resident, deg_from, deg_to) ||
      (cluster && (sys || n_local != M || M > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwbwWaveKernel kernel =
      fwbw_wave_kernel(resident, deg_from, deg_to, sys, cluster);
  const int smem = fwbw_wave_smem(
      resident, deg_from > deg_to ? deg_from : deg_to, slice_shift, cluster);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fwbw_wave_config(cfg, attr, n_reads, n_local, slice_shift, smem, cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const FwbwWaveRank*>(ranks), B, T, lo,
                           slice_shift, deg_from, deg_to, log2pi, log_n,
                           timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
