// K6dm: K6d (fwbw_backward.cu, the grouped backward with its betas stored)
// with the 4096 states split over M = 2 .. 64 ranks: the legacy EM round's
// rows off the CLI priors under nanocall_tpu/parallel/mesh.py:126
// shard_train_inputs (parallel/statepar.py drives it after K4m).
//
// Replaces the backward scan of nanocall_tpu/ops/hmm.py fwbw_grouped
// (:1016-1034) under that placement.  The recursion is K6d's (beta_step.cuh)
// on the rank's slice: per step, g = em(t+1) + beta of the rank's states,
// m the max of g over all 4096 states, G = exp(g - m), the sums of G over
// the blocks of 4 and 16 states, beta = m + log(total).  Bit-equality with
// K6d needs the global max before the exponentials, so a step has two
// exchanges: the ranks' partial maxima of g, then their block sums.
//
// Design (for the H100).  A block is one (read, rank) pair on W / 4
// threads (at least 32; wave_exchange.cuh slice_threads), 4 contiguous
// states a thread, K5m's layout: the rank's 6 model rows in shared memory
// by cp.async.bulk, the transition codebooks of the whole tables, the
// emission of the next step under the first exchange.  No statistics: the
// alphas, lpd, valid and rates are neither loaded nor kept.  A read's
// blocks share its length, so all of them skip the steps t >= length - 1
// (beta stored as +0.0, no exchange), as K6d does.  Exchange k of a step s
// (the steps numbered from the first computed one) lies in buffer s & 1.
//   - CLUSTER (one card, M <= 8): a read's M blocks are one thread block
//     cluster.  Warp 0 pushes the rank's partial max of g into every
//     block's ranks' maxima (lane p into block p), then each thread pushes
//     its sum4, and the quad's last thread its sum16, into every block's
//     sums of the 1024 blocks of 4 and 256 of 16 states, all by st.async
//     onto the receiver's mbarrier of the exchange and buffer (M floats,
//     then 1280 floats an exchange).  A block arms its own mbarriers and
//     waits on them alone, then reads every value of the step from its own
//     shared memory: no cluster barrier a step, no ld_cluster.  The double
//     buffers stay safe: a block pushes step s + 2's maximum only after its
//     block barrier of step s + 2, past every thread's reads of step s's
//     sums, and its step s + 2 sums only after every peer's maximum of
//     step s + 2, which each peer pushes after the same barrier of its
//     own; a thread 0 re-arms a buffer right after its own wait (a phase
//     two on cannot complete before every thread of its block has passed
//     that wait).  One cluster barrier before the first push (the
//     mbarriers' init) and one at the end.
//   - Else (across cards, or 16 to 64 ranks) a cooperative grid a wave:
//     each rank publishes its partial max into its (2, B, NMAX_WAVE)
//     maxima and its block sums into its (2, B, 9 W / 16) sums (K5m's
//     record layout, without the logs) behind its counter (two phases a
//     step), and each thread reads the 8 sums its states read from their
//     owners' records in place.
// The max is fmaxf with one vote for NaN (common.cuh warp_max_nan), as
// K6d's: torch.amax's value but for a zero's sign and a NaN's payload,
// neither of which shows through exp(g - m) or m + log(total).
//
// What bounds it: the two exchanges' latency a step, which the beta step
// of 4 states a thread leaves little work to hide; the betas' bytes are
// K6d's bound.
//
// The SPLIT instances (built only by tools/torch_decode_times.py
// --legacy-mesh, with NC_SPLIT defined) stamp clock64() around a cluster
// step's pushes and waits in thread 0 of every block and add the cycles to
// k6dm_split (nc_fwbw_backward_wave_split reads and clears it).
//
// Build with -fmad=false, as fwbw_backward.cu: the kernel is bit-identical
// to fwbw_backward_wave_plain in nanocall_tpu_torch/ops/em.py and to
// fwbw_grouped_backward_plain on the card.

#include "beta_step.cuh"
#include "device_guard.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// the cooperative path's published maxima a read and step (ops/em.py
// NMAX_WAVE: K5m's record, of which K6dm writes the first)
constexpr int NMAX_WAVE = 4;

// The ranks of a K6dm launch (as K5m's EMWaveRank): one entry a rank of
// the data row (the M entries, then the ranks this launch runs, as int64),
// in device memory of the launch's card; every pointer on the rank's own
// card.  The rank's pattern and flag bytes are null in a peer's entry.
struct BetaWaveRank {
  const float* ev_mean;  // (B, T) events and (B,) lengths, the row's
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  const float* e_codes;    // (B, 3, 32) the whole tables' codebooks
  const uint8_t* pattern;  // (W,) of the rank's states
  const uint8_t* sflags;   // (W,) of the rank's states
  const float* model[MODEL_ROWS];  // (B, W) of the rank's states
  float* betas;            // (B, T, W): the rank's slice
  float* maxima;           // (2, B, NMAX_WAVE): step s's at s & 1
  float* sums;             // (2, B, 9 W / 16): step s's at s & 1
  int32_t* flags;          // (B,) counter
};

// cycles of the SPLIT instances: the step's own work, push, wait, steps
// stamped
__device__ unsigned long long k6dm_split[4];

// K6dm: the reverse pass of one read for one rank, which holds the states
// [rank W, (rank + 1) W), W = 1 << slice_shift, on slice_threads(
// slice_shift) threads.  The exchange: CLUSTER, the read's M ranks one
// cluster of a grid (M, reads); else a cooperative grid (reads, ranks this
// launch runs), block (i, j) the read wave_lo + i for the rank named by
// entry j of the launch's ranks (after the M = N >> slice_shift entries of
// `wave`).  Dynamic shared memory: the rank's 6 model rows, W floats each,
// then (cooperative) the ranks' counters, maxima and sums at the read (M
// pointers each).
template <bool SYS, bool CLUSTER, bool SPLIT>
__global__ void __launch_bounds__(SLICE_MAX_THREADS, 2)
fwbw_backward_wave_kernel(const BetaWaveRank* __restrict__ wave, int B,
                          int T, int wave_lo, int slice_shift, float log2pi,
                          long long timeout_ns, int32_t* timed_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WaveSync x;
  __shared__ __align__(8) uint64_t bar;
  // CLUSTER: step s's exchanges in buffer s & 1: the maxima, the sums
  __shared__ __align__(8) uint64_t xmax[2];
  __shared__ __align__(8) uint64_t xsum[2];
  __shared__ float sBook[BWD_BOOKS][BWD_CODES];
  __shared__ float sMax[SLICE_MAX_WARPS];
  __shared__ float sM;
  // CLUSTER: the ranks' partial maxima, then sum4 of the 1024 blocks of 4
  // states and sum16 of the 256 of 16, of step s at s & 1
  __shared__ float sRanks[2][MAX_CLUSTER];
  __shared__ __align__(16) float sSums[2][N4 + N16];

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, U = W >> 2, S = 2 * U + (U >> 2);
  const int rank =
      CLUSTER ? (int)blockIdx.x
              : (int)reinterpret_cast<const long long*>(wave + ranks)
                    [blockIdx.y];
  const int b = wave_lo + (int)(CLUSTER ? blockIdx.y : blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const BetaWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
  // thread u holds the states lo + 4 u .. + 3 (own: u = tid)
  const int lo = rank << slice_shift;
  const bool own = tid < U;
  const int u = tid & (U - 1);
  const int nw = U >= 32 ? U >> 5 : 1;
  const size_t bs = (size_t)B * S;
  int32_t** pflag = reinterpret_cast<int32_t**>(smem + MODEL_ROWS * W);
  float** pmax = reinterpret_cast<float**>(pflag + ranks);
  float** psum = pmax + ranks;

  // the steps t >= len - 1 and row T - 1: beta = 0, no exchange
  const int len = e.length[b];
  const int t_zero = min(max(len - 1, 0), T - 1);
  float* out = e.betas + (size_t)b * T * W + 4 * u;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (own)
    for (int t = t_zero; t < T; ++t) store4(out + (size_t)t * W, zero);
  if (t_zero == 0) return;  // every block of the read returns here
  const int n_steps = t_zero;

  if (tid == 0) {
    const uint32_t row_bytes = W * 4;
    mbar_init_expect(bar_addr, MODEL_ROWS * row_bytes);
#pragma unroll
    for (int k = 0; k < MODEL_ROWS; ++k)
      bulk_copy(smem_addr(smem + k * W), e.model[k] + (size_t)b * W,
                row_bytes, bar_addr);
    if constexpr (CLUSTER) {
      for (int q = 0; q < 2; ++q) {
        mbar_init(smem_addr(&xmax[q]), 1);
        mbar_init(smem_addr(&xsum[q]), 1);
      }
      fence_mbarrier_init();
      for (int q = 0; q < 2 && q < n_steps; ++q) {
        mbar_expect(smem_addr(&xmax[q]), ranks * 4);
        mbar_expect(smem_addr(&xsum[q]), (N4 + N16) * 4);
      }
    } else {
      x.timed_out = timed_out;
      x.timeout_ns = timeout_ns;
      x.ranks = ranks;
      x.rank = rank;
      x.read = b;
    }
  }
  if constexpr (!CLUSTER) {
    for (int p = tid; p < ranks; p += blockDim.x) {
      pflag[p] = wave[p].flags + b;
      pmax[p] = wave[p].maxima + (size_t)b * NMAX_WAVE;
      psum[p] = wave[p].sums + (size_t)b * S;
    }
  }
  for (int i = tid; i < BWD_BOOKS * BWD_CODES; i += blockDim.x)
    sBook[i / BWD_CODES][i % BWD_CODES] =
        e.e_codes[(size_t)b * BWD_BOOKS * BWD_CODES + i];
  const uint32_t fl = *reinterpret_cast<const uint32_t*>(e.sflags + 4 * u);
  const uint32_t pat = *reinterpret_cast<const uint32_t*>(e.pattern + 4 * u);
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  // the sums the thread's states read: sum4 at (lo + 4 u) % 1024 .. + 3 and
  // sum16 at (lo + 4 u) % 256 .. + 3; cooperative: in rank o4's record at
  // c4 and rank o16's at c16 (a record: sum4 of the rank's W / 4 blocks,
  // their logs, then sum16 of its W / 16)
  const int j4 = (lo + 4 * u) & (N4 - 1), j16 = (lo + 4 * u) & (N16 - 1);
  const int o4 = j4 >> (slice_shift - 2), c4 = j4 & (U - 1);
  const int o16 = j16 >> (slice_shift - 4);
  const int c16 = 2 * U + (j16 & ((U >> 2) - 1));

  __syncthreads();  // the mbarriers' init before every wait; the tables
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
  if constexpr (CLUSTER) {
    // the rows, before a repeating lane reads them; every block's
    // mbarriers initialised and armed before the first push
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();  // the rows, before a repeating lane reads them
  }

  // the emissions of the thread's states at event te
  auto emission4 = [&](int te, float (&em)[4]) {
    const float xe = evm[te], ye = evs[te], ly3 = 3.0f * evl[te];
    float lm[4], ls[4], nlls[4], sm[4], slam[4], c1[4];
    unpack4(lm, lds4(smem + 0 * W + 4 * u));
    unpack4(ls, lds4(smem + 1 * W + 4 * u));
    unpack4(nlls, lds4(smem + 2 * W + 4 * u));
    unpack4(sm, lds4(smem + 3 * W + 4 * u));
    unpack4(slam, lds4(smem + 4 * W + 4 * u));
    unpack4(c1, lds4(smem + 5 * W + 4 * u));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      em[i] = emission_pre(xe, ye, ly3, lm[i], ls[i], nlls[i], sm[i],
                           slam[i], c1[i], log2pi);
  };
  // SPLIT: cycles of thread 0's pushes and waits, and of the whole step
  unsigned long long c_all = 0, c_push = 0, c_wait = 0;
  auto stamp = [&]() -> long long { return SPLIT ? clock64() : 0; };

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float em[4];  // em(t + 1) of the thread's states
  emission4(t_zero, em);
  for (int t = t_zero - 1; t >= 0; --t) {
    const int s = t_zero - 1 - t, q = s & 1;
    const long long tc0 = stamp();
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = em[i] + beta[i];
    {
      const float mx = warp_max_nan4(g);
      if (lane == 0) sMax[warp] = mx;
    }
    __syncthreads();  // the warps' maxima
    // exchange 1: the rank's partial max of g; the next step's emissions
    // while the peers publish
    const long long tc1 = stamp();
    if (warp == 0) {
      const float vm = lane < nw ? sMax[lane] : -INFINITY;
      const float pm = warp_max_nan(vm, vm != vm);
      if constexpr (CLUSTER) {
        if (lane < ranks)
          st_async(cluster_map(smem_addr(&sRanks[q][rank]), lane), pm,
                   cluster_map(smem_addr(&xmax[q]), lane));
      } else if (lane == 0) {
        pmax[rank][(size_t)q * B * NMAX_WAVE] = pm;
        st_flag<SYS>(pflag[rank], 2 * s + 1);
      }
    }
    const long long tc2 = stamp();
    if (t > 0) emission4(t, em);
    const long long tc3 = stamp();
    float m;
    if constexpr (CLUSTER) {
      const uint32_t mb = smem_addr(&xmax[q]);
      mbar_wait_cluster(mb, (s >> 1) & 1);
      if (tid == 0 && s + 2 < n_steps) mbar_rearm(mb, ranks * 4);
      const float v = lane < ranks ? sRanks[q][lane] : -INFINITY;
      m = warp_max_nan(v, v != v);
    } else {
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, pflag, 2 * s + 1, lane);
        float mx[1];
        ranks_max<SYS, 1>(pmax, (size_t)q * B * NMAX_WAVE, ranks, lane, mx);
        if (lane == 0) sM = mx[0];
      }
      __syncthreads();
      m = sM;
    }
    const long long tc4 = stamp();
    float G[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) G[i] = expf(g[i] - m);
    // exchange 2: sum4 of the thread's 4 states, and sum16 continuing sum4
    // of the quad's first thread through the next 3 by shuffles, beta_step's
    // float sequence
    const float s4 = ((G[0] + G[1]) + G[2]) + G[3];
    const int qi = lane & 3;
    float s16 = s4;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float prev = __shfl_up_sync(FULL, s16, 1);
      if (qi == k) s16 = (((prev + G[0]) + G[1]) + G[2]) + G[3];
    }
    const long long tc5 = stamp();
    float T4[4], T16[4];
    long long tc6, tc7;
    if constexpr (CLUSTER) {
      const uint32_t mb = smem_addr(&xsum[q]);
      if (own) {
        const uint32_t a4 = smem_addr(&sSums[q][(lo >> 2) + u]);
        const uint32_t a16 = smem_addr(&sSums[q][N4 + (lo >> 4) + (u >> 2)]);
        for (int p = 0; p < ranks; ++p)
          st_async(cluster_map(a4, p), s4, cluster_map(mb, p));
        if (qi == 3)
          for (int p = 0; p < ranks; ++p)
            st_async(cluster_map(a16, p), s16, cluster_map(mb, p));
      }
      tc6 = stamp();
      mbar_wait_cluster(mb, (s >> 1) & 1);
      if (tid == 0 && s + 2 < n_steps) mbar_rearm(mb, (N4 + N16) * 4);
      tc7 = stamp();
      unpack4(T4, lds4(&sSums[q][j4]));
      unpack4(T16, lds4(&sSums[q][N4 + j16]));
    } else {
      if (own) {
        float* rec = psum[rank] + (size_t)q * bs;
        rec[u] = s4;
        if (qi == 3) rec[2 * U + (u >> 2)] = s16;
      }
      __syncthreads();  // the rank's sums stored
      if (tid == 0) st_flag<SYS>(pflag[rank], 2 * s + 2);
      tc6 = stamp();
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, pflag, 2 * s + 2, lane);
      }
      __syncthreads();
      tc7 = stamp();
      const float* r4 = psum[o4] + (size_t)q * bs + c4;
      const float* r16 = psum[o16] + (size_t)q * bs + c16;
#pragma unroll
      for (int i = 0; i < 4; ++i) T4[i] = ld_column<SYS>(r4 + i);
#pragma unroll
      for (int i = 0; i < 4; ++i) T16[i] = ld_column<SYS>(r16 + i);
    }
    // beta of the thread's states (t < len - 1 here)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      const unsigned p = (pat >> (8 * i)) & 0xffu;
      const float hG = (f & BWD_F_H) ? G[i] : 0.0f;
      const float p2G = (f & BWD_F_P2) ? G[i] : 0.0f;
      const float s5T4 = (f & BWD_F_S5T) ? T4[i] : 0.0f;
      const float total =
          (sBook[0][p] * G[i] + sBook[1][p] * (T4[i] - hG)) +
          sBook[2][p] * ((T16[i] - p2G) - s5T4);
      beta[i] = m + logf(total);
    }
    if (own) store4(out + (size_t)t * W, beta);
    if constexpr (SPLIT) {
      c_all += stamp() - tc0;
      c_push += (tc2 - tc1) + (tc6 - tc5);
      c_wait += (tc4 - tc3) + (tc7 - tc6);
    }
  }
  if constexpr (CLUSTER) {
    // no block leaves while a peer may still write its shared memory
    cluster_arrive();
    cluster_wait();
  }
  if constexpr (SPLIT) {
    if (tid == 0) {
      atomicAdd(&k6dm_split[0], c_all - c_push - c_wait);
      atomicAdd(&k6dm_split[1], c_push);
      atomicAdd(&k6dm_split[2], c_wait);
      atomicAdd(&k6dm_split[3], (unsigned long long)n_steps);
    }
  }
}

using BetaWaveKernel =
    decltype(&fwbw_backward_wave_kernel<false, false, false>);

#ifdef NC_SPLIT
constexpr bool kSplit = true;
#else
constexpr bool kSplit = false;
#endif

// the instance of an exchange: a cluster a read (one card; the SPLIT
// build's stamped instance), else the cooperative grid at gpu or system
// scope
BetaWaveKernel beta_wave_kernel(int sys, int cluster) {
  if (cluster) return fwbw_backward_wave_kernel<false, true, kSplit>;
  return sys ? fwbw_backward_wave_kernel<true, false, false>
             : fwbw_backward_wave_kernel<false, false, false>;
}

// the dynamic shared memory: the model rows, (cooperative) 3 pointer
// tables of M
int beta_wave_smem(int slice_shift, int cluster) {
  return MODEL_ROWS * (1 << slice_shift) * 4 +
         (cluster ? 0 : 3 * (N >> slice_shift) * (int)sizeof(void*));
}

// the launch's shape: a cooperative grid (reads, ranks), or (cluster) a
// grid (ranks, reads) of clusters of the read's M ranks
void beta_wave_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int n_reads, int n_local, int slice_shift, int smem,
                      int cluster) {
  cfg = {};
  cfg.blockDim = dim3(slice_threads(slice_shift));
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

}  // namespace

// K6dm's wave: the most blocks of its instance (sys, slices of 1 <<
// slice_shift states) that one card holds at once (blocks an SM at its
// slice_threads and shared memory, times the SMs) into *blocks; (cluster)
// the blocks of the clusters of M ranks it holds at once.  An error where
// the card has no cooperative launch (or, cluster, where the clusters do
// not fit).
extern "C" int nc_fwbw_backward_wave_resident(int sys, int slice_shift,
                                              int cluster, int device,
                                              int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  const int ranks = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 ||
      (cluster && (sys || ranks > MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const BetaWaveKernel kernel = beta_wave_kernel(sys, cluster);
  const int smem = beta_wave_smem(slice_shift, cluster);
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
    beta_wave_config(cfg, attr, 1, ranks, slice_shift, smem, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * ranks;
    return (int)err;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, slice_threads(slice_shift), smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K6dm: the reverse pass of the reads [lo, lo + n_reads) for n_local ranks
// of a data row on `stream`, each rank storing its slice of the betas,
// blocks of slice_threads(slice_shift) threads: one cooperative grid
// (n_reads, n_local), or (cluster: every rank of the row, on this card, M
// <= MAX_CLUSTER) a grid of the reads' clusters.  `ranks` (device memory of
// this card) holds the row's M = 4096 >> slice_shift BetaWaveRank entries,
// then the n_local ranks to run as int64; the entries' tensors lie on their
// ranks' cards, reachable from this one (peer access); the model rows and
// betas 16-byte aligned, the counters zero before the launch (the cluster
// path reads neither them nor the maxima and sums).  sys: the exchange at
// system scope.  timed_out: as K1m's.  Returns the launch's error: a
// cooperative grid larger than the card holds at once is refused
// (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_fwbw_backward_wave(const void* ranks, int n_local, int B,
                                     int T, int lo, int n_reads,
                                     int slice_shift, int sys, int cluster,
                                     float log2pi, long long timeout_ns,
                                     int32_t* timed_out, int device,
                                     void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int M = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 || n_local > M ||
      timed_out == nullptr ||
      (cluster && (sys || n_local != M || M > MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const BetaWaveKernel kernel = beta_wave_kernel(sys, cluster);
  const int smem = beta_wave_smem(slice_shift, cluster);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  beta_wave_config(cfg, attr, n_reads, n_local, slice_shift, smem, cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const BetaWaveRank*>(ranks), B, T, lo,
                           slice_shift, log2pi, timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

#ifdef NC_SPLIT
// The SPLIT build's cycles since the last call (the step's own work,
// pushes, waits, steps stamped, summed over the blocks' thread 0) into
// out[4], cleared.
extern "C" int nc_fwbw_backward_wave_split(int device,
                                           unsigned long long* out) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaMemcpyFromSymbol(out, k6dm_split, sizeof(k6dm_split));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(k6dm_split, zero, sizeof(zero));
  return (int)err;
}
#endif
