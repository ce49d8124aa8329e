// K4: grouped log-sum-exp forward over all T events of a read (the EM
// E-step's forward half).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw_grouped_forward (+ log_emission,
// inlined), a lax.scan body that XLA compiled for the TPU.  Per step
// t = 1..T-1 and destination state j (n = 4096, K = 6):
//   m      = max over j of alpha[j] (NaN-propagating, torch.amax)
//   E[j]   = exp(alpha[j] - m)
//   S4[c]  = sum over r = 0..3  of E[r*1024 + c]   (added in r order)
//   S16[c] = sum over r = 0..15 of E[r*256 + c]    (added in r order)
//   total  = e_stay[j] E[j] + e_step[j] (S4[j>>2] - H[j] E[j])
//            + e_skip[j] (S16[j>>4] - P2mH[j] E[j] - S5[j] S4[j>>2])
//   alpha'[j] = t < length ? (em(t, j) + m) + log(total) : alpha[j]
// with alpha0 = em(0, j) - log(n).  alphas[t] (T, B, n) holds the carry
// after event t, so rows past a read's length repeat its last alpha, as
// the JAX scan's ys do; without an alphas buffer nothing is stored per step.
// log_pr_data = mfin + log(sum_j exp(final[j] - mfin)), mfin the
// NaN-propagating max, the sum as the pairwise tree of ops/hmm.py tree_sum.
//
// Design (for the H100): one block per read, 1024 threads, the time loop
// inside the block (one launch per EM round), alpha in registers only, in
// K1's column layout (viterbi_forward.cu): thread (warp w, lane 8q + k)
// owns column c = 256q + 8w + k of the 4 x 1024 view, the states
// j = 1024r + c, r < 4.
//   - S4[c] is a sum over the thread's own 4 registers, in r order.
//   - S16[c16] (c16 = 8w + k) needs the rows r16 = 4r + q' in increasing
//     r16 order; row 4r + q' is register r of lane 8q' + k of the same
//     warp.  sum16 takes the 16 values by shuffles, which do not depend on
//     each other, and adds them in r16 order in every lane of the column:
//     no shared memory, no serial loop on a subset of threads.
//   - Two block barriers a step: (1) the block max, from the per-warp
//     maxima published at the end of the step before (NaN-propagating from
//     step 0); (2) the S4 and S16 columns, written to padded shared arrays
//     (K1's p4 / p16: free of bank conflicts) and read back at j>>2 and
//     j>>4.  Barrier 1 also separates a step's reads of the column arrays
//     from the next step's writes, so single buffers suffice.
//   - The maxima propagate NaN as torch.amax does, at fmaxf's cost: fmaxf
//     and one vote for NaN (common.cuh warp_max_nan; fmaxf alone drops a
//     NaN).
//   - The 9 per-read tables live in registers, with -log_level_stdv and
//     log_sd_lambda - log2pi taken once per read (emission_pre).
//   - Alphas are stored per row r: 4 runs of 32 B (whole sectors) per warp
//     and row.  The fit-only variant (alphas == nullptr) stores nothing per
//     step.
//
// What bounds it: issue on the read's one SM (per state and step one exp,
// one log, the emission's 3 IEEE divisions, 4 shuffles of sum16) and the 2
// barriers; then the 16 KB alpha store per read and step.  Only B of the
// 132 SMs work when B < 132.
//
// K4m (fwbw_forward_wave_kernel) is K4 with the 4096 states split over M =
// 2 .. 64 ranks (the EM round under nanocall_tpu/parallel/mesh.py:126
// shard_train_inputs; parallel/statepar.py drives it).  A block is one
// (read, rank) pair and runs all T events on W / 4 threads, 4 contiguous
// states a thread, K4's nine tables of them in registers: the M blocks of
// a read fit an SM together (64 registers), about 132 reads at once at
// any rank count.  A block spends only its own states' work, plus one
// exchange a step: it publishes its slice of column t - 1 with the
// slice's partial max (NaN vote); takes the step's emissions while the
// peers publish; m is the NaN-voted max of the M partials (K4's, exact);
// then each thread reads only the 8 values its states' sums read, in
// place from the ranks' slices: the 4 rows r 1024 + c4 of its S4 and 4 of
// the 16 rows r16 256 + c16 of its S16, whose sum in r16 order runs
// through its quad by shuffles; 12 exps a thread.  Then K4's correction
// and emission, and the store of its slice of column t, into the alphas
// (T, B, W) or, storing none, a (2, B, W) column buffer.  log Pr[data]:
// each rank's subtree of K4's pairwise tree under the final max, combined
// pairwise in rank order (hmm.combine_rank_sums).  So every rank computes
// K4's bits for its states, NaN bits included.
// The exchange takes one of two paths (wave_exchange.cuh).  On one card
// with M <= 8 (CLUSTER) a read's M blocks are one thread block cluster,
// the slice and partials also in shared memory, read over distributed
// shared memory behind one cluster barrier a step; one launch takes a
// row's reads.  Else (across cards, or more ranks) a cooperative grid a
// wave, the slices and partials read in place by relaxed loads behind a
// counter a step.  What bounds it: K4's
// step for W states on W / 4 threads, plus the exchange's latency a step,
// which the emissions partly hide.

// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_grouped_forward_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"
#include "device_guard.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// bits of the per-state flag byte (ops/hmm.py FWD_FLAG_BITS)
constexpr unsigned F_H = 1u, F_P2 = 2u, F_S5 = 4u;

// Padded slots of the S4 and S16 column arrays (K1's), free of bank
// conflicts for the step's writes (column c, c16) and reads (j>>2, j>>4):
// tests/test_torch_kernel_forms.py
__device__ __forceinline__ int p4(int i) { return i + 2 * (i >> 6); }
__device__ __forceinline__ int p16(int i) { return i + (i >> 4); }
constexpr int P4N = N4 + 2 * (N4 >> 6);
constexpr int P16N = N16 + (N16 >> 4);
// state j = 1024 r + c reads S4 slot p4(j >> 2) = p4(c >> 2) + r * R4 and
// S16 slot p16(j >> 4) = p16(c >> 4) + r * R16
constexpr int R4 = N16 + 2 * (N16 >> 6);
constexpr int R16 = 64 + (64 >> 4);

__global__ void __launch_bounds__(THREADS, 1)
fwbw_forward_kernel(const float* __restrict__ ev_mean,
                    const float* __restrict__ ev_stdv,
                    const float* __restrict__ ev_log_stdv,
                    const int32_t* __restrict__ length, int B, int T,
                    const float* __restrict__ e_stay,
                    const float* __restrict__ e_step,
                    const float* __restrict__ e_skip,
                    const float* __restrict__ level_mean,
                    const float* __restrict__ level_stdv,
                    const float* __restrict__ log_level_stdv,
                    const float* __restrict__ sd_mean,
                    const float* __restrict__ sd_lambda,
                    const float* __restrict__ log_sd_lambda,
                    const uint8_t* __restrict__ flags, float log2pi,
                    float log_n, float* __restrict__ alphas,
                    float* __restrict__ lpd) {
  __shared__ float sS4[P4N];
  __shared__ float sS16[P16N];
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];
  __shared__ __align__(16) float sFin[N];  // exp(final - mfin), in j order

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, k = lane & 7;
  const int c16 = warp * 8 + k;  // the thread's column of the 16 x 256 view
  const int c = q * N16 + c16;   // and of the 4 x 1024 view
  const size_t rowb = (size_t)b * N;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_nlls[4],
      r_sm[4], r_slam[4], r_c1[4];
  uint32_t fl = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t j = rowb + r * N4 + c;
    r_stay[r] = e_stay[j];
    r_step[r] = e_step[j];
    r_skip[r] = e_skip[j];
    r_lm[r] = level_mean[j];
    r_ls[r] = level_stdv[j];
    r_nlls[r] = -log_level_stdv[j];
    r_sm[r] = sd_mean[j];
    r_slam[r] = sd_lambda[j];
    r_c1[r] = log_sd_lambda[j] - log2pi;
    fl |= (uint32_t)flags[r * N4 + c] << (8 * r);
  }
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];

  float a[4];
  // alphas[t] at the thread's 4 states: one run of 32 B per 8 lanes
  auto store_row = [&](int t) {
    float* o = alphas + (size_t)t * B * N + rowb + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r * N4] = a[r];
  };
  // each warp's NaN-propagating max of alpha, for the next barrier
  auto publish_max = [&]() {
    const float mx = warp_max_nan4(a);
    if (lane == 0) sMax[warp] = mx;
  };
  // the block's, from the warps'
  auto block_max = [&]() {
    return warp_max_nan(sMax[lane], sMax[lane] != sMax[lane]);
  };

  {
    const float x = evm[0], y = evs[0], ly3 = 3.0f * evl[0];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = emission_pre(x, y, ly3, r_lm[r], r_ls[r], r_nlls[r], r_sm[r],
                          r_slam[r], r_c1[r], log2pi) -
             log_n;
    if (alphas != nullptr) store_row(0);
    publish_max();
  }

  const float* rd4 = sS4 + p4(c >> 2);
  const float* rd16 = sS16 + p16(c >> 4);
  for (int t = 1; t < T; ++t) {
    // the step's event, loaded before the barriers that hide its latency
    const float x = evm[t], y = evs[t], ly = evl[t];
    __syncthreads();  // 1: the warps' maxima of alpha(t-1)
    const float m = block_max();
    float E[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) E[r] = expf(a[r] - m);
    sS4[p4(c)] = ((E[0] + E[1]) + E[2]) + E[3];
    {
      // sum16: rows r16 = 0..15 of column c16, row 4r + q' from register
      // r of lane 8q' + k, added in r16 order
      float s = __shfl_sync(FULL, E[0], k);
#pragma unroll
      for (int r16 = 1; r16 < 16; ++r16)
        s = s + __shfl_sync(FULL, E[r16 >> 2], (r16 & 3) * 8 + k);
      if (q == 0) sS16[p16(c16)] = s;
    }
    __syncthreads();  // 2: the S4 and S16 columns

    const bool active = t < len;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s4 = rd4[r * R4];
      const float s16 = rd16[r * R16];
      const unsigned f = (fl >> (8 * r)) & 0xffu;
      const float hE = (f & F_H) ? E[r] : 0.0f;
      const float p2E = (f & F_P2) ? E[r] : 0.0f;
      const float s5S4 = (f & F_S5) ? s4 : 0.0f;
      const float total = (r_stay[r] * E[r] + r_step[r] * (s4 - hE)) +
                          r_skip[r] * ((s16 - p2E) - s5S4);
      const float em = emission_pre(x, y, 3.0f * ly, r_lm[r], r_ls[r],
                                    r_nlls[r], r_sm[r], r_slam[r], r_c1[r],
                                    log2pi);
      if (active) a[r] = (em + m) + logf(total);
    }
    if (alphas != nullptr) store_row(t);
    // every thread has read sMax in this step (it passed barrier 2)
    publish_max();
  }

  // log_pr_data of the final alpha: its exps in state order, then the
  // pairwise tree over 4 contiguous states a thread, the warp, the warps
  __syncthreads();
  const float mfin = block_max();
#pragma unroll
  for (int r = 0; r < 4; ++r) sFin[r * N4 + c] = expf(a[r] - mfin);
  __syncthreads();
  float v[4];
  unpack4(v, *reinterpret_cast<const float4*>(sFin + 4 * tid));
  const float ws = warp_tree_sum(quad_sum(v));
  if (lane == 0) sSum[warp] = ws;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_sum(sSum[lane]);
    if (lane == 0) lpd[b] = mfin + logf(s);
  }
}

// The ranks of a K4m launch (as K1m's WaveRank): one entry a rank of the
// data row (the M entries, then the ranks this launch runs, as int64), in
// device memory of the launch's card; every pointer on the rank's own card.
struct FwdWaveRank {
  const float* ev_mean;  // (B, T) events and (B,) lengths, the row's
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  // (B, W) of the rank's states: e_stay, e_step, e_skip, level_mean,
  // level_stdv, log_level_stdv, sd_mean, sd_lambda, log_sd_lambda; then
  // the (W,) flag bytes (null in a peer's entry: never read)
  const float* tab[9];
  const uint8_t* sflags;
  float* col;      // (T, B, W) alphas, or (2, B, W): column t at t & 1
  float* part;     // (3, B): partial max of column t at t & 1; partial sum
  float* lpd;      // (B,) log Pr[data]
  int32_t* flags;  // (B,) counter
};

// The pairwise-tree sum of the first 1 << levels lanes of each group of
// that many in the warp, in the group's first lane
__device__ __forceinline__ float sub_tree_sum(float v, int levels) {
  for (int off = 1; off < (1 << levels); off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// K4m: events [0, T) of one read for one rank, which holds the states
// [rank W, (rank + 1) W), W = 1 << slice_shift, on
// slice_threads(slice_shift) threads.  The exchange: CLUSTER, the read's M
// ranks one cluster of a grid (M, reads), each block's slice of the column
// and partials published in its shared memory (wave_exchange.cuh); else a
// cooperative grid (reads, ranks this launch runs), block (i, j) the read
// wave_lo + i for the rank named by entry j of the launch's ranks (after
// the M = N >> slice_shift entries of `wave`), the slices and partials in
// global memory behind counters.  stored: col holds the alphas (T, B, W),
// else a (2, B, W) column buffer.  Dynamic shared memory: (CLUSTER)
// the slice of column t at t & 1, the partial maxima at t & 1 and the
// partial sum; then the ranks' counters, published columns and partials
// at the read (M pointers each).
template <bool SYS, bool CLUSTER>
__global__ void __launch_bounds__(SLICE_MAX_THREADS, 2)
fwbw_forward_wave_kernel(const FwdWaveRank* __restrict__ wave, int B, int T,
                         int wave_lo, int slice_shift, int stored,
                         float log2pi, float log_n, long long timeout_ns,
                         int32_t* timed_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ WaveSync x;
  __shared__ float sMax[SLICE_MAX_WARPS];
  __shared__ float sSum[SLICE_MAX_WARPS];
  __shared__ float sM;

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, U = W >> 2;
  const int rank =
      CLUSTER ? (int)blockIdx.x
              : (int)reinterpret_cast<const long long*>(wave + ranks)
                    [blockIdx.y];
  const int b = wave_lo + (int)(CLUSTER ? blockIdx.y : blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const FwdWaveRank& e = wave[rank];
  float* const sA = smem;
  float* const sPub = smem + (CLUSTER ? 2 * W : 0);
  int32_t** pflag =
      reinterpret_cast<int32_t**>(smem + (CLUSTER ? 2 * W + 4 : 0));
  float** pcol = reinterpret_cast<float**>(pflag + ranks);
  float** ppart = pcol + ranks;
  for (int p = tid; p < ranks; p += blockDim.x) {
    pflag[p] = wave[p].flags + b;
    pcol[p] = wave[p].col + (size_t)b * W;
    ppart[p] = wave[p].part + b;
  }
  if (tid == 0) {
    x.timed_out = timed_out;
    x.timeout_ns = timeout_ns;
    x.ranks = ranks;
    x.rank = rank;
    x.read = b;
  }
  // thread u holds the states lo + 4 u .. + 3 (own: u = tid); the nw warps'
  // trees take lv levels in a warp, nw_lv across them
  const int lo = rank << slice_shift;
  const bool own = tid < U;
  const int u = tid & (U - 1);
  const int nw = U >= 32 ? U >> 5 : 1;
  const int lv = U >= 32 ? 5 : slice_shift - 2;
  const int nw_lv = 31 - __clz(nw);
  // the thread's states read S4[c4] and S16[c16]: S4 sums the rows r 1024
  // + c4 (r < 4), which the thread reads; S16 the rows r16 256 + c16 (r16 <
  // 16), of which the thread reads r16 = 4 qi .. 4 qi + 3 and its quad the
  // rest (the quad's 4 threads share c16)
  const int c4 = (lo >> 2) + u, c16 = c4 >> 2, qi = lane & 3;
  const size_t colstride = (size_t)B * W;
  const size_t row = (size_t)b * W + 4 * u;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_nlls[4],
      r_sm[4], r_slam[4], r_c1[4];
  {
    float v[4];
    unpack4(r_stay, load4(e.tab[0] + row));
    unpack4(r_step, load4(e.tab[1] + row));
    unpack4(r_skip, load4(e.tab[2] + row));
    unpack4(r_lm, load4(e.tab[3] + row));
    unpack4(r_ls, load4(e.tab[4] + row));
    unpack4(v, load4(e.tab[5] + row));
#pragma unroll
    for (int i = 0; i < 4; ++i) r_nlls[i] = -v[i];
    unpack4(r_sm, load4(e.tab[6] + row));
    unpack4(r_slam, load4(e.tab[7] + row));
    unpack4(v, load4(e.tab[8] + row));
#pragma unroll
    for (int i = 0; i < 4; ++i) r_c1[i] = v[i] - log2pi;
  }
  const uint32_t fl = *reinterpret_cast<const uint32_t*>(e.sflags + 4 * u);
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  const int len = e.length[b];
  float* const own_col = e.col + row;
  auto slot = [&](int t) { return (size_t)(stored ? t : (t & 1)); };
  __syncthreads();  // the pointer tables

  float a[4], em[4];
  // the emissions of the thread's states at event te
  auto emission4 = [&](int te) {
    const float xe = evm[te], ye = evs[te], ly3 = 3.0f * evl[te];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      em[i] = emission_pre(xe, ye, ly3, r_lm[i], r_ls[i], r_nlls[i], r_sm[i],
                           r_slam[i], r_c1[i], log2pi);
  };
  // the rank's partial max of column tc (the thread's a), published at tc
  // & 1 with counter ph once every thread's slice of the column is stored
  auto publish_max = [&](int tc, int ph) {
    const float mx = warp_max_nan4(a);
    if (lane == 0) sMax[warp] = mx;
    __syncthreads();  // the warps' maxima; the slice of column tc stored
    if (warp == 0) {
      const float vm = lane < nw ? sMax[lane] : -INFINITY;
      const float mp = warp_max_nan(vm, vm != vm);
      if (lane == 0) {
        if constexpr (CLUSTER) {
          sPub[tc & 1] = mp;
        } else {
          ppart[rank][(size_t)(tc & 1) * B] = mp;
          st_flag<SYS>(pflag[rank], ph);
        }
      }
    }
    if constexpr (CLUSTER) cluster_arrive();
  };
  // every rank's, once counter ph is in (CLUSTER: after the cluster
  // barrier, each warp from the peers' shared memory): the max of column
  // tc
  auto take_max = [&](int tc, int ph) {
    float mx[1];
    if constexpr (CLUSTER) {
      cluster_wait();
      cluster_max<1>(smem_addr(sPub + (tc & 1)), ranks, lane, mx);
      return mx[0];
    } else {
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, pflag, ph, lane);
        ranks_max<SYS, 1>(ppart, (size_t)(tc & 1) * B, ranks, lane, mx);
        if (lane == 0) sM = mx[0];
      }
      __syncthreads();
      return sM;
    }
  };

  // the thread's slice of column t: into the column and (CLUSTER) its
  // shared memory
  auto store_slice = [&](int t) {
    if (!own) return;
    store4(own_col + slot(t) * colstride, a);
    if constexpr (CLUSTER) store4(sA + (t & 1) * W + 4 * u, a);
  };

  emission4(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = em[i] - log_n;
  store_slice(0);

  for (int t = 1; t < T; ++t) {
    publish_max(t - 1, t);
    emission4(t);  // while the peers publish
    const float m = take_max(t - 1, t);
    // the 8 rows the thread reads: S4's 4, then its 4 of S16's
    float E[4], e8[8];
    const size_t src = slot(t - 1) * colstride;
    // the value of state s of the published column
    auto ld_state = [&](int s) {
      if constexpr (CLUSTER)
        return ld_cluster(cluster_map(
            smem_addr(sA + ((t - 1) & 1) * W + (s & (W - 1))),
            s >> slice_shift));
      else
        return ld_column<SYS>(pcol[s >> slice_shift] + src + (s & (W - 1)));
    };
#pragma unroll
    for (int r = 0; r < 4; ++r) e8[r] = ld_state(r * N4 + c4);
#pragma unroll
    for (int k = 0; k < 4; ++k) e8[4 + k] = ld_state((4 * qi + k) * N16 + c16);
#pragma unroll
    for (int k = 0; k < 8; ++k) e8[k] = expf(e8[k] - m);
#pragma unroll
    for (int i = 0; i < 4; ++i) E[i] = expf(a[i] - m);
    const float s4 = ((e8[0] + e8[1]) + e8[2]) + e8[3];
    // S16 in r16 order: the quad's first thread sums rows 0..3, each next
    // thread continues the sum through its 4 rows; the last one's is S16
    float s = ((e8[4] + e8[5]) + e8[6]) + e8[7];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float prev = __shfl_up_sync(FULL, s, 1);
      if (qi == k) s = (((prev + e8[4]) + e8[5]) + e8[6]) + e8[7];
    }
    const float s16 = __shfl_sync(FULL, s, lane | 3);
    const bool active = t < len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      const float hE = (f & F_H) ? E[i] : 0.0f;
      const float p2E = (f & F_P2) ? E[i] : 0.0f;
      const float s5S4 = (f & F_S5) ? s4 : 0.0f;
      const float total = (r_stay[i] * E[i] + r_step[i] * (s4 - hE)) +
                          r_skip[i] * ((s16 - p2E) - s5S4);
      if (active) a[i] = (em[i] + m) + logf(total);
    }
    store_slice(t);
  }

  // log Pr[data]: K4's max of the final column from the ranks' partial
  // maxima, then K4's pairwise tree of exp(final - mfin), each rank's
  // subtree over its states published, combined pairwise in rank order
  // (hmm.combine_rank_sums); every rank takes it
  publish_max(T - 1, T);
  const float mfin = take_max(T - 1, T);
  {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = expf(a[i] - mfin);
    const float ws = sub_tree_sum(quad_sum(v), lv);
    if (lane == 0) sSum[warp] = ws;
  }
  __syncthreads();
  if constexpr (CLUSTER) {
    if (warp == 0) {
      const float wv = lane < nw ? sSum[lane] : 0.0f;
      const float ps = sub_tree_sum(wv, nw_lv);
      if (lane == 0) sPub[2] = ps;
    }
    cluster_arrive();
    cluster_wait();
    if (warp == 0) {
      const float sv =
          lane < ranks ? ld_cluster(cluster_map(smem_addr(sPub + 2), lane))
                       : 0.0f;
      const float total = sub_tree_sum(sv, 31 - __clz(ranks));
      if (lane == 0) e.lpd[b] = mfin + logf(total);
    }
    // no block leaves while a peer reads its shared memory
    cluster_arrive();
    cluster_wait();
  } else {
    if (warp == 0) {
      const float wv = lane < nw ? sSum[lane] : 0.0f;
      const float ps = sub_tree_sum(wv, nw_lv);
      if (lane == 0) {
        ppart[rank][2 * (size_t)B] = ps;
        st_flag<SYS>(pflag[rank], T + 1);
      }
      __syncwarp();
      wait_fold_ranks<SYS>(x, pflag, T + 1, lane);
      const int per_lane = ranks > 32 ? 2 : 1;
      const int lanes = ranks / per_lane;
      float sv = 0.0f;
      if (lane < lanes) {
        sv = ld_column<SYS>(ppart[per_lane * lane] + 2 * (size_t)B);
        if (per_lane == 2)
          sv = sv + ld_column<SYS>(ppart[2 * lane + 1] + 2 * (size_t)B);
      }
      const float total = sub_tree_sum(sv, 31 - __clz(lanes));
      if (lane == 0) e.lpd[b] = mfin + logf(total);
    }
  }
}

using FwdWaveKernel = decltype(&fwbw_forward_wave_kernel<false, false>);

FwdWaveKernel fwd_wave_kernel(int sys, int cluster) {
  if (cluster) return fwbw_forward_wave_kernel<false, true>;
  return sys ? fwbw_forward_wave_kernel<true, false>
             : fwbw_forward_wave_kernel<false, false>;
}

// K4m's dynamic shared memory: (cluster) the slice's 2 columns and the 4
// partials, then 3 pointer tables of M
int fwd_wave_smem(int slice_shift, int cluster) {
  return (cluster ? (2 * (1 << slice_shift) + 4) * 4 : 0) +
         3 * (N >> slice_shift) * (int)sizeof(void*);
}

// the launch's shape: a cooperative grid (reads, ranks), or (cluster) a
// grid (ranks, reads) of clusters of the read's M ranks
void fwd_wave_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                     int n_reads, int n_local, int slice_shift,
                     int cluster) {
  cfg = {};
  cfg.blockDim = dim3(nc::slice_threads(slice_shift));
  cfg.dynamicSmemBytes = fwd_wave_smem(slice_shift, cluster);
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

// K4m's wave: the most blocks of its instance (sys) at slices of 1 << slice_shift states that one card holds at
// once (blocks an SM at slice_threads(slice_shift) threads and its shared
// memory, times the SMs) into *blocks; (cluster) the blocks of the clusters
// of M ranks it holds at once.  An error where the card has no cooperative
// launch (or, cluster, where the clusters do not fit).
extern "C" int nc_fwbw_forward_wave_resident(int sys, int slice_shift,
                                             int cluster,
                                             int device, int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  const int ranks = nc::N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 ||
      (cluster && (sys || ranks > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwdWaveKernel kernel = fwd_wave_kernel(sys, cluster);
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop && !cluster) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess && cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    fwd_wave_config(cfg, attr, 1, ranks, slice_shift, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * ranks;
    return (int)err;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, nc::slice_threads(slice_shift),
        fwd_wave_smem(slice_shift, 0));
  *blocks = per_sm * sms;
  return (int)err;
}

// K4m: events 0 .. T - 1 of the reads [lo, lo + n_reads) for n_local ranks
// of a data row on `stream`, blocks of slice_threads(slice_shift) threads:
// one cooperative grid (n_reads, n_local), or (cluster: every rank of the
// row, on this card, M <= MAX_CLUSTER) a grid of the reads' clusters.
// `ranks` (device memory of this card) holds the row's M = 4096 >>
// slice_shift FwdWaveRank entries, then the n_local ranks to run as int64;
// the entries' (B, W) tables (16-byte aligned), columns, partials and (B,)
// counters (zero before the launch) lie on their ranks' cards, reachable
// from this one (peer access).  stored: the columns are (T, B, W) alphas,
// else (2, B, W) buffers.  sys: the exchange at system scope.  timed_out: as K1m's.
// Returns the launch's error: a cooperative grid larger than the card
// holds at once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_fwbw_forward_wave(const void* ranks, int n_local, int B,
                                    int T, int lo, int n_reads,
                                    int slice_shift, int stored, int sys,
                                    int cluster, float log2pi,
                                    float log_n, long long timeout_ns,
                                    int32_t* timed_out, int device,
                                    void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int M = nc::N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 || n_local > M ||
      timed_out == nullptr ||
      (cluster && (sys || n_local != M || M > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const FwdWaveKernel kernel = fwd_wave_kernel(sys, cluster);
  cudaError_t err = cudaSuccess;
  if (cluster)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd_wave_smem(slice_shift, 1));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fwd_wave_config(cfg, attr, n_reads, n_local, slice_shift, cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const FwdWaveRank*>(ranks), B, T, lo,
                           slice_shift, stored, log2pi, log_n, timeout_ns,
                           timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Plain C entry for ctypes.  alphas == nullptr stores no per-step alphas
// (only log_pr_data).  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_stay,
    const float* e_step, const float* e_skip, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    const uint8_t* flags, float log2pi, float log_n, float* alphas,
    float* lpd, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    fwbw_forward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_stay, e_step, e_skip,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, flags, log2pi, log_n, alphas, lpd);
  }
  return (int)cudaGetLastError();
}
