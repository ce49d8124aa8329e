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
// (read, rank) pair of a cooperative grid and runs all T events, with K1m's
// exchange (wave_exchange.cuh): each step it publishes its counter, waits
// for the peers', then loads the whole column of event t - 1 in place from
// the ranks' slices (4 states a thread, relaxed loads), takes the block
// max with its NaN vote over all of it, and computes E = exp(alpha - m)
// into shared memory only where its states need it: its own W states, and
// the states r 1024 + c and r 256 + c16 whose strided sums S4[c] and
// S16[c16] its states read (at most 3 W values).  Threads 0 .. W / 4 - 1
// own 4 contiguous states each: S4 (one a thread) and S16 (one per 4
// threads) summed in r order from shared memory, K4's correction and
// emission, and the store of their slice of column t, into the alphas
// (T, B, W) or, storing none, a (2, B, W) column buffer.  After the last
// event every rank loads the final column and takes log Pr[data] by K4's
// pairwise tree.  So every rank computes K4's bits for its states, NaN
// bits included.  What bounds it: K4's step for W states on W / 4
// threads, plus the exchange's latency a step (four block barriers, a
// release and an acquire round trip through L2, the 16 KB column of a
// read from L2).
//
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
  float* lpd;      // (B,) log Pr[data]
  int32_t* flags;  // (B,): t once its slice of column t - 1 is stored
};

// K4m: events [0, T) of read wave_lo + blockIdx.x for the rank named by
// entry blockIdx.y of the launch's ranks (after the M = N >> slice_shift
// entries of `wave`), which holds the states [rank W, (rank + 1) W), W =
// 1 << slice_shift.  stored: col holds the alphas (T, B, W), else a (2, B,
// W) column buffer.
template <bool SYS>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_forward_wave_kernel(const FwdWaveRank* __restrict__ wave, int B, int T,
                         int wave_lo, int slice_shift, int stored,
                         float log2pi, float log_n, long long timeout_ns,
                         int32_t* timed_out) {
  __shared__ Exchange x;
  __shared__ __align__(16) float sE[N];  // exp(alpha - m) where needed
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, W4 = W >> 2;
  const int rank =
      (int)reinterpret_cast<const long long*>(wave + ranks)[blockIdx.y];
  const int b = wave_lo + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const FwdWaveRank& e = wave[rank];
  if (tid < ranks) {
    x.col[tid] = wave[tid].col + (size_t)b * W;
    x.flag[tid] = wave[tid].flags + b;
  }
  if (tid == 0) {
    x.timed_out = timed_out;
    x.timeout_ns = timeout_ns;
    x.ranks = ranks;
    x.rank = rank;
    x.read = b;
  }
  const int lo = rank << slice_shift;
  // the thread's own states lo + 4 tid .. + 3, and the sums they read:
  // S4 at c4 = (lo >> 2) + tid, S16 at c4 >> 2
  const bool mine = tid < W4;
  const int u = mine ? tid : 0;
  const int c4 = (lo >> 2) + u, c16 = c4 >> 2;
  const size_t colstride = (size_t)B * W;
  const size_t row = (size_t)b * W + 4 * u;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_nlls[4],
      r_sm[4], r_slam[4], r_c1[4];
  uint32_t fl = 0;
  if (mine) {
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
    fl = *reinterpret_cast<const uint32_t*>(e.sflags + 4 * u);
  }
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  const int len = e.length[b];
  float* const own = e.col + row;
  auto slot = [&](int t) { return (size_t)(stored ? t : (t & 1)); };

  float a[4];
  if (mine) {
    const float x0 = evm[0], y0 = evs[0], ly3 = 3.0f * evl[0];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = emission_pre(x0, y0, ly3, r_lm[i], r_ls[i], r_nlls[i], r_sm[i],
                          r_slam[i], r_c1[i], log2pi) -
             log_n;
    store4(own, a);
  }
  // the whole column of event tc, 4 states a thread (4 tid ..), each warp's
  // NaN-propagating max of it into sMax
  const int j0 = 4 * tid;
  float c[4];
  auto load_column = [&](int tc) {
    const float* src =
        x.col[j0 >> slice_shift] + slot(tc) * colstride + (j0 & (W - 1));
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = ld_column<SYS>(src + i);
    const float mx = warp_max_nan4(c);
    if (lane == 0) sMax[warp] = mx;
  };
  auto publish_and_wait = [&](int t) {
    __syncthreads();  // every thread's slice of column t - 1 stored
    if (tid == 0) st_flag<SYS>(x.flag[x.rank], t);
    if (warp == 0) {
      __syncwarp();
      wait_peers<SYS>(x, t, lane);
    }
    __syncthreads();
  };

  for (int t = 1; t < T; ++t) {
    const float xe = evm[t], ye = evs[t], ly = evl[t];
    publish_and_wait(t);
    load_column(t - 1);
    __syncthreads();
    const float m = warp_max_nan(sMax[lane], sMax[lane] != sMax[lane]);
    // exp only where the rank's states read it: their own E, and the rows
    // of their S4 and S16 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = j0 + i;
      const bool need = (unsigned)(s - lo) < (unsigned)W ||
                        (unsigned)((s & (N4 - 1)) - (lo >> 2)) <
                            (unsigned)W4 ||
                        (unsigned)((s & (N16 - 1)) - (lo >> 4)) <
                            (unsigned)(W >> 4);
      if (need) sE[s] = expf(c[i] - m);
    }
    __syncthreads();
    if (!mine) continue;
    const float s4 = ((sE[c4] + sE[N4 + c4]) + sE[2 * N4 + c4]) +
                     sE[3 * N4 + c4];
    float s16 = sE[c16];
#pragma unroll
    for (int r16 = 1; r16 < 16; ++r16) s16 = s16 + sE[r16 * N16 + c16];
    const bool active = t < len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float E = sE[lo + 4 * u + i];
      const unsigned f = (fl >> (8 * i)) & 0xffu;
      const float hE = (f & F_H) ? E : 0.0f;
      const float p2E = (f & F_P2) ? E : 0.0f;
      const float s5S4 = (f & F_S5) ? s4 : 0.0f;
      const float total = (r_stay[i] * E + r_step[i] * (s4 - hE)) +
                          r_skip[i] * ((s16 - p2E) - s5S4);
      const float em = emission_pre(xe, ye, 3.0f * ly, r_lm[i], r_ls[i],
                                    r_nlls[i], r_sm[i], r_slam[i], r_c1[i],
                                    log2pi);
      if (active) a[i] = (em + m) + logf(total);
    }
    store4(own + slot(t) * colstride, a);
  }

  // log_pr_data from the whole final column: K4's max, then the pairwise
  // tree over 4 contiguous states a thread, the warp, the warps
  publish_and_wait(T);
  load_column(T - 1);
  __syncthreads();
  const float mfin = warp_max_nan(sMax[lane], sMax[lane] != sMax[lane]);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = expf(c[i] - mfin);
  const float ws = warp_tree_sum(quad_sum(v));
  if (lane == 0) sSum[warp] = ws;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_sum(sSum[lane]);
    if (lane == 0) e.lpd[b] = mfin + logf(s);
  }
}

using FwdWaveKernel = decltype(&fwbw_forward_wave_kernel<false>);

FwdWaveKernel fwd_wave_kernel(int sys) {
  return sys ? fwbw_forward_wave_kernel<true>
             : fwbw_forward_wave_kernel<false>;
}

}  // namespace

// K4m's wave: the most blocks of its instance (sys) that one card holds at
// once (blocks an SM at 1024 threads times the SMs) into *blocks; an error
// where the card has no cooperative launch.
extern "C" int nc_fwbw_forward_wave_resident(int sys, int device,
                                             int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fwd_wave_kernel(sys), nc::THREADS, 0);
  *blocks = per_sm * sms;
  return (int)err;
}

// K4m: events 0 .. T - 1 of the reads [lo, lo + n_reads) for n_local ranks
// of a data row, one cooperative grid (n_reads, n_local) on `stream`.
// `ranks` (device memory of this card) holds the row's M = 4096 >>
// slice_shift FwdWaveRank entries, then the n_local ranks to run as int64;
// the entries' (B, W) tables (16-byte aligned), columns and (B,) counters
// (zero before the launch) lie on their ranks' cards, reachable from this
// one (peer access).  stored: the columns are (T, B, W) alphas, else (2,
// B, W) buffers.  sys: the exchange at system scope.  timed_out: as K1m's.
// Returns the launch's error: a grid larger than the card holds at once is
// refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_fwbw_forward_wave(const void* ranks, int n_local, int B,
                                    int T, int lo, int n_reads,
                                    int slice_shift, int stored, int sys,
                                    float log2pi, float log_n,
                                    long long timeout_ns, int32_t* timed_out,
                                    int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 ||
      n_local > (nc::N >> slice_shift) || timed_out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_reads, n_local);
  cfg.blockDim = dim3(nc::THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fwd_wave_kernel(sys), static_cast<const FwdWaveRank*>(ranks), B,
      T, lo, slice_shift, stored, log2pi, log_n, timeout_ns, timed_out);
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
