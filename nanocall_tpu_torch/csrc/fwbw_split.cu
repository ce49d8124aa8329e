// The streaming K6c and K6e on one card, a read's 4096 states cut over a
// thread block cluster: the forward-backward under a loaded table without
// K6c's packed layout (ops/hmm.py fwbw_route "streaming"), one table or
// per-read log-probs, in the form ops/hmm.py fwbw_stream_split picks by
// the read count.
//
// Replaces nanocall_tpu/ops/hmm.py fwbw (+ _logsumexp_slots and
// log_emission; the recursions of fwbw_generic.cu's header) and
// fwbw_custom (+ norm, :1064; fwbw_custom.cu's header) under a table that
// streams, one table or per-read log-probs (make_trans_ops_batch, :82).
//
// Design (for the H100).  A kernel of one block of 1024 threads a read
// steps the read's 4096 states on one SM, reading both sides' (deg, 4096)
// int32 / float32 tables from L2 twice a step (the max, then the sum): at
// one read (the dev tools, B = 1) one SM of 132 pulls 2 x deg x 32 KB a
// step, and at many reads each block's 6 model rows x 4 states and the
// table's loads share 64 registers.  Here:
//   - C = 8 blocks a read, one thread block cluster, block c stepping the
//     states [c W, (c + 1) W), W = 512, on W / S threads: S = 1 or 2
//     states a thread (u + i W / S), so that one read's slot chains spread
//     over 8 SMs.  The body is K6cm's (fwbw_wave_body.cuh, FORM_GENERIC
//     and FORM_CUSTOM, one read a block): each thread pushes its values of
//     the gathered column (alpha forward, g backward) into every block's
//     double-buffered column by st.async onto that block's mbarrier, and
//     each block waits on its own mbarrier alone (wave_exchange.cuh); the
//     emissions of every event are computed once and stored (K6c's em
//     output; K6e: a scratch), then fetched a step ahead by cp.async, so
//     no register holds the model through the slot loop.
//   - In place: block c reads its cut of the table at column offset c W
//     (row stride 4096; per read, read b's log-probs at b deg 4096 on) and
//     its columns of the (B, 4096) model, and writes its columns of the (B,
//     T, 4096) outputs through the row stride: no cut copies, no slices to
//     join.
//   - K6c's log Pr[data]: each block's partial max and pairwise tree sum of
//     its slice (the S subtrees [i W / S, (i + 1) W / S) folded pairwise: a
//     subtree of tree_sum), the 8 partial sums combined pairwise in rank
//     order by block 0 (hmm.combine_rank_sums): K6c's bits.
//   - K6e's normalisation each forward step, beta(t) = norm(em(t) +
//     alpha(t)), in two exchanges: every block pushes its slice of x =
//     em + alpha with the block's partial max (NaN-propagating); then,
//     with the max m of the 8 partial maxima, its partial tree sum of
//     exp(x - m) onto a second pair of mbarriers; every block folds the 8
//     partials in rank order, c = m + log(s), and gathers beta[j] as x[j] -
//     c from the column it holds: log_normalize's bits, with no third
//     exchange of beta itself.  A read's frozen steps (t >= length) push its
//     frozen beta with c = 0.  The backward exchanges gamma(t + 1) -
//     alpha(t + 1), once a step.
// What bounds it: the slot chain's issue and the table's L2 bytes, now over
// 8 SMs a read, and the exchange's latency once a step (K6e: twice
// forward); the times chose the forms (fwbw_stream_split).
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so every form is bit-identical to its
// plain version (ops/hmm.py fwbw_split_plain, fwbw_custom_split_plain) and
// to fwbw_plain and fwbw_custom_plain on the card.

#include "device_guard.cuh"
#include "fwbw_wave_body.cuh"

namespace {

// the cut: C = 8 blocks a read of W = 512 states (ops/hmm.py
// FWBW_SPLIT_CUTS)
constexpr int SPLIT_SHIFT = 9;
constexpr int SPLIT_CUTS = N >> SPLIT_SHIFT;

// The one-card split of one read: FORM_GENERIC (K6c) or FORM_CUSTOM (K6e),
// S states a thread, BATCH per-read log-probs.  A grid (C, B) of clusters
// of C blocks of W / S threads.
template <int FORM, int S, bool BATCH>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_split_kernel(const FwbwWaveRank* __restrict__ wave, int B, int T,
                  int deg_from, int deg_to, float log2pi, float log_n) {
  fwbw_wave_body<false, false, true, 0, false, FORM, S, BATCH>(
      wave, B, T, 0, B, SPLIT_SHIFT, 0, deg_from, deg_to, log2pi, log_n, 0,
      nullptr);
}

using SplitKernel = decltype(&fwbw_split_kernel<FORM_GENERIC, 1, false>);

// the instance of a form: K6c or K6e (custom), per-read log-probs or not,
// 1 << lg_states states a thread (1 or 2)
template <int FORM>
SplitKernel split_states(int per_read, int lg_states) {
  if (per_read)
    return lg_states ? fwbw_split_kernel<FORM, 2, true>
                     : fwbw_split_kernel<FORM, 1, true>;
  return lg_states ? fwbw_split_kernel<FORM, 2, false>
                   : fwbw_split_kernel<FORM, 1, false>;
}

SplitKernel split_kernel(int custom, int per_read, int lg_states) {
  return custom ? split_states<FORM_CUSTOM>(per_read, lg_states)
                : split_states<FORM_GENERIC>(per_read, lg_states);
}

// a block's threads, W / S
int split_threads(int lg_states) {
  return 1 << (SPLIT_SHIFT - lg_states);
}

// a block's dynamic shared memory (ops/hmm.py fwbw_split_smem): both
// parities of the read's column, the threads' em buffers, K6e's
// normalisation area
int split_smem(int lg_states, int custom) {
  return (column_floats(1, true) +
          em_floats(split_threads(lg_states), 1 << lg_states) +
          (custom ? norm_floats(1, N >> SPLIT_SHIFT) : 0)) *
         4;
}

void split_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                  int B, int lg_states, int smem) {
  cfg = {};
  cfg.blockDim = dim3(split_threads(lg_states));
  cfg.dynamicSmemBytes = smem;
  cfg.gridDim = dim3(SPLIT_CUTS, B);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT_CUTS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

}  // namespace

// The most clusters of a form (1 << lg_states states a thread, 0 or 1;
// K6e's or K6c's, per-read or not) that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int nc_fwbw_split_clusters(int lg_states, int custom,
                                      int per_read, int device,
                                      int* clusters) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *clusters = 0;
  if (lg_states < 0 || lg_states > 1) return (int)cudaErrorInvalidValue;
  const SplitKernel kernel = split_kernel(custom, per_read, lg_states);
  const int smem = split_smem(lg_states, custom);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  split_config(cfg, attr, 1, lg_states, smem);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The one-card split of K6c (custom = 0: alpha, beta, em (B, T, 4096) and
// log Pr[data] (B,)) or K6e (custom: alpha, beta, gamma, em a scratch) over
// all B reads on `stream`: a grid (C, B) of clusters of C = 8 blocks.
// `ranks` (device memory of this card) holds C FwbwWaveRank entries, entry
// c's pointers at state c W of the (deg, 4096) idx / log-probs (per_read:
// (B, deg, 4096) log-probs, read b's b deg 4096 on), the (B, 4096) model
// rows and the (B, T, 4096) outputs (K6e's gamma in `col`), every entry's
// lpd (B,) the same; 1 to 256 slots a side.  Returns the launch's error
// (a cluster that does not fit the card).
extern "C" int nc_fwbw_split(const void* ranks, int B, int T, int lg_states,
                             int deg_from, int deg_to, int custom,
                             int per_read, float log2pi, float log_n,
                             int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B < 1 || T < 1 || lg_states < 0 || lg_states > 1 || deg_from < 1 ||
      deg_from > 256 || deg_to < 1 || deg_to > 256)
    return (int)cudaErrorInvalidValue;
  const SplitKernel kernel = split_kernel(custom, per_read, lg_states);
  const int smem = split_smem(lg_states, custom);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  split_config(cfg, attr, B, lg_states, smem);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const FwbwWaveRank*>(ranks), B, T,
                           deg_from, deg_to, log2pi, log_n);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
