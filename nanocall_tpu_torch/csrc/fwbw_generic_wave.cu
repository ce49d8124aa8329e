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
//     step (the max, then the sum), as the one-card split (fwbw_split.cu)
//     reads its cut.
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
// The body (fwbw_wave_body.cuh, FORM_WAVE) is shared with the one-card
// split of the streaming K6c and K6e (fwbw_split.cu), which runs it over
// the (B, T, 4096) outputs in place.
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
#include "fwbw_wave_body.cuh"

namespace {

// K6cm: both passes of R = 1 << lg_reads reads for one rank (the body's
// FORM_WAVE, fwbw_wave_body.cuh).
template <bool SYS, bool RESIDENT, bool CLUSTER, int DEG, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
fwbw_generic_wave_kernel(const FwbwWaveRank* __restrict__ wave, int B,
                         int T, int wave_lo, int wave_hi, int slice_shift,
                         int lg_reads, int deg_from, int deg_to,
                         float log2pi, float log_n, long long timeout_ns,
                         int32_t* timed_out) {
  fwbw_wave_body<SYS, RESIDENT, CLUSTER, DEG, SPLIT, FORM_WAVE, 4, false>(
      wave, B, T, wave_lo, wave_hi, slice_shift, lg_reads, deg_from, deg_to,
      log2pi, log_n, timeout_ns, timed_out);
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
