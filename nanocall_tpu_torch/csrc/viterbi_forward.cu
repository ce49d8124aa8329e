// K1: grouped max-plus Viterbi forward over all T events of a read, and
// K3's forward half: the same scan over one chunk of events [t0, t1), with
// alpha carried in from the chunk before.
//
// K1 replaces nanocall_tpu/ops/hmm.py _grouped_step_core +
// viterbi_forward_grouped (+ log_emission, inlined), a lax.scan body that
// XLA compiled for the TPU; the chunk form replaces
// viterbi_forward_grouped_chunk (hmm.py:389), the forward half of
// viterbi_decode_grouped_tchunk (hmm.py:614).
// Semantics, per step t >= 1 and destination state j (n = 4096, K = 6):
//   m4[c],  g4[c]  = max / first argmax over r of alpha[r*1024 + c], r < 4
//   m16[c], g16[c] = max / first argmax over r of alpha[r*256 + c],  r < 16
//   (strict > in increasing r: a NaN at r = 0 wins, any later NaN is
//   passed over)
//   v0 = stay[j] + alpha[j]; v1 = step[j] + m4[j>>2]; v2 = skip[j] + m16[j>>4]
//   best = max(v0, v1, v2) (NaN-propagating, torch.maximum); ties go to
//   the lowest from-state
//   bp = 0 | 64 + g4[j>>2] | 128 + g16[j>>4]   (group << 6 | within-group arg)
//   alpha'[j] = t < length ? best + emission(t, j) : alpha[j]
// and at t = 0, alpha = emission(0, j) - log(n).  bps are written for every
// step, padded steps included, exactly like the JAX scans: K1 writes event
// t's row at bps[t-1] (event 0 has none); a chunk writes event t's row at
// bps[t - t0], and the row of event 0, in the chunk with t0 = 0, is zeros.
// A chunk reads event t at column t - ev_t0 of its event rows: 0 when the
// rows hold the whole read (K3), the rank's first event when they hold only
// its slice of the read (K9, parallel/seqpar.py).
//
// Design (for the H100): one block per read, 1024 threads, the time loop
// inside the block, alpha in registers only.  Thread (warp w, lane
// 8q + k) owns column c = 256q + 8w + k of the 4 x 1024 view, i.e. the
// states j = 1024r + c, r < 4: its m4 / g4 is a 3-compare loop over its
// own registers, and the four m4 columns 256q + (8w + k) that make up
// m16[8w + k] (r = q + 4 r2) sit in lanes k, k+8, k+16, k+24 of one warp.
// So m16 is two xor-shuffles of (max, r), the tie to the lowest r = q +
// 4 g4, exact unless a NaN hides values behind it: a warp that holds a
// NaN in alpha (one vote) takes the serial 16-row order instead, from 16
// shuffles.  No thread waits on a serial loop.  m4 and m16 go to
// double-buffered shared arrays, so a step needs one block barrier.  The
// tie rule is one integer minimum of keys (NOKEY below), the keys' column
// parts made once per column.  The backpointer bytes of the scattered
// states are staged in double-buffered shared memory and stored after the
// next barrier as one 32-bit word per thread: 4096 contiguous bytes per
// read and step.  The shared arrays are padded so that the step's reads
// and writes are free of bank conflicts.  The 9 per-read tables live in
// registers, with -log_level_stdv and log_sd_lambda - log2pi taken once
// per read (measured on the H100: slower with the 3 transition tables in
// shared memory, or with the emissions computed before the barrier, though
// either frees the registers that the backpointer variant spills).  The
// score-only variant (kPath = false) drops the tie rule and the stores.
// The chunk form is the template instance CHUNK = true of the same kernel:
// it reads alpha from the carry at t0 > 0 and reads events t0..t1-1 of the
// (B, ev_stride) event rows in place, and runs the one step body, so
// chunked and full scans are bit-identical by construction.
//
// K1m (viterbi_forward_wave_kernel) is K1 with the 4096 states split over M
// = 2 .. 64 ranks (the production decode under nanocall_tpu/parallel/
// mesh.py:103 shard_pooled_decode_inputs, whose 'model' axis cuts the
// bank's states; parallel/statepar.py drives it).  A block is one (read,
// rank) pair and runs all T events through the same step body as K1
// (forward_body, inlined into both kernels), so it is bit-identical to K1
// by construction.  Each rank owns a (2, B, W) column buffer, its slice of
// column t at parity t & 1, and a step counter a read; a table of the M
// ranks' addresses (WaveRank) comes with the launch, and the entry copies
// what the exchange needs into shared memory (Exchange), so that none of
// it occupies a register through the time loop.  A thread steps only the
// states of its four 1024 r + c that lie in the rank's slice (W / 1024 of
// them, a template constant: 2 at W = 2048, else 1, and at W < 1024 only
// the threads whose c lies in the slice), and holds only their tables
// and alpha: with K1's 36 table registers cut to 18 or 9 the loop spills
// nothing under the 64 registers of 1024 threads.  Each step it reads the
// column of event t - 1 at all four of its states in place from the ranks'
// buffers (state j's step and skip predecessors 1024 r + (j >> 2) and 256
// r + (j >> 4) lie in every slice), takes K1's column maxima and tie keys
// over it, and steps its own states.  A step: a block barrier (its slice
// of column t - 1 is stored), thread 0 publishes t by a release store,
// warp 0 polls the peers' counters of the read with acquire loads until
// each reaches t, a block barrier, then the column is read by relaxed
// (L1-bypassing) loads, never the non-coherent path.  The double buffer
// needs no second signal: a rank overwrites parity p at step t + 2 only
// after its peers published t + 2, which each did after its loads of
// column t.  One launch runs a wave of reads for the ranks of a data row on
// one card, as one cooperative grid: every block of a wave must be
// resident at once, since a block waits on its peers, so the host cuts the
// reads into waves of at most the card's resident blocks
// (statepar.plan_waves; one block an SM: 132 on an H100), and a grid too
// large for the card fails to launch.  A card's waves go on one stream in
// order.  Across cards the peers' slices and counters are read over peer
// access and the instance takes system scope (SYS) for its loads, release
// and acquire; on one card, gpu scope.  A poll that waits longer than the
// launch's timeout records (t, read, rank, peer) in a host-mapped word and
// traps: a fault in the exchange fails the decode, never hangs it.  What
// bounds K1m: K1's step issue for W states plus the exchange's latency a
// step (two block barriers, a release and an acquire round trip through
// L2, the 16 KB column of a read from L2).
//
// What bounds K1: issue on the read's one SM: about 107 instructions per
// state and step without backpointers, 148 with (chip_smoke.py's census of
// the loop; the emission's 3 IEEE divisions are about 40 of them).  Only B
// of the 132 SMs work when B < 132.  A chunk of 8192 events bounds one
// launch's length (a 100k-event read is 13 launches, not one); the bytes
// and operations are those of the full scan.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to the
// plain version in nanocall_tpu_torch/ops/hmm.py on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "device_guard.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// Padded slots of the m4 (and staged bp word) and m16 arrays, free of bank
// conflicts for the step's reads and writes (tests/test_torch_kernel_forms.py)
__device__ __forceinline__ int p4(int i) { return i + 2 * (i >> 6); }
__device__ __forceinline__ int p16(int i) { return i + (i >> 4); }
constexpr int P4N = N4 + 2 * (N4 >> 6);
constexpr int P16N = N16 + (N16 >> 4);
// state j = 1024 r + c reads m4 slot p4(j >> 2) = p4(c >> 2) + r * R4 and
// m16 slot p16(j >> 4) = p16(c >> 4) + r * R16, and stages its bp byte at
// 4 p4(j >> 2) + (j & 3) = 4 p4(c >> 2) + (c & 3) + r * 4 R4
constexpr int R4 = N16 + 2 * (N16 >> 6);
constexpr int R16 = 64 + (64 >> 4);

// The tie rule as one integer minimum: a candidate's key is
// (from-state << 8) | its bp code (stay 0, step 64 + g4, skip 128 + g16),
// or NOKEY where its value is not the best.  Keys order by from-state, and
// on equal from-states by code, which is the plain version's order of
// checks (stay, then step, then skip); the least key's low byte is the bp,
// 0 when no value is the best (a NaN best).
constexpr int NOKEY = 0x7fffff00;

// a column's max and the high part of its candidates' keys: (g << 18 |
// 64 + g) for m4, (g << 16 | 128 + g) for m16; a state adds its own
// (from-state low bits) << 8
struct __align__(8) MaxKey {
  float m;
  int key;
};

// The ranks of a K1m launch: one entry a rank of the data row (the M
// entries, then the ranks this launch runs, as int64), in device memory of
// the launch's card; every pointer on the rank's own card.
struct WaveRank {
  const float* ev_mean;  // (B, T) events and (B,) lengths, the row's
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  // (B, W): stay, step, skip, level_mean, level_stdv, log_level_stdv,
  // sd_mean, sd_lambda, log_sd_lambda of the rank's states
  const float* tab[9];
  float* col;        // (2, B, W): its slice of column t at parity t & 1
  uint8_t* bps;      // (T - 1, B, W), or nullptr (score-only)
  int32_t* flags;    // (B,): t once its slice of column t - 1 is stored
};

// The exchange's operations, Exchange and wait_ranks: wave_exchange.cuh
// (shared with K6am).

// The body of K1, K3's chunk and K1m, inlined into each kernel.
// CHUNK = false: events [0, t1) with t0 = 0; CHUNK = true: one chunk.
// kPath: write backpointers.  OWN: the states a thread steps, 1024 r + c
// for r = r0 .. r0 + OWN - 1: 4 (K1, K3: all, r0 = 0), or K1m's (SLICE)
// block of read b for the rank that holds the states [slice_lo, slice_lo
// + W), W = 1 << slice_shift: 2 at W = 2048, else 1 (at W < 1024 only
// where c lies in the slice), r0 = slice_lo >> 10.  A K1m block holds the
// tables and the alpha of its states only, and reads the column's four
// states a thread from the ranks' buffers (its own among them) each step;
// its tables, bps and final column are the rank's (B, W) slices, and the
// exchange `x` (filled by the caller, behind a block barrier) names the
// ranks' columns and counters.  SYS: the exchange at system scope.
template <bool CHUNK, bool kPath, int OWN, bool SYS>
__device__ __forceinline__ void forward_body(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int ev_stride, int ev_t0,
    int t0, int t1, const float* __restrict__ carry_alpha,
    const float* __restrict__ stay, const float* __restrict__ step,
    const float* __restrict__ skip, const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ final_alpha, uint8_t* __restrict__ bps, int b,
    int slice_lo, int slice_shift, const Exchange* x) {
  constexpr bool SLICE = OWN < 4;
  __shared__ MaxKey s4[2][P4N];
  __shared__ MaxKey s16[2][P16N];
  __shared__ uint32_t stage[kPath ? 2 : 1][kPath ? P4N : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, k = lane & 7;
  const int c16 = warp * 8 + k;  // the thread's column of the 16 x 256 view
  const int c = q * N16 + c16;   // and of the 4 x 1024 view
  const size_t rowb = (size_t)b * N;
  const int W = SLICE ? 1 << slice_shift : N;
  const int r0 = SLICE ? slice_lo >> 10 : 0;
  // the thread steps its states (none where a slice of W < 1024 misses c)
  const bool mine =
      !SLICE || W >= N4 || (unsigned)(c - (slice_lo & (N4 - 1))) < (unsigned)W;
  // state 1024 r + c's index in the rank's (B, W) rows, or in (B, N)
  auto at = [&](int r) {
    return SLICE ? (size_t)b * W + (r * N4 + c - slice_lo)
                 : rowb + r * N4 + c;
  };

  float r_stay[OWN], r_step[OWN], r_skip[OWN], r_lm[OWN], r_ls[OWN],
      r_nlls[OWN], r_sm[OWN], r_slam[OWN], r_c1[OWN];
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    if (!mine) {
      r_stay[i] = r_step[i] = r_skip[i] = r_lm[i] = r_ls[i] = r_nlls[i] =
          r_sm[i] = r_slam[i] = r_c1[i] = 0.0f;
      continue;
    }
    const size_t j = at(r0 + i);
    r_stay[i] = stay[j];
    r_step[i] = step[j];
    r_skip[i] = skip[j];
    r_lm[i] = level_mean[j];
    r_ls[i] = level_stdv[j];
    r_nlls[i] = -log_level_stdv[j];
    r_sm[i] = sd_mean[j];
    r_slam[i] = sd_lambda[j];
    r_c1[i] = log_sd_lambda[j] - log2pi;
  }
  // event t of read b: column t - ev_t0 of its row
  const float* evm = ev_mean + (size_t)b * ev_stride - ev_t0;
  const float* evs = ev_stdv + (size_t)b * ev_stride - ev_t0;
  const float* evl = ev_log_stdv + (size_t)b * ev_stride - ev_t0;
  const int len = length[b];
  // bp row of event t: bps[t - row0]
  const int row0 = CHUNK ? t0 : 1;

  // ao: the alpha of the thread's states; a: the column the step reads at
  // its four states 1024 r + c (K1: ao itself)
  float ao[OWN], a[4];
  // SLICE: the rank's slice of column tc (parity tc & 1) at its states
  auto store_column = [&](int tc) {
    float* dst = x->col[x->rank] + (size_t)(tc & 1) * B * W;
    if (mine) {
#pragma unroll
      for (int i = 0; i < OWN; ++i) dst[(r0 + i) * N4 + c - slice_lo] = ao[i];
    }
  };
  int t = t0;
  if (t0 == 0) {
    const float xe = evm[0], y = evs[0], ly3 = 3.0f * evl[0];
#pragma unroll
    for (int i = 0; i < OWN; ++i)
      ao[i] = mine ? emission_pre(xe, y, ly3, r_lm[i], r_ls[i], r_nlls[i],
                                  r_sm[i], r_slam[i], r_c1[i], log2pi) -
                         log_n
                   : 0.0f;
    if (CHUNK && kPath) reinterpret_cast<uint32_t*>(bps + rowb)[tid] = 0u;
    if (SLICE) store_column(0);
    t = 1;
  } else {
#pragma unroll
    for (int i = 0; i < OWN; ++i) ao[i] = carry_alpha[rowb + i * N4 + c];
  }

  // the staged bp bytes of step `ts` (parity `par`) to its row
  // (SLICE: the words of the rank's states, W / 4 of them)
  auto store_stage = [&](int ts, int par) {
    if (SLICE) {
      if (tid < (W >> 2))
        reinterpret_cast<uint32_t*>(bps + ((size_t)(ts - row0) * B + b) *
                                              W)[tid] =
            stage[par][p4((slice_lo >> 2) + tid)];
    } else {
      reinterpret_cast<uint32_t*>(bps + ((size_t)(ts - row0) * B + b) * N)
          [tid] = stage[par][p4(tid)];
    }
  };

  const int o4 = p4(c >> 2), o16 = p16(c >> 4), ost = 4 * o4 + (c & 3);
  const int w4 = p4(c), w16 = p16(c16);
  // the key low parts of state 1024 r + c (+ r << 18, r << 16, r << 14):
  // its own, its m4 column's (j >> 2) and its m16 column's (j >> 4)
  const int kj = c << 8, kq = (c >> 2) << 8, kh = (c >> 4) << 8;
  const int first = t;
  float xn = 0.0f, yn = 0.0f, lyn = 0.0f;
  if (t < t1) {
    xn = evm[t];
    yn = evs[t];
    lyn = evl[t];
  }
  int par = 0;
  for (; t < t1; ++t) {
    if (SLICE) {
      // publish column t - 1 (every thread's slice stored), wait for the
      // peers' slices of it, then read the column in place
      __syncthreads();
      if (tid == 0) st_flag<SYS>(x->flag[x->rank], t);
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(*x, x->flag, t, lane);
      }
      __syncthreads();
      const size_t off = (size_t)((t - 1) & 1) * B * W;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = r * N4 + c;
        a[r] = ld_column<SYS>(x->col[j >> slice_shift] + off + (j & (W - 1)));
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ao[r % OWN];
    }
    const float xe = xn, y = yn, ly3 = 3.0f * lyn;
    if (t + 1 < t1) {
      xn = evm[t + 1];
      yn = evs[t + 1];
      lyn = evl[t + 1];
    }
    // column maxima with first-occurrence argmax (strict > in increasing r)
    float m = a[0];
    int g = 0;
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      if (a[r] > m) {
        m = a[r];
        g = r;
      }
    }
    const bool nan = __any_sync(FULL, (a[0] != a[0]) | (a[1] != a[1]) |
                                          (a[2] != a[2]) | (a[3] != a[3]));
    float M;
    int R;
    if (!nan) {
      // m16 from the four m4 columns: the max, the lowest r = q + 4 g4
      M = m;
      R = q + 4 * g;
#pragma unroll
      for (int off = 8; off <= 16; off <<= 1) {
        const float oM = __shfl_xor_sync(FULL, M, off);
        const int oR = __shfl_xor_sync(FULL, R, off);
        if (oM > M || (oM == M && oR < R)) {
          M = oM;
          R = oR;
        }
      }
    } else {
      // the serial order: row r = q' + 4 r2 is a[r2] of lane 8 q' + k
      M = __shfl_sync(FULL, a[0], k);
      R = 0;
#pragma unroll
      for (int r = 1; r < 16; ++r) {
        const float v = __shfl_sync(FULL, a[r >> 2], (r & 3) * 8 + k);
        if (v > M) {
          M = v;
          R = r;
        }
      }
    }
    s4[par][w4] = MaxKey{m, (g << 18) | (64 + g)};
    if (q == 0) s16[par][w16] = MaxKey{M, (R << 16) | (128 + R)};
    __syncthreads();
    if (kPath && t > first) store_stage(t - 1, par ^ 1);

    const bool active = t < len;
    const MaxKey* r4 = s4[par] + o4;
    const MaxKey* r16 = s16[par] + o16;
    uint8_t* st =
        kPath ? reinterpret_cast<uint8_t*>(stage[par]) + ost : nullptr;
    if (mine) {
#pragma unroll
      for (int i = 0; i < OWN; ++i) {
        const int r = r0 + i;
        const MaxKey v4 = r4[r * R4];
        const MaxKey v16 = r16[r * R16];
        const float v0 = r_stay[i] + ao[i];
        const float v1 = r_step[i] + v4.m;
        const float v2 = r_skip[i] + v16.m;
        const float best = amax(amax(v0, v1), v2);
        if (kPath) {
          const int k0 = v0 == best ? kj + (r << 18) : NOKEY;
          const int k1 = v1 == best ? v4.key + kq + (r << 16) : NOKEY;
          const int k2 = v2 == best ? v16.key + kh + (r << 14) : NOKEY;
          st[r * 4 * R4] = (uint8_t)min(min(k0, k1), k2);
        }
        const float em = emission_pre(xe, y, ly3, r_lm[i], r_ls[i],
                                      r_nlls[i], r_sm[i], r_slam[i],
                                      r_c1[i], log2pi);
        if (active) ao[i] = best + em;
      }
    }
    if (SLICE) store_column(t);
    par ^= 1;
  }
  if (kPath && t1 > first) {
    __syncthreads();
    store_stage(t1 - 1, par ^ 1);
  }
  if (!SLICE) {
#pragma unroll
    for (int i = 0; i < OWN; ++i) final_alpha[at(i)] = ao[i];
  }
}

// K1 (CHUNK = false: events [0, t1), t0 = 0) and K3's forward chunk
// (CHUNK = true), one block a read.
template <bool CHUNK, bool kPath>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_forward_kernel(const float* __restrict__ ev_mean,
                       const float* __restrict__ ev_stdv,
                       const float* __restrict__ ev_log_stdv,
                       const int32_t* __restrict__ length, int B,
                       int ev_stride, int ev_t0, int t0, int t1,
                       const float* __restrict__ carry_alpha,
                       const float* __restrict__ stay,
                       const float* __restrict__ step,
                       const float* __restrict__ skip,
                       const float* __restrict__ level_mean,
                       const float* __restrict__ level_stdv,
                       const float* __restrict__ log_level_stdv,
                       const float* __restrict__ sd_mean,
                       const float* __restrict__ sd_lambda,
                       const float* __restrict__ log_sd_lambda, float log2pi,
                       float log_n, float* __restrict__ final_alpha,
                       uint8_t* __restrict__ bps) {
  forward_body<CHUNK, kPath, 4, false>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, ev_stride, ev_t0, t0, t1,
      carry_alpha, stay, step, skip, level_mean, level_stdv, log_level_stdv,
      sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps,
      blockIdx.x, 0, 12, nullptr);
}

// K1m: events [0, T) of read wave_lo + blockIdx.x for the rank named by
// entry blockIdx.y of the launch's ranks (after the M = N >> slice_shift
// entries of `wave`), which holds the states [rank W, (rank + 1) W), W =
// 1 << slice_shift: OWN = 2 at W = 2048, 1 at W <= 1024.
template <bool kPath, bool SYS, int OWN>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_forward_wave_kernel(const WaveRank* __restrict__ wave, int B, int T,
                            int wave_lo, int slice_shift, float log2pi,
                            float log_n, long long timeout_ns,
                            int32_t* timed_out) {
  __shared__ Exchange x;
  const int ranks = N >> slice_shift;
  const int rank =
      (int)reinterpret_cast<const long long*>(wave + ranks)[blockIdx.y];
  const int b = wave_lo + blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < ranks) {
    x.col[tid] = wave[tid].col + (size_t)b * (1 << slice_shift);
    x.flag[tid] = wave[tid].flags + b;
  }
  if (tid == 0) {
    x.timed_out = timed_out;
    x.timeout_ns = timeout_ns;
    x.ranks = ranks;
    x.rank = rank;
    x.read = b;
  }
  __syncthreads();
  const WaveRank& e = wave[rank];
  forward_body<false, kPath, OWN, SYS>(
      e.ev_mean, e.ev_stdv, e.ev_log_stdv, e.length, B, T, 0, 0, T, nullptr,
      e.tab[0], e.tab[1], e.tab[2], e.tab[3], e.tab[4], e.tab[5], e.tab[6],
      e.tab[7], e.tab[8], log2pi, log_n, nullptr, e.bps, b,
      rank << slice_shift, slice_shift, &x);
}

}  // namespace

// Plain C entries for ctypes.  bps == nullptr runs the score-only variant (no
// backpointer stores).  Each returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* stay, const float* step,
    const float* skip, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    auto kernel = bps != nullptr ? viterbi_forward_kernel<false, true>
                                 : viterbi_forward_kernel<false, false>;
    kernel<<<B, nc::THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, 0, 0, T, nullptr, stay,
        step, skip, level_mean, level_stdv, log_level_stdv, sd_mean,
        sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps);
  }
  return (int)cudaGetLastError();
}

// One chunk, events [t0, t1) of (B, ev_stride) event rows whose column 0
// holds event ev_t0 (ev_t0 <= t0); carry_alpha (B, 4096) is alpha at event
// t0 - 1 (unread when t0 == 0); bps (not nullptr) holds t1 - t0 rows of
// (B, 4096).
extern "C" int nc_viterbi_forward_chunk(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int ev_stride, int ev_t0, int t0, int t1,
    const float* carry_alpha, const float* stay, const float* step,
    const float* skip, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (bps == nullptr) return (int)cudaErrorInvalidValue;
  if (B > 0 && t1 > t0) {
    viterbi_forward_kernel<true, true>
        <<<B, nc::THREADS, 0, (cudaStream_t)stream>>>(
            ev_mean, ev_stdv, ev_log_stdv, length, B, ev_stride, ev_t0, t0,
            t1, carry_alpha, stay, step, skip, level_mean, level_stdv,
            log_level_stdv, sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n,
            final_alpha, bps);
  }
  return (int)cudaGetLastError();
}

namespace {

using WaveKernel = decltype(&viterbi_forward_wave_kernel<true, false, 2>);

// K1m's instance: with backpointers or not, gpu or system scope, two
// states a thread (W = 2048) or one
template <int OWN>
WaveKernel wave_kernel(int with_path, int sys) {
  if (with_path)
    return sys ? viterbi_forward_wave_kernel<true, true, OWN>
               : viterbi_forward_wave_kernel<true, false, OWN>;
  return sys ? viterbi_forward_wave_kernel<false, true, OWN>
             : viterbi_forward_wave_kernel<false, false, OWN>;
}

WaveKernel wave_kernel(int with_path, int sys, int slice_shift) {
  return slice_shift == 11 ? wave_kernel<2>(with_path, sys)
                           : wave_kernel<1>(with_path, sys);
}

}  // namespace

// K1m's wave: the most blocks of its instances (with_path, sys, of any
// slice width) that one card holds at once (blocks an SM at 1024 threads
// times the SMs) into *blocks; an error where the card has no cooperative
// launch.
extern "C" int nc_viterbi_forward_wave_resident(int with_path, int sys,
                                                int device, int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int coop = 0, sms = 0, per_sm = 0, per_sm_1 = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wave_kernel(with_path, sys, 11), nc::THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_1, wave_kernel(with_path, sys, 10), nc::THREADS, 0);
  *blocks = (per_sm < per_sm_1 ? per_sm : per_sm_1) * sms;
  return (int)err;
}

// K1m: events 0 .. T - 1 of the reads [lo, lo + n_reads) for n_local
// ranks of a data row, one cooperative grid (n_reads, n_local) on
// `stream`.  `ranks` (device memory of this card) holds the row's M = 4096
// >> slice_shift WaveRank entries, then the n_local ranks to run as int64;
// the entries' (B, W) tables, (2, B, W) columns, (T - 1, B, W) bps (or
// nullptr: score-only, with_path = 0) and (B,) counters (zero before the
// first wave) lie on their ranks' cards, reachable from this one (peer
// access).  sys: the exchange at system scope (ranks of the row on other
// cards).  timed_out: 4 int32 of host-mapped memory, where a block that
// waits on a peer longer than timeout_ns records (t, read, rank, peer)
// before it traps.  Returns the launch's error: a grid larger than the card
// holds at once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_viterbi_forward_wave(const void* ranks, int n_local, int B,
                                       int T, int lo, int n_reads,
                                       int slice_shift, int with_path,
                                       int sys, float log2pi, float log_n,
                                       long long timeout_ns,
                                       int32_t* timed_out, int device,
                                       void* stream) {
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
      &cfg, wave_kernel(with_path, sys, slice_shift),
      static_cast<const WaveRank*>(ranks),
      B, T, lo, slice_shift, log2pi, log_n, timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
