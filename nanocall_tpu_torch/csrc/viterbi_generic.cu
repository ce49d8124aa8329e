// K6a: generic max-plus Viterbi forward under a loaded transition table,
// in two kernels chosen by the table (the streaming and the resident one),
// K6b: its traceback into a full state path, and K6am: K6a with the states
// split over a mesh's ranks.
//
// K6a replaces nanocall_tpu/ops/hmm.py viterbi_forward (+ log_emission,
// inlined), a lax.scan body that XLA compiled for the TPU.  Per step
// t = 1..T-1 and destination state j (n = 4096), over the deg slots of the
// (deg, n) tables from_idx / from_logp:
//   v[k]  = from_logp[k, j] + alpha[from_idx[k, j]]
//   best  = max over k of v[k]                      (NaN-propagating)
//   bp    = the slot of the lowest from_idx[k, j] among the k with
//           v[k] == best, the lowest such k on equal from-states; 0 when
//           best is NaN (jnp.argmin over where(v == best, from, BIG))
//   alpha'[j] = t < length ? best + emission(t, j) : alpha[j]
// with alpha0 = emission(0, j) - log(n).  bps (T-1, B, n) uint8 hold slot
// ids, written for every t < T as the JAX scan writes them.
//
// K6b replaces nanocall_tpu/ops/hmm.py viterbi_traceback.  Per read b:
//   end_state = first argmax of final_alpha[b] (a NaN counts as the
//   largest, as torch.argmax), logp = its max;
//   for t = T-1 .. 1:
//     s_eff   = t == length-1 ? end_state : s
//     k       = bps[t-1, b, s_eff]
//     s       = t <= length-1 ? from_idx[k, s_eff] : s_eff
//     path[t] = s_eff
//   path[0] = s.
//
// Both forward kernels: one block per read, 1024 threads x 4 contiguous
// states, the time loop inside the block, as K1; alpha lives in shared
// memory, since any state may be any state's predecessor, and each thread
// keeps its own 4 states in registers.  They differ in where the slot
// table lives.
//
// The streaming kernel (viterbi_generic_forward_kernel) reads the int32 /
// float32 tables (21 x 4096 x 8 B = 688 KB for the r73 tables) from L2 at
// every step: one int4 and one float4 per slot and thread, coalesced over
// j; two barriers per step separate the gathers from the update.  It takes
// any table of 1..256 slots.
//
// The resident kernel (viterbi_resident_forward_kernel) holds the whole
// table in shared memory.  A table has that layout (ops/hmm.py
// pack_slots, one codebook a slot) when every slot holds at most 16
// distinct float32 bit patterns and the from-states fit 12 bits
// (n = 4096): entry [k, j] is 16
// bits, the from-state in the low 12 and a code into slot k's codebook of
// 16 float32 values in the high 4.  At deg slots the block holds 2 deg n B
// of table, 64 deg B of codebooks and two 16 KiB alpha buffers: at most
// 24 slots fit the 227 KB of one block (168 KiB + 1.3 KiB at the r73
// tables' 21).  The prologue copies table and codebooks with cp.async.bulk
// into shared memory, completing on an mbarrier, while the threads compute
// the first emission; no table byte crosses L2 after it.  A step reads per
// slot one 8-byte word of a thread's 4 entries, cuts them into byte
// offsets into alpha and the codebook, and gathers both.  alpha is
// double-buffered, so a step needs one barrier, which also reduces whether
// a new alpha is NaN or +inf: only then (or when the codebooks hold NaN or
// +inf) can a v be NaN, and only then does the step track NaN (max_slots).
//
// What bounds the resident kernel: issue, and the 16-lane integer and
// compare pipe, on the read's one SM.  Per slot and state its loop issues
// about 17 instructions with backpointers (2 shared loads and the 8-byte
// word's share, 4 to cut the entry, the add, 7 of max and tie logic) and
// about 10 without, 9 and 6 of them on that pipe; 8 warps per scheduler
// (1024 threads a block, one block an SM at 206 KB of shared memory) hide
// most of the loads' latency.  Only B of the 132 SMs work when B < 132.
//
// Both forward kernels evaluate the slots in slot order, with take_slot's
// NaN, max and tie rules (max_slots restates them in fewer operations), so
// they agree bit for bit.  The traceback reduces the final alpha with all
// threads and walks the read with one, as K2.
//
// Per-read tables (ops/hmm.py make_trans_ops_batch, JAX's
// make_trans_ops_batch): each forward kernel has a second instance
// (*_batch_kernel) whose block b takes its read's own (deg, N) log-probs
// (streaming) or packed layout and codebooks (resident), at b deg N (b deg
// CODES) from the start of the (B, ...) tables; from_idx is every read's.
// The bodies are shared and inlined, so the one-table instances compile
// as before.
//
// K6am (viterbi_generic_wave_kernel) is K6a with the 4096 states split
// over M = 2 .. 64 ranks (the generic decode under nanocall_tpu/parallel/
// mesh.py:75 shard_decode_inputs; parallel/statepar.py drives it).  A
// block is one (read, rank) pair of a cooperative grid and runs all T
// events, with K1m's exchange (wave_exchange.cuh): each step it publishes
// its counter, waits for the peers', then loads the whole column of event
// t - 1 from the ranks' double-buffered slices into shared memory (a
// loaded table's from-states lie anywhere, so every state may be read),
// and the threads that own its W states (4 a thread, W / 4 threads) run
// K6a's slot loop on that column: the resident form (take its rank's
// (deg, W) cut of the packed layout and the codebooks into shared memory
// once, by cp.async.bulk) max_slots, whose NaN-tracking path is chosen by
// a block vote over the whole loaded column (every peer's slice, as K6a's
// vote covers its whole alpha), the streaming form (the (deg, W) int32 /
// float32 cut from L2 every step) take_slot.  So every rank computes
// K6a's bits for its states, NaN bits included.  What bounds it: K6a's
// slot loop for W states on W / 4 threads of the read's SM, plus the
// exchange's latency a step (three block barriers, a release and an
// acquire round trip through L2, the 16 KB column of a read from L2).
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernels are bit-identical to
// viterbi_forward_plain / viterbi_traceback_plain in
// nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"
#include "device_guard.cuh"
#include "wave_exchange.cuh"

namespace {

using namespace nc;

// codes per slot of the resident layout
constexpr int CODES = 16;

// The scaled model's 6 tables at a thread's 4 states.
struct StateRows {
  float lm[4], ls[4], lls[4], sm[4], slam[4], lsl[4];

  __device__ StateRows(const float* level_mean, const float* level_stdv,
                       const float* log_level_stdv, const float* sd_mean,
                       const float* sd_lambda, const float* log_sd_lambda,
                       size_t row) {
    unpack4(lm, load4(level_mean + row));
    unpack4(ls, load4(level_stdv + row));
    unpack4(lls, load4(log_level_stdv + row));
    unpack4(sm, load4(sd_mean + row));
    unpack4(slam, load4(sd_lambda + row));
    unpack4(lsl, load4(log_sd_lambda + row));
  }

  __device__ __forceinline__ float em(int i, float x, float y, float ly,
                                      float log2pi) const {
    return emission(x, y, ly, lm[i], ls[i], lls[i], sm[i], slam[i], lsl[i],
                    log2pi);
  }
};

// Slot k's value v from state id, folded into one state's running max:
// NaN-propagating, the lowest from-state (then the lowest slot) on ties.
template <bool kPath>
__device__ __forceinline__ void take_slot(int k, float v, int id,
                                          float& best, int& bfrom,
                                          int& bslot) {
  if (k == 0) {
    best = v;
    bfrom = id;
    bslot = 0;
  } else if (v > best || (v != v && best == best)) {
    best = v;
    bfrom = id;
    bslot = k;
  } else if (kPath && v == best && id < bfrom) {
    bfrom = id;
    bslot = k;
  }
}

// A resident table word: 4 entries (from-state in bits 0-11, code in bits
// 12-15 of each 16), as byte offsets into alpha and into the slot's
// codebook.
struct Entries {
  uint32_t from[4], code[4];

  __device__ __forceinline__ explicit Entries(const uint2 w) {
    from[0] = (w.x << 2) & 0x3ffc;
    from[1] = (w.x >> 14) & 0x3ffc;
    from[2] = (w.y << 2) & 0x3ffc;
    from[3] = (w.y >> 14) & 0x3ffc;
    code[0] = (w.x >> 10) & 0x3c;
    code[1] = (w.x >> 26) & 0x3c;
    code[2] = (w.y >> 10) & 0x3c;
    code[3] = (w.y >> 26) & 0x3c;
  }
};

__device__ __forceinline__ float at_byte(const float* base, uint32_t ofs) {
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(base) + ofs);
}

// The resident kernel's slot loop at one step, for the thread's 4 states:
// best and (kPath) the slot of take_slot, in fewer operations, to the same
// bits.  The from-state comes as its byte offset into alpha, which orders
// as the state does.  kNan: a v may be NaN.  Then a NaN only sets a flag,
// and after the last slot a flagged state's best is NaN (any NaN: best +
// emission then gives the card's one NaN, as the sum of take_slot's NaN
// does) and its slot 0, as take_slot ends.  Without kNan (no codebook
// value and no alpha is NaN or +inf, so no v is NaN) the flags go.
template <bool kPath, bool kNan>
__device__ __forceinline__ void max_slots(const uint2* words,
                                          const float* book, const float* cur,
                                          int deg, int stride4,
                                          float (&best)[4],
                                          int (&bslot)[4]) {
  uint32_t bofs[4];
  bool nan[4];
  {
    const Entries e(words[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = at_byte(book, e.code[i]) + at_byte(cur, e.from[i]);
      bofs[i] = e.from[i];
      bslot[i] = 0;
      nan[i] = kNan && best[i] != best[i];
    }
  }
#pragma unroll 3
  for (int k = 1; k < deg; ++k) {
    const Entries e(words[k * stride4]);
    const float* bk = book + k * CODES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = at_byte(bk, e.code[i]) + at_byte(cur, e.from[i]);
      if (kPath) {
        const bool take =
            v > best[i] || (v == best[i] && e.from[i] < bofs[i]);
        bofs[i] = take ? e.from[i] : bofs[i];
        bslot[i] = take ? k : bslot[i];
      }
      best[i] = v > best[i] ? v : best[i];
      if (kNan) nan[i] = nan[i] || v != v;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (kNan && nan[i]) best[i] = __int_as_float(0x7fffffff);
}

// The end of step t for a thread's 4 states: alpha' into a (unchanged past
// the read's length), and with kPath the 4 slot ids into bps, whose rows
// are `width` states wide (N; K6am: the rank's W).
template <bool kPath>
__device__ __forceinline__ void finish_step(
    const StateRows& rows, const float* evm, const float* evs,
    const float* evl, int t, int len, float log2pi, const float (&best)[4],
    const int (&bslot)[4], float (&a)[4], uint8_t* bps, int B, int b,
    int tid, int width) {
  const float x = evm[t], y = evs[t], ly = evl[t];
  const bool active = t < len;
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int slot = best[i] != best[i] ? 0 : bslot[i];
    packed |= (uint32_t)slot << (8 * i);
    const float em = rows.em(i, x, y, ly, log2pi);
    if (active) a[i] = best[i] + em;
  }
  if (kPath) {
    reinterpret_cast<uint32_t*>(bps + ((size_t)(t - 1) * B + b) * width)
        [tid] = packed;
  }
}

// K6a's streaming body, inlined into its two kernels.  kBatch: per-read
// slot log-probs, from_logp (B, deg, N), of which read b takes its own
// (deg, N) table; from_idx (deg, N) is every read's.
template <bool kPath, bool kBatch>
__device__ __forceinline__ void generic_forward_body(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg,
    const int32_t* __restrict__ from_idx,
    const float* __restrict__ from_logp,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ final_alpha, uint8_t* __restrict__ bps) {
  __shared__ float alpha[N];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N + 4 * tid;

  const StateRows rows(level_mean, level_stdv, log_level_stdv, sd_mean,
                       sd_lambda, log_sd_lambda, row);
  const int4* fidx = reinterpret_cast<const int4*>(from_idx) + tid;
  const float4* flp =
      reinterpret_cast<const float4*>(from_logp) + tid +
      (kBatch ? (size_t)b * deg * N4 : 0);
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];

  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = rows.em(i, evm[0], evs[0], evl[0], log2pi) - log_n;
    alpha[4 * tid + i] = a[i];
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    float best[4];
    int bfrom[4], bslot[4];
    for (int k = 0; k < deg; ++k) {
      const int4 iv = __ldg(fidx + (size_t)k * N4);
      const float4 lv = __ldg(flp + (size_t)k * N4);
      const int id[4] = {iv.x, iv.y, iv.z, iv.w};
      const float lp[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        take_slot<kPath>(k, lp[i] + alpha[id[i]], id[i], best[i], bfrom[i],
                         bslot[i]);
    }
    finish_step<kPath>(rows, evm, evs, evl, t, len, log2pi, best, bslot, a,
                       bps, B, b, tid, N);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[4 * tid + i] = a[i];
    __syncthreads();
  }
  store4(final_alpha + row, a);
}

// The streaming K6a under one (deg, N) table for every read.
template <bool kPath>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_generic_forward_kernel(const float* __restrict__ ev_mean,
                               const float* __restrict__ ev_stdv,
                               const float* __restrict__ ev_log_stdv,
                               const int32_t* __restrict__ length, int B,
                               int T, int deg,
                               const int32_t* __restrict__ from_idx,
                               const float* __restrict__ from_logp,
                               const float* __restrict__ level_mean,
                               const float* __restrict__ level_stdv,
                               const float* __restrict__ log_level_stdv,
                               const float* __restrict__ sd_mean,
                               const float* __restrict__ sd_lambda,
                               const float* __restrict__ log_sd_lambda,
                               float log2pi, float log_n,
                               float* __restrict__ final_alpha,
                               uint8_t* __restrict__ bps) {
  generic_forward_body<kPath, false>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, from_idx, from_logp,
      level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
      log_sd_lambda, log2pi, log_n, final_alpha, bps);
}

// The streaming K6a under per-read log-probs (B, deg, N).
template <bool kPath>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_generic_forward_batch_kernel(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg,
    const int32_t* __restrict__ from_idx,
    const float* __restrict__ from_logp,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ final_alpha, uint8_t* __restrict__ bps) {
  generic_forward_body<kPath, true>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, from_idx, from_logp,
      level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
      log_sd_lambda, log2pi, log_n, final_alpha, bps);
}

// K6a's resident body, inlined into its two kernels.  Dynamic shared
// memory: alpha (2 x N float32, double-buffered), the codebooks (deg x
// CODES float32), the packed table (deg x N uint16).  kBatch: per-read
// layouts, packed (B, deg, N) and codebook (B, deg, CODES), of which read
// b copies its own.
template <bool kPath, bool kBatch>
__device__ __forceinline__ void resident_forward_body(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg,
    const uint16_t* __restrict__ packed, const float* __restrict__ codebook,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ final_alpha, uint8_t* __restrict__ bps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  float* alpha = reinterpret_cast<float*>(smem);
  float* book = alpha + 2 * N;
  uint16_t* table = reinterpret_cast<uint16_t*>(book + deg * CODES);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N + 4 * tid;
  const uint32_t bar_addr = smem_addr(&bar);

  if (tid == 0) {
    const uint32_t book_bytes = deg * CODES * 4, slot_bytes = N * 2;
    const uint16_t* src = packed + (kBatch ? (size_t)b * deg * N : 0);
    mbar_init_expect(bar_addr, book_bytes + deg * slot_bytes);
    bulk_copy(smem_addr(book),
              codebook + (kBatch ? (size_t)b * deg * CODES : 0), book_bytes,
              bar_addr);
    for (int k = 0; k < deg; ++k)
      bulk_copy(smem_addr(table + k * N), src + (size_t)k * N, slot_bytes,
                bar_addr);
  }

  const StateRows rows(level_mean, level_stdv, log_level_stdv, sd_mean,
                       sd_lambda, log_sd_lambda, row);
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];

  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = rows.em(i, evm[0], evs[0], evl[0], log2pi) - log_n;
    alpha[4 * tid + i] = a[i];
  }
  __syncthreads();  // also orders the barrier's init before every wait
  mbar_wait(bar_addr, 0);
  const bool book_prone = __syncthreads_or(
      tid < deg * CODES && nan_prone(book[tid]));
  bool alpha_prone = __syncthreads_or(any_prone(a));

  // the thread's 4 entries of slot 0; slot k's are k * N4 words on
  const uint2* words = reinterpret_cast<const uint2*>(table) + tid;
  float* cur = alpha;
  float* nxt = alpha + N;
  for (int t = 1; t < T; ++t) {
    float best[4];
    int bslot[4];
    if (book_prone || alpha_prone)
      max_slots<kPath, true>(words, book, cur, deg, N4, best, bslot);
    else
      max_slots<kPath, false>(words, book, cur, deg, N4, best, bslot);
    finish_step<kPath>(rows, evm, evs, evl, t, len, log2pi, best, bslot, a,
                       bps, B, b, tid, N);
    // nxt was last read in step t-1, which every thread has left: the
    // barrier below (of step t-1) separates the two
    store4(nxt + 4 * tid, a);
    alpha_prone = __syncthreads_or(any_prone(a));
    float* const done = cur;
    cur = nxt;
    nxt = done;
  }
  store4(final_alpha + row, a);
}

// The resident K6a under one table's layout for every read.
template <bool kPath>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_resident_forward_kernel(const float* __restrict__ ev_mean,
                                const float* __restrict__ ev_stdv,
                                const float* __restrict__ ev_log_stdv,
                                const int32_t* __restrict__ length, int B,
                                int T, int deg,
                                const uint16_t* __restrict__ packed,
                                const float* __restrict__ codebook,
                                const float* __restrict__ level_mean,
                                const float* __restrict__ level_stdv,
                                const float* __restrict__ log_level_stdv,
                                const float* __restrict__ sd_mean,
                                const float* __restrict__ sd_lambda,
                                const float* __restrict__ log_sd_lambda,
                                float log2pi, float log_n,
                                float* __restrict__ final_alpha,
                                uint8_t* __restrict__ bps) {
  resident_forward_body<kPath, false>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, packed, codebook,
      level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
      log_sd_lambda, log2pi, log_n, final_alpha, bps);
}

// The resident K6a under per-read layouts.
template <bool kPath>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_resident_forward_batch_kernel(
    const float* __restrict__ ev_mean, const float* __restrict__ ev_stdv,
    const float* __restrict__ ev_log_stdv,
    const int32_t* __restrict__ length, int B, int T, int deg,
    const uint16_t* __restrict__ packed, const float* __restrict__ codebook,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ log_level_stdv,
    const float* __restrict__ sd_mean, const float* __restrict__ sd_lambda,
    const float* __restrict__ log_sd_lambda, float log2pi, float log_n,
    float* __restrict__ final_alpha, uint8_t* __restrict__ bps) {
  resident_forward_body<kPath, true>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, packed, codebook,
      level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
      log_sd_lambda, log2pi, log_n, final_alpha, bps);
}

// The ranks of a K6am launch (as K1m's WaveRank): one entry a rank of the
// data row (the M entries, then the ranks this launch runs, as int64), in
// device memory of the launch's card; every pointer on the rank's own
// card.
struct GenericWaveRank {
  const float* ev_mean;  // (B, T) events and (B,) lengths, the row's
  const float* ev_stdv;
  const float* ev_log_stdv;
  const int32_t* length;
  // the rank's cut of the table: (deg, W) from_idx int32 and from_logp
  // float32, or (RESIDENT) the (deg, W) packed uint16 and the (deg,
  // CODES) codebook; per read, from_logp, packed and codebook carry a
  // leading B
  const void* table;
  const float* values;
  // (B, W): level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
  // log_sd_lambda of the rank's states
  const float* model[6];
  float* col;      // (2, B, W): its slice of column t at parity t & 1
  uint8_t* bps;    // (T - 1, B, W), or nullptr (score-only)
  int32_t* flags;  // (B,): t once its slice of column t - 1 is stored
};

// K6am: events [0, T) of read wave_lo + blockIdx.x for the rank named by
// entry blockIdx.y of the launch's ranks (after the M = N >> slice_shift
// entries of `wave`), which holds the states [rank W, (rank + 1) W), W =
// 1 << slice_shift.  Each step: the exchange of K1m (wave_exchange.cuh),
// then the block loads the whole column of event t - 1 from the ranks'
// slices into shared memory (4 states a thread) and, RESIDENT, votes over
// all of it whether a value is NaN or +inf; threads 0 .. W / 4 - 1 run
// K6a's slot loop for the rank's 4 states 4 tid .. of theirs, from the
// column, and store their slice of column t and their backpointer word.
// Dynamic shared memory: the column (N float32), and RESIDENT the
// codebooks (deg x CODES float32) and the rank's packed cut (deg x W
// uint16), copied once in the prologue.  per_read: the table's
// log-probs (or layout) are the read's own.
template <bool kPath, bool SYS, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_generic_wave_kernel(const GenericWaveRank* __restrict__ wave, int B,
                            int T, int wave_lo, int slice_shift, int deg,
                            int per_read, float log2pi, float log_n,
                            long long timeout_ns, int32_t* timed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Exchange x;
  __shared__ __align__(8) uint64_t bar;
  float* alpha = reinterpret_cast<float*>(smem);
  float* book = alpha + N;
  uint16_t* table = reinterpret_cast<uint16_t*>(book + deg * CODES);

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, W4 = W >> 2;
  const int rank =
      (int)reinterpret_cast<const long long*>(wave + ranks)[blockIdx.y];
  const int b = wave_lo + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const GenericWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
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
    if (RESIDENT) {
      const uint32_t book_bytes = deg * CODES * 4, slot_bytes = W * 2;
      const uint16_t* src = static_cast<const uint16_t*>(e.table) +
                            (per_read ? (size_t)b * deg * W : 0);
      mbar_init_expect(bar_addr, book_bytes + deg * slot_bytes);
      bulk_copy(smem_addr(book),
                e.values + (per_read ? (size_t)b * deg * CODES : 0),
                book_bytes, bar_addr);
      for (int k = 0; k < deg; ++k)
        bulk_copy(smem_addr(table + k * W), src + (size_t)k * W, slot_bytes,
                  bar_addr);
    }
  }
  // the thread steps the rank's states 4 tid .. 4 tid + 3 of its slice
  const bool mine = tid < W4;
  const size_t row = (size_t)b * W + 4 * (mine ? tid : 0);
  const StateRows rows(e.model[0], e.model[1], e.model[2], e.model[3],
                       e.model[4], e.model[5], row);
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  const int len = e.length[b];
  uint8_t* const bps = e.bps;
  float* const own = e.col + (size_t)b * W + 4 * tid;

  float a[4];
  if (mine) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = rows.em(i, evm[0], evs[0], evl[0], log2pi) - log_n;
    store4(own, a);
  }
  __syncthreads();  // also orders the barrier's init before every wait
  bool book_prone = false;
  if (RESIDENT) {
    mbar_wait(bar_addr, 0);
    book_prone = __syncthreads_or(tid < deg * CODES && nan_prone(book[tid]));
  }
  // the streaming cut: the thread's column of slot 0, slot k's k W / 4
  // vectors on
  const int4* fidx = static_cast<const int4*>(e.table) + tid;
  const float4* flp = reinterpret_cast<const float4*>(e.values) + tid +
                      (per_read ? (size_t)b * deg * W4 : 0);
  // the resident cut's 4 entries of slot 0 of the thread, slot k's k W / 4
  // words on
  const uint2* words = reinterpret_cast<const uint2*>(table) + tid;
  const int j0 = 4 * tid;  // the thread's 4 states of the column it loads
  for (int t = 1; t < T; ++t) {
    // publish column t - 1 (every thread's slice stored), wait for the
    // peers' slices of it, then load the whole column into shared memory
    __syncthreads();
    if (tid == 0) st_flag<SYS>(x.flag[x.rank], t);
    if (warp == 0) {
      __syncwarp();
      wait_ranks<SYS>(x, x.flag, t, lane);
    }
    __syncthreads();
    const float* src = x.col[j0 >> slice_shift] +
                       (size_t)((t - 1) & 1) * B * W + (j0 & (W - 1));
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = ld_column<SYS>(src + i);
    store4(alpha + j0, c);
    // the vote covers the whole column, every rank's slice of it
    bool prone = false;
    if (RESIDENT)
      prone = __syncthreads_or(any_prone(c)) || book_prone;
    else
      __syncthreads();
    if (!mine) continue;
    float best[4];
    int bslot[4];
    if (RESIDENT) {
      if (prone)
        max_slots<kPath, true>(words, book, alpha, deg, W4, best, bslot);
      else
        max_slots<kPath, false>(words, book, alpha, deg, W4, best, bslot);
    } else {
      int bfrom[4];
      for (int k = 0; k < deg; ++k) {
        const int4 iv = __ldg(fidx + (size_t)k * W4);
        const float4 lv = __ldg(flp + (size_t)k * W4);
        const int id[4] = {iv.x, iv.y, iv.z, iv.w};
        const float lp[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          take_slot<kPath>(k, lp[i] + alpha[id[i]], id[i], best[i],
                           bfrom[i], bslot[i]);
      }
    }
    finish_step<kPath>(rows, evm, evs, evl, t, len, log2pi, best, bslot, a,
                       bps, B, b, tid, W);
    store4(own + (size_t)(t & 1) * B * W, a);
  }
}

__global__ void __launch_bounds__(THREADS)
viterbi_generic_traceback_kernel(const float* __restrict__ final_alpha,
                                 const uint8_t* __restrict__ bps,
                                 const int32_t* __restrict__ length, int B,
                                 int T, const int32_t* __restrict__ from_idx,
                                 uint16_t* __restrict__ path,
                                 float* __restrict__ logp) {
  __shared__ float w_best[WARPS];
  __shared__ int w_idx[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* fa = final_alpha + (size_t)b * N;

  // first argmax: 4 states each, then the warps, ties to the lower index
  end_argmax_partials(fa, tid, w_best, w_idx);
  __syncthreads();
  if (tid >= 32) return;
  float best;
  int idx;
  end_argmax(w_best, w_idx, tid, best, idx);
  if (tid != 0) return;

  const int end_state = idx;
  logp[b] = best;
  const int len = length[b];
  uint16_t* out = path + (size_t)b * T;
  const size_t row_stride = (size_t)B * N;
  const uint8_t* bp_b = bps + (size_t)b * N;
  int s = end_state;
  for (int t = T - 1; t >= 1; --t) {
    const int s_eff = t == len - 1 ? end_state : s;
    const int k = bp_b[(size_t)(t - 1) * row_stride + s_eff];
    s = t <= len - 1 ? from_idx[(size_t)k * N + s_eff] : s_eff;
    out[t] = (uint16_t)s_eff;
  }
  out[0] = (uint16_t)s;
}

}  // namespace

// Plain C entries for ctypes.  bps == nullptr runs the score-only variant
// (no backpointer stores).  per_read: from_logp (B, deg, N), read b's
// table its own (from_idx is every read's).  Each returns
// cudaGetLastError() after the launch.
extern "C" int nc_viterbi_generic_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg, const int32_t* from_idx,
    const float* from_logp, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int per_read, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    auto kernel =
        per_read
            ? (bps != nullptr ? viterbi_generic_forward_batch_kernel<true>
                              : viterbi_generic_forward_batch_kernel<false>)
            : (bps != nullptr ? viterbi_generic_forward_kernel<true>
                              : viterbi_generic_forward_kernel<false>);
    kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, from_idx, from_logp,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, log2pi, log_n, final_alpha, bps);
  }
  return (int)cudaGetLastError();
}

// The resident kernel: `packed` (deg, N) uint16 and `codebook` (deg,
// CODES) float32 as ops/hmm.py pack_slots lays them out (per_read: (B,
// deg, N) and (B, deg, CODES), read b's its own), both 16-byte aligned.
// Its dynamic shared memory is set for every launch.
extern "C" int nc_viterbi_resident_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg, const uint16_t* packed,
    const float* codebook, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int per_read, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    auto kernel =
        per_read
            ? (bps != nullptr ? viterbi_resident_forward_batch_kernel<true>
                              : viterbi_resident_forward_batch_kernel<false>)
            : (bps != nullptr ? viterbi_resident_forward_kernel<true>
                              : viterbi_resident_forward_kernel<false>);
    const int smem = 2 * N * 4 + deg * (CODES * 4 + N * 2);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, packed, codebook,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, log2pi, log_n, final_alpha, bps);
  }
  return (int)cudaGetLastError();
}

namespace {

using GenericWaveKernel =
    decltype(&viterbi_generic_wave_kernel<true, false, true>);

// K6am's instance: with backpointers or not, gpu or system scope, the
// resident cut or the streaming one
GenericWaveKernel generic_wave_kernel(int with_path, int sys, int resident) {
  if (resident) {
    if (with_path)
      return sys ? viterbi_generic_wave_kernel<true, true, true>
                 : viterbi_generic_wave_kernel<true, false, true>;
    return sys ? viterbi_generic_wave_kernel<false, true, true>
               : viterbi_generic_wave_kernel<false, false, true>;
  }
  if (with_path)
    return sys ? viterbi_generic_wave_kernel<true, true, false>
               : viterbi_generic_wave_kernel<true, false, false>;
  return sys ? viterbi_generic_wave_kernel<false, true, false>
             : viterbi_generic_wave_kernel<false, false, false>;
}

// K6am's dynamic shared memory: the column, and resident the codebooks and
// the rank's (deg, W) packed cut
int generic_wave_smem(int resident, int deg, int slice_shift) {
  return N * 4 + (resident ? deg * (CODES * 4 + (2 << slice_shift)) : 0);
}

}  // namespace

// K6am's wave: the most blocks of its instance (with_path, sys, resident,
// at deg slots and slices of 1 << slice_shift states) that one card holds
// at once (blocks an SM at its threads and shared memory, times the SMs)
// into *blocks; an error where the card has no cooperative launch.
extern "C" int nc_viterbi_generic_wave_resident(int with_path, int sys,
                                                int resident, int deg,
                                                int slice_shift, int device,
                                                int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  if (slice_shift < 6 || slice_shift > 11 || deg < 1 || deg > 256)
    return (int)cudaErrorInvalidValue;
  const GenericWaveKernel kernel = generic_wave_kernel(with_path, sys,
                                                       resident);
  const int smem = generic_wave_smem(resident, deg, slice_shift);
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K6am: events 0 .. T - 1 of the reads [lo, lo + n_reads) for n_local
// ranks of a data row, one cooperative grid (n_reads, n_local) on
// `stream`.  `ranks` (device memory of this card) holds the row's M = 4096
// >> slice_shift GenericWaveRank entries, then the n_local ranks to run as
// int64; the entries' tables, (B, W) models, (2, B, W) columns, (T - 1,
// B, W) bps (or nullptr: score-only, with_path = 0) and (B,) counters
// (zero before the first wave) lie on their ranks' cards, reachable from
// this one (peer access).  resident: the entries' tables are the packed
// cut and its codebooks (16-byte aligned), of 1 to 64 slots; else the
// int32 / float32 cut of 1 to 256.  per_read: each read's log-probs (or
// layout) its own.  sys: the exchange at system scope.  timed_out: as K1m's.
// Returns the launch's error: a grid larger than the card holds at once
// is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_viterbi_generic_wave(
    const void* ranks, int n_local, int B, int T, int lo, int n_reads,
    int slice_shift, int deg, int per_read, int with_path, int sys,
    int resident, float log2pi, float log_n, long long timeout_ns,
    int32_t* timed_out, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 ||
      n_local > (N >> slice_shift) || timed_out == nullptr || deg < 1 ||
      deg > (resident ? THREADS / CODES : 256))
    return (int)cudaErrorInvalidValue;
  const GenericWaveKernel kernel = generic_wave_kernel(with_path, sys,
                                                       resident);
  const int smem = generic_wave_smem(resident, deg, slice_shift);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_reads, n_local);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const GenericWaveRank*>(ranks), B, T,
                           lo, slice_shift, deg, per_read, log2pi, log_n,
                           timeout_ns, timed_out);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clears it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int nc_viterbi_generic_traceback(
    const float* final_alpha, const uint8_t* bps, const int32_t* length,
    int B, int T, const int32_t* from_idx, uint16_t* path, float* logp,
    int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0) {
    viterbi_generic_traceback_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, from_idx, path, logp);
  }
  return (int)cudaGetLastError();
}
