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
// resident_layout) at G codebooks a slot, one per block of n / G states,
// G = 1 or 4 (the fewest that packs), when every (slot, block) holds at
// most 16 distinct float32 bit patterns and the from-states fit 12 bits
// (n = 4096): entry [k, j] is 16 bits, the from-state in the low 12 and a
// code into the codebook of (slot k, j's block) of 16 float32 values in
// the high 4; the codebooks are block-major, (G, deg, 16).  The loaded
// table of the CLI priors (0.1, 0.3) holds 17 values in some slots but at
// most 16 in a block of 1024 states, so it takes G = 4.  A thread's 4
// states lie in one block, so its codebook base moves once, before the
// time loop, and the slot loop is the same at every G; G is a template
// argument, so the G = 1 instances keep the one-codebook kernel's slot
// loop, whose codebook base is a constant.  At deg slots the
// block holds 2 deg n B of table, 64 G deg B of codebooks and two 16 KiB
// alpha buffers: at most 24 slots fit the 227 KB of one block at G = 1, 23
// at G = 4 (168 KiB + 1.3 or 5.3 KiB at the r73 tables' 21).  The
// prologue copies table and codebooks with cp.async.bulk into shared
// memory, completing on an mbarrier, while the threads compute the first
// emission; no table byte crosses L2 after it.  A step reads per slot one
// 8-byte word of a thread's 4 entries, cuts them into byte offsets into
// alpha and the codebook, and gathers both.  alpha is double-buffered, so
// a step needs one barrier, which also reduces whether a new alpha is NaN
// or +inf: only then (or when a codebook holds NaN or +inf) can a v be
// NaN, and only then does the step track NaN (max_slots).
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
// (streaming) or packed layout and codebooks (resident), at b deg N (b G
// deg CODES) from the start of the (B, ...) tables, G the same for every
// read; from_idx is every read's.
// The bodies are shared and inlined, so the one-table instances compile
// as before.
//
// K6am (viterbi_generic_wave_kernel) is K6a with the 4096 states split
// over M = 2 .. 64 ranks (the generic decode under nanocall_tpu/parallel/
// mesh.py:75 shard_decode_inputs; parallel/statepar.py drives it).  A
// block is one (read, rank) pair and runs all T events on W / 2 threads,
// each stepping 2 of the rank's W states, so that every thread runs the
// slot loop and a read's M blocks together take the threads of about one
// block of K6a: 1024 threads at M = 2, 512 at 4, 256 at 8, at most 64
// registers, so that 1, 2 and 4 blocks share an SM at the resident form's
// 21 slots and every SM steps about 2048 states.  Each step needs the
// whole column of event t - 1 in the block's shared memory (a loaded
// table's from-states lie anywhere).  It comes by one of two exchanges
// (wave_exchange.cuh).  On one card with M <= 8 (CLUSTER) a read's M
// blocks are one thread block cluster: each thread pushes its 2 new values
// into every block's double-buffered column in shared memory, and one
// cluster barrier a step (arrived at after the push, waited on before the
// next step) orders the pushes before the reads and keeps a block from
// overwriting a buffer that a peer still reads; one launch takes a row's
// reads.  Else (across cards, or 16 to 64 ranks) a cooperative grid a
// wave, K1m's exchange: the slices in global memory behind a counter a
// step, the whole column loaded from them.  Then K6a's slot loop for the
// thread's 2 states: the resident form (its rank's (deg, W) cut of the
// packed layout, 2 entries a 4-byte word, and the codebooks in shared
// memory, copied once by cp.async.bulk) max_slots, whose NaN-tracking
// path is taken where a value of the whole column or of the codebooks is
// NaN or +inf, as K6a's vote covers its whole alpha (the cluster path: a
// warp with such a value marks the column in every block with its push;
// the cooperative path: a block vote over the loaded column), the
// streaming form (the (deg, W) int32 / float32 cut read from L2 every
// step, an int2 and a float2 a slot) take_slot.  The rank's cut of a
// layout at G codebooks a slot holds the codebooks of the blocks its W
// states lie in (ops/hmm.py resident_book_rows): one block's where W <=
// n / G, else W G / n; a thread's 2 states lie in one of them, so it
// takes its codebook base once, as K6a.  Cut so, a rank's codebooks take
// 64 deg B at M >= 4 at either G, and the blocks an SM hold what they held
// with one codebook a slot.  So every rank computes
// K6a's bits for its states, NaN bits included.  What bounds it: K6a's
// slot loop over the SM's 2048 states, plus the exchange's latency a step
// (the cluster barrier, which the next event's emissions partly hide; the
// cooperative path: three block barriers, a release and an acquire round
// trip through L2 and the 16 KB column from L2), and in the streaming
// form the cut's bytes from L2.

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

// the S = 4 or 2 floats at p (16- or 8-byte aligned), by the non-coherent
// path
template <int S>
__device__ __forceinline__ void load_rows(float (&d)[S], const float* p) {
  if constexpr (S == 4) {
    unpack4(d, load4(p));
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = v.x;
    d[1] = v.y;
  }
}

// The scaled model's 6 tables at a thread's S states (K6a: 4, K6am: 2).
template <int S>
struct StateRows {
  float lm[S], ls[S], lls[S], sm[S], slam[S], lsl[S];

  __device__ StateRows(const float* level_mean, const float* level_stdv,
                       const float* log_level_stdv, const float* sd_mean,
                       const float* sd_lambda, const float* log_sd_lambda,
                       size_t row) {
    load_rows<S>(lm, level_mean + row);
    load_rows<S>(ls, level_stdv + row);
    load_rows<S>(lls, log_level_stdv + row);
    load_rows<S>(sm, sd_mean + row);
    load_rows<S>(slam, sd_lambda + row);
    load_rows<S>(lsl, log_sd_lambda + row);
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

// A resident table word of S entries (K6a: 4 in 8 bytes, K6am: 2 in 4;
// from-state in bits 0-11, code in bits 12-15 of each 16), as byte offsets
// into alpha and into the slot's codebook.
template <int S>
struct Entries;

template <>
struct Entries<4> {
  using Word = uint2;
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

template <>
struct Entries<2> {
  using Word = uint32_t;
  uint32_t from[2], code[2];

  __device__ __forceinline__ explicit Entries(const uint32_t w) {
    from[0] = (w << 2) & 0x3ffc;
    from[1] = (w >> 14) & 0x3ffc;
    code[0] = (w >> 10) & 0x3c;
    code[1] = (w >> 26) & 0x3c;
  }
};

__device__ __forceinline__ float at_byte(const float* base, uint32_t ofs) {
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(base) + ofs);
}

// The resident kernel's slot loop at one step, for the thread's S states
// (K6a: 4, K6am: 2; slot k's words `stride` words on from slot 0's):
// best and (kPath) the slot of take_slot, in fewer operations, to the same
// bits.  The from-state comes as its byte offset into alpha, which orders
// as the state does.  kNan: a v may be NaN.  Then a NaN only sets a flag,
// and after the last slot a flagged state's best is NaN (any NaN: best +
// emission then gives the card's one NaN, as the sum of take_slot's NaN
// does) and its slot 0, as take_slot ends.  Without kNan (no codebook
// value and no alpha is NaN or +inf, so no v is NaN) the flags go.
template <bool kPath, bool kNan, int S = 4>
__device__ __forceinline__ void max_slots(
    const typename Entries<S>::Word* words, const float* book,
    const float* cur, int deg, int stride, float (&best)[S],
    int (&bslot)[S]) {
  uint32_t bofs[S];
  bool nan[S];
  {
    const Entries<S> e(words[0]);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      best[i] = at_byte(book, e.code[i]) + at_byte(cur, e.from[i]);
      bofs[i] = e.from[i];
      bslot[i] = 0;
      nan[i] = kNan && best[i] != best[i];
    }
  }
  // K6am's 2 states: 10 slots an unrolled pass, so the r73 tables' 20
  // slots after the first take two (in turns against 4, 5, 6 and 20)
#pragma unroll (S == 4 ? 3 : 10)
  for (int k = 1; k < deg; ++k) {
    const Entries<S> e(words[k * stride]);
    const float* bk = book + k * CODES;
#pragma unroll
    for (int i = 0; i < S; ++i) {
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
  for (int i = 0; i < S; ++i)
    if (kNan && nan[i]) best[i] = __int_as_float(0x7fffffff);
}

// The end of step t for a thread's 4 states: alpha' into a (unchanged past
// the read's length), and with kPath the 4 slot ids into bps, whose rows
// are `width` states wide (N; K6am: the rank's W).
template <bool kPath>
__device__ __forceinline__ void finish_step(
    const StateRows<4>& rows, const float* evm, const float* evs,
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

  const StateRows<4> rows(level_mean, level_stdv, log_level_stdv, sd_mean,
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
// memory: alpha (2 x N float32, double-buffered), the codebooks (G x deg
// x CODES float32, block-major), the packed table (deg x N uint16).
// kBatch: per-read layouts, packed (B, deg, N) and codebook (B, G, deg,
// CODES), of which read b copies its own.
template <bool kPath, bool kBatch, int G>
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
  const int book_floats = G * deg * CODES;
  float* alpha = reinterpret_cast<float*>(smem);
  float* book = alpha + 2 * N;
  uint16_t* table = reinterpret_cast<uint16_t*>(book + book_floats);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N + 4 * tid;
  const uint32_t bar_addr = smem_addr(&bar);

  if (tid == 0) {
    const uint32_t book_bytes = book_floats * 4, slot_bytes = N * 2;
    const uint16_t* src = packed + (kBatch ? (size_t)b * deg * N : 0);
    mbar_init_expect(bar_addr, book_bytes + deg * slot_bytes);
    bulk_copy(smem_addr(book),
              codebook + (kBatch ? (size_t)b * book_floats : 0), book_bytes,
              bar_addr);
    for (int k = 0; k < deg; ++k)
      bulk_copy(smem_addr(table + k * N), src + (size_t)k * N, slot_bytes,
                bar_addr);
  }

  const StateRows<4> rows(level_mean, level_stdv, log_level_stdv, sd_mean,
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
  // every codebook (more values than threads at G = 4)
  bool p = false;
  for (int i = tid; i < book_floats; i += THREADS)
    p = p || nan_prone(book[i]);
  const bool book_prone = __syncthreads_or(p);
  bool alpha_prone = __syncthreads_or(any_prone(a));

  // the thread's 4 entries of slot 0; slot k's are k * N4 words on
  const uint2* words = reinterpret_cast<const uint2*>(table) + tid;
  // slot 0's codebook of the block of N / G states that the thread's 4
  // states lie in; slot k's is k * CODES on
  const float* mine = G == 1 ? book : book + tid * G / THREADS * deg * CODES;
  float* cur = alpha;
  float* nxt = alpha + N;
  for (int t = 1; t < T; ++t) {
    float best[4];
    int bslot[4];
    if (book_prone || alpha_prone)
      max_slots<kPath, true>(words, mine, cur, deg, N4, best, bslot);
    else
      max_slots<kPath, false>(words, mine, cur, deg, N4, best, bslot);
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

// The resident K6a under one table's layout for every read, G codebooks
// a slot.
template <bool kPath, int G>
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
  resident_forward_body<kPath, false, G>(
      ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, packed, codebook,
      level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
      log_sd_lambda, log2pi, log_n, final_alpha, bps);
}

// The resident K6a under per-read layouts, G codebooks a slot.
template <bool kPath, int G>
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
  resident_forward_body<kPath, true, G>(
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
  // float32, or (RESIDENT) the (deg, W) packed uint16 and the (groups,
  // deg, CODES) codebooks of the blocks its states lie in; per read,
  // from_logp, packed and codebook carry a leading B
  const void* table;
  const float* values;
  // (B, W): level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
  // log_sd_lambda of the rank's states
  const float* model[6];
  float* col;      // (2, B, W): its slice of column t at parity t & 1
  uint8_t* bps;    // (T - 1, B, W), or nullptr (score-only)
  int32_t* flags;  // (B,): t once its slice of column t - 1 is stored
};

// K6am's blocks: W / 2 threads, 2 states of the rank's slice a thread
// (slices of W >= 64 states: at least a warp); 1024 at 2 ranks, the most
__host__ __device__ __forceinline__ int pair_threads(int slice_shift) {
  return 1 << (slice_shift - 1);
}

// K6am: events [0, T) of one read for one rank, which holds the states
// [rank W, (rank + 1) W), W = 1 << slice_shift, on W / 2 threads, thread
// tid stepping the states 2 tid, 2 tid + 1 of the slice.  The exchange:
// CLUSTER, the read's M ranks one cluster of a grid (M, reads), block (r,
// i) the rank r of read wave_lo + i; each thread pushes its 2 values of
// column t into column buffer t & 1 of every block of the cluster
// (st.shared::cluster), and a warp with a NaN or +inf among its values
// marks the column prone there (prone_at[t & 1] = t + 1); one cluster
// barrier a step, arrived at after the push and waited on before the next
// step reads the column; the rank's slice of the last two columns also
// goes to its (2, B, W) buffer in global memory.  Else a cooperative grid
// (reads, ranks this launch runs), block (i, j) the read wave_lo + i for
// the rank named by entry j of the launch's ranks (after the M = N >>
// slice_shift entries of `wave`), with K1m's exchange (wave_exchange.cuh):
// each step the slice of column t - 1 published in global memory behind
// the rank's counter, the whole column loaded from the ranks' slices and,
// RESIDENT, a block vote over it.  Then each thread runs K6a's slot loop
// for its 2 states from the column in shared memory: RESIDENT max_slots
// on the rank's packed cut and the codebooks, copied once in the prologue
// (its NaN-tracking form where a value of the column or of the codebooks
// is NaN or +inf, as K6a's vote), else take_slot on the (deg, W) int32 /
// float32 cut read from L2.  Dynamic shared memory: the column (CLUSTER:
// 2 x N float32, double-buffered; else N), and RESIDENT the codebooks
// (groups x deg x CODES float32: the cut's blocks of W / groups states,
// block-major) and the rank's packed cut (deg x W uint16).  per_read: the
// table's log-probs (or layout) are the read's own.
template <bool kPath, bool SYS, bool RESIDENT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_generic_wave_kernel(const GenericWaveRank* __restrict__ wave, int B,
                            int T, int wave_lo, int slice_shift, int deg,
                            int groups, int per_read, float log2pi,
                            float log_n, long long timeout_ns,
                            int32_t* timed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Exchange x;
  __shared__ __align__(8) uint64_t bar;
  // CLUSTER: t + 1 once a value of column t (buffer t & 1) is NaN or +inf
  __shared__ int prone_at[2];
  const int book_floats = groups * deg * CODES;
  float* const column = reinterpret_cast<float*>(smem);
  float* const book = column + (CLUSTER ? 2 : 1) * N;
  uint16_t* const table = reinterpret_cast<uint16_t*>(book + book_floats);

  const int ranks = N >> slice_shift;
  const int W = 1 << slice_shift, H = W >> 1;
  const int rank =
      CLUSTER ? (int)blockIdx.x
              : (int)reinterpret_cast<const long long*>(wave + ranks)
                    [blockIdx.y];
  const int b = wave_lo + (int)(CLUSTER ? blockIdx.y : blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const GenericWaveRank& e = wave[rank];
  const uint32_t bar_addr = smem_addr(&bar);
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
  if (RESIDENT && tid == 0) {
    const uint32_t book_bytes = book_floats * 4, slot_bytes = W * 2;
    const uint16_t* src = static_cast<const uint16_t*>(e.table) +
                          (per_read ? (size_t)b * deg * W : 0);
    mbar_init_expect(bar_addr, book_bytes + deg * slot_bytes);
    bulk_copy(smem_addr(book),
              e.values + (per_read ? (size_t)b * book_floats : 0),
              book_bytes, bar_addr);
    for (int k = 0; k < deg; ++k)
      bulk_copy(smem_addr(table + k * W), src + (size_t)k * W, slot_bytes,
                bar_addr);
  }
  const size_t row = (size_t)b * W + 2 * tid;
  const StateRows<2> rows(e.model[0], e.model[1], e.model[2], e.model[3],
                          e.model[4], e.model[5], row);
  const float* evm = e.ev_mean + (size_t)b * T;
  const float* evs = e.ev_stdv + (size_t)b * T;
  const float* evl = e.ev_log_stdv + (size_t)b * T;
  const int len = e.length[b];
  uint8_t* const bps = e.bps;
  float* const own = e.col + row;
  const size_t colstride = (size_t)B * W;
  // the thread's 2 states of the column
  const int j = (rank << slice_shift) + 2 * tid;

  float a[2], em[2];
  // the emissions of the thread's states at event te
  auto emission2 = [&](int te) {
    const float xe = evm[te], ye = evs[te], le = evl[te];
#pragma unroll
    for (int i = 0; i < 2; ++i) em[i] = rows.em(i, xe, ye, le, log2pi);
  };
  // the thread's slice of column tc into the rank's buffer tc & 1
  auto store_own = [&](int tc) {
    *reinterpret_cast<float2*>(own + (size_t)(tc & 1) * colstride) =
        make_float2(a[0], a[1]);
  };
  // CLUSTER: the thread's values of column tc into every block's column
  // buffer tc & 1, and (RESIDENT) the column marked prone where a value of
  // the warp is NaN or +inf (lane p marking it in block p)
  auto push = [&](int tc) {
    const uint32_t dst = smem_addr(column + (tc & 1) * N + j);
    for (int p = 0; p < ranks; ++p)
      st_cluster2(cluster_map(dst, p), a[0], a[1]);
    if (RESIDENT &&
        __any_sync(FULL, nan_prone(a[0]) || nan_prone(a[1])) &&
        lane < ranks)
      st_cluster(cluster_map(smem_addr(&prone_at[tc & 1]), lane), tc + 1);
  };

  emission2(0);
#pragma unroll
  for (int i = 0; i < 2; ++i) a[i] = em[i] - log_n;
  if (!CLUSTER || T <= 2) store_own(0);
  if constexpr (CLUSTER) {
    // every block of the cluster runs, its prone_at zeroed; also orders the
    // mbarrier's init before every wait
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();  // also orders the barrier's init before every wait
  }
  bool book_prone = false;
  if (RESIDENT) {
    mbar_wait(bar_addr, 0);
    bool p = false;
    for (int i = tid; i < book_floats; i += H) p = p || nan_prone(book[i]);
    book_prone = __syncthreads_or(p);
  }
  if (CLUSTER && T > 1) {
    push(0);
    cluster_arrive();
  }
  if (T > 1) emission2(1);
  // the streaming cut: the thread's pair of slot 0, slot k's k W / 2 pairs
  // on
  const int2* fidx = static_cast<const int2*>(e.table) + tid;
  const float2* flp = reinterpret_cast<const float2*>(e.values) + tid +
                      (per_read ? (size_t)b * deg * H : 0);
  // the resident cut's word of the thread's 2 entries of slot 0, slot k's
  // k W / 2 words on, and slot 0's codebook of the block of W / groups
  // states that the thread's 2 states lie in, slot k's k CODES on
  const uint32_t* words = reinterpret_cast<const uint32_t*>(table) + tid;
  const float* mine =
      book + ((2 * tid * groups) >> slice_shift) * deg * CODES;
  for (int t = 1; t < T; ++t) {
    const float* cur = column;
    bool prone = false;
    if constexpr (CLUSTER) {
      // every block's push of column t - 1 is in
      cluster_wait();
      cur = column + ((t - 1) & 1) * N;
      if (RESIDENT) prone = book_prone || prone_at[(t - 1) & 1] == t;
    } else {
      // publish column t - 1 (every thread's slice stored), wait for the
      // peers' slices of it, then load the whole column into shared memory
      __syncthreads();
      if (tid == 0) st_flag<SYS>(x.flag[x.rank], t);
      if (warp == 0) {
        __syncwarp();
        wait_ranks<SYS>(x, x.flag, t, lane);
      }
      __syncthreads();
      const size_t src = (size_t)((t - 1) & 1) * colstride;
      bool p = false;
      for (int i = 4 * tid; i < N; i += 4 * H) {
        const float4 v =
            ld_column4<SYS>(x.col[i >> slice_shift] + src + (i & (W - 1)));
        *reinterpret_cast<float4*>(column + i) = v;
        p = p || nan_prone(v.x) || nan_prone(v.y) || nan_prone(v.z) ||
            nan_prone(v.w);
      }
      // the vote covers the whole column, every rank's slice of it
      if (RESIDENT)
        prone = __syncthreads_or(p) || book_prone;
      else
        __syncthreads();
    }
    float best[2];
    int bslot[2];
    if (RESIDENT) {
      if (prone)
        max_slots<kPath, true, 2>(words, mine, cur, deg, H, best, bslot);
      else
        max_slots<kPath, false, 2>(words, mine, cur, deg, H, best, bslot);
    } else {
      int bfrom[2];
      for (int k = 0; k < deg; ++k) {
        const int2 iv = __ldg(fidx + (size_t)k * H);
        const float2 lv = __ldg(flp + (size_t)k * H);
        take_slot<kPath>(k, lv.x + cur[iv.x], iv.x, best[0], bfrom[0],
                         bslot[0]);
        take_slot<kPath>(k, lv.y + cur[iv.y], iv.y, best[1], bfrom[1],
                         bslot[1]);
      }
    }
    // finish_step for the 2 states: alpha' (unchanged past the read's
    // length) and the 2 slot ids
    const bool active = t < len;
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int slot = best[i] != best[i] ? 0 : bslot[i];
      packed |= (uint32_t)slot << (8 * i);
      if (active) a[i] = best[i] + em[i];
    }
    if (kPath) {
      reinterpret_cast<uint16_t*>(bps + ((size_t)(t - 1) * B + b) * W)
          [tid] = (uint16_t)packed;
    }
    if (!CLUSTER || t >= T - 2) store_own(t);
    if (CLUSTER && t < T - 1) {
      push(t);
      cluster_arrive();
    }
    if (t + 1 < T) emission2(t + 1);  // while the peers push
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

namespace {

// the resident K6a's instance at G codebooks a slot: with backpointers or
// not, one table or per-read layouts
template <int G>
decltype(&viterbi_resident_forward_kernel<true, 1>) resident_forward_instance(
    bool with_path, int per_read) {
  if (per_read)
    return with_path ? viterbi_resident_forward_batch_kernel<true, G>
                     : viterbi_resident_forward_batch_kernel<false, G>;
  return with_path ? viterbi_resident_forward_kernel<true, G>
                   : viterbi_resident_forward_kernel<false, G>;
}

}  // namespace

// The resident kernel: `packed` (deg, N) uint16 and `codebook` (groups,
// deg, CODES) float32 as ops/hmm.py resident_layout lays them out
// (per_read: (B, deg, N) and (B, groups, deg, CODES), read b's its own),
// both 16-byte aligned; groups 1 or 4, each an instance of its own.  Its
// dynamic shared memory is set for every launch.
extern "C" int nc_viterbi_resident_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg, int groups,
    const uint16_t* packed, const float* codebook, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int per_read, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (deg < 1 || (groups != 1 && groups != 4))
    return (int)cudaErrorInvalidValue;
  if (B > 0 && T > 0) {
    auto kernel =
        groups == 1 ? resident_forward_instance<1>(bps != nullptr, per_read)
                    : resident_forward_instance<4>(bps != nullptr, per_read);
    const int smem = 2 * N * 4 + deg * (groups * CODES * 4 + N * 2);
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
    decltype(&viterbi_generic_wave_kernel<true, false, true, false>);

// the exchange's instances of K6am's form: a cluster a read (one card),
// else the cooperative grid at gpu or system scope
template <bool kPath, bool RESIDENT>
GenericWaveKernel wave_instance(int sys, int cluster) {
  if (cluster)
    return viterbi_generic_wave_kernel<kPath, false, RESIDENT, true>;
  return sys ? viterbi_generic_wave_kernel<kPath, true, RESIDENT, false>
             : viterbi_generic_wave_kernel<kPath, false, RESIDENT, false>;
}

// K6am's instance: with backpointers or not, the resident cut or the
// streaming one, and its exchange
GenericWaveKernel generic_wave_kernel(int with_path, int sys, int resident,
                                      int cluster) {
  if (resident)
    return with_path ? wave_instance<true, true>(sys, cluster)
                     : wave_instance<false, true>(sys, cluster);
  return with_path ? wave_instance<true, false>(sys, cluster)
                   : wave_instance<false, false>(sys, cluster);
}

// K6am's dynamic shared memory: the column (cluster: both parities), and
// resident the cut's codebooks (`groups` a slot) and the rank's (deg, W)
// packed cut
int generic_wave_smem(int resident, int deg, int groups, int slice_shift,
                      int cluster) {
  return (cluster ? 2 : 1) * N * 4 +
         (resident ? deg * (groups * CODES * 4 + (2 << slice_shift)) : 0);
}

// a rank's cut holds 1 to 4 codebooks a slot, blocks of at least 2 states
bool wave_groups_ok(int resident, int groups, int slice_shift) {
  return !resident || ((groups == 1 || groups == 2 || groups == 4) &&
                       (1 << slice_shift) >= 2 * groups);
}

// the launch's shape: a cooperative grid (reads, ranks), or (cluster) a
// grid (ranks, reads) of clusters of the read's M ranks
void generic_wave_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                         int n_reads, int n_local, int slice_shift, int smem,
                         int cluster) {
  cfg = {};
  cfg.blockDim = dim3(pair_threads(slice_shift));
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

// K6am's wave: the most blocks of its instance (with_path, sys, resident,
// at deg slots of `groups` codebooks in the cut and slices of 1 <<
// slice_shift states) that one card holds at once (blocks an SM at W / 2
// threads and its shared memory, times the SMs) into *blocks; (cluster)
// the blocks of the clusters of M ranks it holds at once
// (cudaOccupancyMaxActiveClusters).  An error where the card has no
// cooperative launch (or, cluster, where the clusters do not fit).
extern "C" int nc_viterbi_generic_wave_resident(int with_path, int sys,
                                                int resident, int deg,
                                                int groups, int slice_shift,
                                                int cluster, int device,
                                                int* blocks) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  *blocks = 0;
  const int ranks = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || deg < 1 || deg > 256 ||
      !wave_groups_ok(resident, groups, slice_shift) ||
      (cluster && (sys || ranks > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const GenericWaveKernel kernel =
      generic_wave_kernel(with_path, sys, resident, cluster);
  const int smem =
      generic_wave_smem(resident, deg, groups, slice_shift, cluster);
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
    generic_wave_config(cfg, attr, 1, ranks, slice_shift, smem, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * ranks;
    return (int)err;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, pair_threads(slice_shift), smem);
  *blocks = per_sm * sms;
  return (int)err;
}

// K6am: events 0 .. T - 1 of the reads [lo, lo + n_reads) for n_local
// ranks of a data row on `stream`, blocks of W / 2 threads: one
// cooperative grid (n_reads, n_local), or (cluster: every rank of the row,
// on this card, M <= MAX_CLUSTER) a grid of the reads' clusters.  `ranks`
// (device memory of this card) holds the row's M = 4096 >> slice_shift
// GenericWaveRank entries, then the n_local ranks to run as int64; the
// entries' tables, (B, W) models, (2, B, W) columns, (T - 1, B, W) bps (or
// nullptr: score-only, with_path = 0) and (B,) counters (zero before the
// launch; the cluster path reads none) lie on their ranks' cards,
// reachable from this one (peer access).  resident: the entries' tables
// are the packed cut and its codebooks (16-byte aligned; `groups` a slot,
// the blocks of the cut's states), of 1 to 64 slots; else the int32 /
// float32 cut of 1 to 256.  per_read: each read's log-probs (or layout)
// its own.  sys: the exchange at system scope.
// timed_out: as K1m's.  Returns the launch's error: a cooperative grid
// larger than the card holds at once is refused
// (cudaErrorCooperativeLaunchTooLarge).
extern "C" int nc_viterbi_generic_wave(
    const void* ranks, int n_local, int B, int T, int lo, int n_reads,
    int slice_shift, int deg, int groups, int per_read, int with_path,
    int sys, int resident, int cluster, float log2pi, float log_n,
    long long timeout_ns, int32_t* timed_out, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int M = N >> slice_shift;
  if (slice_shift < 6 || slice_shift > 11 || T < 1 || lo < 0 ||
      n_reads < 1 || lo + n_reads > B || n_local < 1 || n_local > M ||
      timed_out == nullptr || deg < 1 ||
      deg > (resident ? THREADS / CODES : 256) ||
      !wave_groups_ok(resident, groups, slice_shift) ||
      (cluster && (sys || n_local != M || M > nc::MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const GenericWaveKernel kernel =
      generic_wave_kernel(with_path, sys, resident, cluster);
  const int smem =
      generic_wave_smem(resident, deg, groups, slice_shift, cluster);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  generic_wave_config(cfg, attr, n_reads, n_local, slice_shift, smem,
                      cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const GenericWaveRank*>(ranks), B, T,
                           lo, slice_shift, deg, groups, per_read, log2pi,
                           log_n, timeout_ns, timed_out);
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
