// K2: grouped Viterbi traceback into bit-packed 6-bit codes, and K3's
// traceback half: the same walk over one chunk of backpointer rows.
//
// K2 replaces nanocall_tpu/ops/hmm.py viterbi_traceback_grouped(compact=True)
// + _lookup_bp + grouped_from_state + _pack_codes; the chunk form replaces
// viterbi_traceback_grouped_chunk (hmm.py:437), the traceback half of
// viterbi_decode_grouped_tchunk (hmm.py:614).  Per read b:
//   end_state = first argmax of final_alpha[b], logp = its max (a NaN
//               counts above every number, as torch.argmax / torch.amax);
//   for t = T-1 .. 1:
//     s_eff = t == length-1 ? end_state : s
//     k     = bp row of event t, at s_eff
//     real  = t <= length-1
//     s     = real ? from_state(k, s_eff) : s_eff
//     code[t-1] = real ? (k >> 6) << 4 | (s_eff & 15) : 0
//   path0 = s.
// Four codes pack into three little-endian bytes (code i of a group at bits
// [6i, 6i+6)), pad codes past T-1 are 0: the layout that
// native.path_from_packed_codes reads.
//
// A chunk walks events t1-1 .. max(t0, 1) of the rows bps[t - t0], from the
// carried state s (end_state for the last chunk), with end_state given, and
// leaves the state for the chunk to its left (after the chunk with t0 = 0,
// path0: event 0's row is filler and passes s through).  Packing across
// chunks: the code of event t goes to its global place, code t-1 of the
// packed row, and a group of four codes may straddle two chunks (chunks of
// 8192 events put the group of events 8189..8192 in both).  So the packed
// buffer is zeroed once and each chunk ORs its codes in; the chunks run one
// after another on one stream and set disjoint bits.  This keeps the codes
// packed on the card (0.75 byte per event) with no unpacked (T-1, B) buffer
// and no second packing pass.
//
// K9's traceback chunk (parallel/seqpar.py, replacing the traceback of
// nanocall_tpu/parallel/seqpar.py:40) is the third form of the same walk:
// it writes the state s_eff of every event t0 .. t1-1 (event 0 included,
// where it passes s_eff through) as a uint16 into row t - t0 of a
// (t1 - t0, row_stride) states buffer, JAX's non-compact output
// (nanocall_tpu/ops/hmm.py:464-483).  States, not packed codes, because
// K9's ranks walk their slices on streams of their own, so two ranks must
// never share a 3-byte group, and JAX's K9 returns states.
//
// K6b's ring kernel (viterbi_generic_traceback_ring_kernel) is the fourth
// form: the traceback under a loaded transition table, replacing
// nanocall_tpu/ops/hmm.py viterbi_traceback (hmm.py:714; its streaming
// kernel is csrc/viterbi_generic.cu's).  Its backpointer byte k is a slot,
// the state before s_eff is from_idx[k, s_eff], and it writes the uint16
// state of every event (JAX's path (B, T)); past the read's length the path
// holds the end state, and path[0] is the state before event 1.
//
// Design (for the H100): one block per read, and one walk (walk_ring) for
// all four forms, templated on the predecessor rule: K2, K3 and K9 take
// the grouped arithmetic (GroupedFrom), K6b reads its (deg, 4096) uint16
// from-state table (ops/hmm.py from_state_table) from shared memory
// (TableFrom), where the producer thread bulk-copies it beside the ring's
// first stages while the block takes the end argmax.  Only events
// t <= length-1 read a row (the others pass the state through with code
// 0, and event 0's row is filler), so the walk's rows are known before it
// starts: events min(length, t1) - 1 down to max(t0, 1), each 4096
// contiguous bytes of bps.  One thread (the
// producer, thread 32) streams them by cp.async.bulk into a ring of shared
// memory, RING_ROWS rows a stage, with a `full` and an `empty` mbarrier a
// stage; thread 0 walks: it waits on a stage's `full` phase, takes its
// rows' bytes at the current state from shared memory, and hands the stage
// back on `empty`, after which the producer refills it with the rows
// `stages` stages further down.  The walk never waits on a load from
// device memory, nor on a copy's issue or the proxy fence before it.  K2's
// block of 1024 threads takes the end argmax while the first copies are in
// flight (4 states a thread, then the warp's shuffles, then the 32 warps,
// by K6b's rule: a NaN above every number, ties to the lower index), and
// writes the code groups past the read's last real code as zeros; K9's
// chunk block writes the pass-through states of the events past the read's
// end.  K3's chunk stores its code groups but the ones it shares with
// another chunk (at most 2 a walk), which it reads back from device memory
// and ORs in.
//
// What bounds it: the rows streamed, (length - 1) x 4096 bytes a read,
// over the card's memory rate when enough reads walk at once (128 reads of
// 8192 events: 4.29 GB, 1.28 ms at 3.35 TB/s); a read alone is bound by
// its walker, one dependent shared-memory byte load and a few integer
// operations an event.  The stages a block gets (ring_stages) keep >= 64
// KB in flight an SM: 12 (192 KB) when each SM holds one block, 6 for K2
// at 2 blocks an SM.  The count is a kernel argument: a walk compiled for
// a fixed count (6 or 12 stages) has 287 SASS instructions in its loop
// against 269 and walks 5-13% slower on an H100.  A walk that loads each
// event's byte from device memory instead is bound by T dependent round
// trips (3.35 ms at 128 x 8192 on an H100, against 1.36 ms for the ring at
// full lengths).
//
// K6b's table takes deg x 8 KB beside the ring, so its block gets the
// stages left of the 227 KB of one block (ring_stages): 3 at the r73
// tables' 21 slots, 2 at 24, and a table of more slots than leave room for
// MIN_STAGES takes the streaming kernel (ops/hmm.py
// generic_traceback_route).  Its walk makes two dependent shared-memory
// loads an event (the row's byte, then the table's state) and one 2-byte
// path store; its block's other warps write the end state past the walk.
//
// K2m (viterbi_traceback_slices_kernel) is K2 with the 4096 states split
// over M ranks (parallel/statepar.py; the production decode under
// nanocall_tpu/parallel/mesh.py:103 shard_pooled_decode_inputs): rank m
// holds the backpointer bytes of the states [m W, (m + 1) W), W = 4096 /
// M, as (T - 1, B, W) rows, and its (B, W) slice of the final column.  It
// is K2's kernel on K2's walk_ring, with a table of the ranks' 2 M
// addresses (final slices, then backpointer slices): the block takes K2's
// end argmax (common.cuh's helper: the same NaN and tie rules) over the
// column's slices, and the producer assembles each 4096-byte row in the
// ring from M bulk copies of W bytes, slice m's row to bytes [m W, (m + 1)
// W) of the stage (the stage's `full` barrier still expects cnt x 4096
// bytes), so the walker reads whole rows from shared memory with K2's
// predecessor rule and code packing, unchanged: path0, codes and logp are
// K2's.  The producer is a warp: lane 0 expects the stage's bytes, then
// the lanes share its cnt x M copies (one thread issuing them took 1.68 /
// 2.40 ms at 128 x 8192 over 2 / 4 ranks on an H100, as drawn or at full
// lengths: about 44 ns a copy on the longest read's walk, against the
// warp's 1.36 / 1.39 ms at full lengths and K2's 1.36).  W
// >= 64 keeps every copy 16-byte sized and aligned; at 64 ranks a row is
// 64 copies of 64 bytes, and the copies' issue bounds the walk (15.2 ms
// there; not designed for).  Across cards the copies read the peers'
// slices over peer access; whether cp.async.bulk reads a peer card's
// memory is not established (one card cannot show it:
// tools/torch_multi_gpu.py's mesh phase is the check).  What bounds it:
// K2's rows streamed, (length - 1) x 4096 bytes a read.
//
// K6bm (viterbi_generic_traceback_slices_kernel) is K6b with the states
// split over M ranks (the generic decode under nanocall_tpu/parallel/
// mesh.py:75 shard_decode_inputs): K6b's ring kernel on K2m's slices.  The
// block takes K6b's end argmax over the final column's slices, the
// producer warp assembles each row from the M slices as K2m's, and the
// walker follows K6b's rule: the table's uint16 from-state copy in shared
// memory after the ring (TableFrom, tables of at most 24 slots), or for
// wider tables the int32 from_idx read from global memory (IdxFrom, one
// dependent load an event, as K6b's streaming kernel).  What bounds it:
// K6b's rows streamed.
//
// What bounds K9 as a whole: K3's forward operations (one chunk kernel per
// rank and block) and this walk, over D * M launches of each half for D
// ranks and M blocks, with a pipeline fill of (D - 1) / (M + D - 1) of the
// microsteps in which some rank waits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "device_guard.cuh"

namespace {

using nc::end_argmax;
using nc::end_argmax_partials;
using nc::end_argmax_partials_at;
using nc::N;

constexpr int THREADS = 1024;  // K2: the end argmax's block
constexpr int CHUNK_THREADS = 64;  // K3's and K9's chunks: two warps
// rows a ring stage holds: the walk waits on a stage and hands it back
// once per RING_ROWS events
constexpr int RING_ROWS = 4;
constexpr uint32_t STAGE_BYTES = RING_ROWS * N;
constexpr int MAX_STAGES = 12;  // 192 KB of shared memory
constexpr int MIN_STAGES = 2;
// shared memory one block may use on Hopper, and the part of it K6b's ring
// kernel leaves to its static arrays (456 bytes of mbarriers and argmax
// partials): its table and ring share the rest (ops/hmm.py
// traceback_ring_smem_bytes budgets the same)
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int TABLE_RING_STATIC = 512;
// and K6bm's, which also holds the slice table (1 KB of static arrays)
constexpr int SLICES_TABLE_STATIC = 1536;

// The rows of one read's walk in global memory and the ring they pass
// through.  Row j of the walk (j = 0, 1, ..) is event t_top - j, at
// src - j * stride; it goes to slot j % RING_ROWS of stage
// (j / RING_ROWS) % stages.  Each stage has two mbarriers: `full` (one
// arrival and the stage's bytes: the producer's copies have landed) and
// `empty` (one arrival: the walker is done with the stage).  One thread,
// the producer, issues every copy; another, the walker, only waits on
// `full` and arrives on `empty`, so no proxy fence or copy ever stalls the
// walk behind its own stores.
// SLICES (K2m): a row is split over the M = N >> shift ranks' slices, W =
// 1 << shift bytes each; row j of slice m is at slices[m] + first - j *
// stride (slices: a table in shared memory), and src is unused.
template <bool SLICES = false>
struct Ring {
  uint8_t* buf;        // stages * STAGE_BYTES of shared memory
  uint64_t* full;      // one mbarrier a stage
  uint64_t* empty;     // one mbarrier a stage
  int stages;
  const uint8_t* src;  // the walk's first row
  size_t stride;       // bytes between the rows of events t and t + 1
  int n;               // rows of the walk
  const uint8_t* const* slices = nullptr;
  size_t first = 0;
  int shift = 0;

  __device__ __forceinline__ int quads() const {
    return (n + RING_ROWS - 1) / RING_ROWS;
  }

  // the rows of stage use q (rows RING_ROWS q ..) into stage st
  __device__ __forceinline__ void fill(int q, int st) const {
    const int j0 = q * RING_ROWS;
    const int cnt = min(RING_ROWS, n - j0);
    const uint32_t bar = nc::smem_addr(full + st);
    if (!SLICES || (threadIdx.x & 31) == 0) nc::mbar_expect(bar, cnt * N);
    const uint32_t dst = nc::smem_addr(buf) + st * STAGE_BYTES;
    if constexpr (SLICES) {
      // the producer warp's lanes share the stage's cnt x M copies, after
      // lane 0's expected bytes
      __syncwarp();
      const int lane = threadIdx.x & 31;
      const int rs = 12 - shift;  // log2 M
      for (int i = lane; i < cnt << rs; i += 32) {
        const int r = i >> rs, m = i & ((1 << rs) - 1);
        nc::bulk_copy(dst + r * N + (m << shift),
                      slices[m] + first - (size_t)(j0 + r) * stride,
                      1u << shift, bar);
      }
    } else {
      const uint8_t* row = src - (size_t)j0 * stride;
      for (int r = 0; r < cnt; ++r, row -= stride)
        nc::bulk_copy(dst + r * N, row, N, bar);
    }
  }

  // The producer, before a block barrier that publishes the mbarriers:
  // initialise them and start the copies of the first stages.  (SLICES:
  // the producer is a warp, whose lane 0 does what the one thread does
  // else; every lane runs start and produce.)
  __device__ __forceinline__ void start() const {
    if (!SLICES || (threadIdx.x & 31) == 0) {
      for (int st = 0; st < stages; ++st) {
        nc::mbar_init(nc::smem_addr(full + st), 1);
        nc::mbar_init(nc::smem_addr(empty + st), 1);
      }
      nc::fence_mbarrier_init();
    }
    for (int q = 0; q < stages && q < quads(); ++q) fill(q, q);
  }

  // The producer, after that barrier: each later stage use once the walker
  // has handed its stage back.
  __device__ __forceinline__ void produce() const {
    int st = 0;
    uint32_t parity = 0;
    for (int q = stages; q < quads(); ++q) {
      nc::mbar_wait(nc::smem_addr(empty + st), parity);
      nc::fence_proxy_async();  // the walk's reads of the stage came first
      fill(q, st);
      if (++st == stages) {
        st = 0;
        parity ^= 1;
      }
    }
  }
};

// The ring for the walk over events t_top .. t_top - n + 1 of one read;
// event t's row at bp_b + (t - row0) * stride.
__device__ __forceinline__ Ring<> make_ring(uint8_t* buf, uint64_t* full,
                                            uint64_t* empty, int stages,
                                            const uint8_t* __restrict__ bp_b,
                                            size_t stride, int row0,
                                            int t_top, int n) {
  return {buf, full, empty, stages,
          n > 0 ? bp_b + (size_t)(t_top - row0) * stride : bp_b, stride, n};
}

// The grouped predecessor rule (K2, K3, K9: ops/hmm.py grouped_from_state):
// backpointer byte k = group << 6 | arg names the state before s_eff.
struct GroupedFrom {
  __device__ __forceinline__ int operator()(int k, int s_eff) const {
    const int group = k >> 6;
    const int arg = k & 63;
    return group == 0   ? s_eff
           : group == 1 ? ((arg << 10) | (s_eff >> 2))
                        : ((arg << 8) | (s_eff >> 4));
  }
};

// K6b's rule under a loaded table: backpointer byte k is a slot, and the
// state before s_eff is from_idx[k, s_eff], read from the table's uint16
// copy (ops/hmm.py from_state_table) in shared memory at `table`.
struct TableFrom {
  uint32_t table;  // shared address of the (deg, N) uint16 table
  __device__ __forceinline__ int operator()(int k, int s_eff) const {
    return (int)nc::lds_u16(table + 2u * (uint32_t)(k * N + s_eff));
  }
};

// K6bm's rule under a table of more slots than leave room for the ring
// beside its from-state table: the state before s_eff is from_idx[k,
// s_eff], read from the (deg, N) int32 table in global memory.
struct IdxFrom {
  const int32_t* idx;
  __device__ __forceinline__ int operator()(int k, int s_eff) const {
    return __ldg(idx + (size_t)k * N + s_eff);
  }
};

// The walk over the ring's n rows, events t_top, t_top - 1, .., all real
// (1 <= t <= length - 1), from state s, which is s_eff at every event of
// the walk; from(k, s_eff) is the state before s_eff for its backpointer
// byte k, and sink(t, s_eff, code) takes each event's state and its K2
// code (group << 4 | s_eff & 15).  Returns the state before the last event
// walked.
template <class Sink, class From = GroupedFrom, bool SLICES = false>
__device__ __forceinline__ int walk_ring(const Ring<SLICES>& ring, int t_top,
                                         int s, Sink sink,
                                         From from = From()) {
  int st = 0;
  uint32_t parity = 0;
  for (int j = 0; j < ring.n; j += RING_ROWS) {
    nc::mbar_wait(nc::smem_addr(ring.full + st), parity);
    const uint32_t stage = nc::smem_addr(ring.buf) + st * STAGE_BYTES;
#pragma unroll
    for (int r = 0; r < RING_ROWS; ++r) {
      if (j + r < ring.n) {
        const int s_eff = s;
        const int k = (int)nc::lds_u8(stage + r * N + s_eff);
        s = from(k, s_eff);
        sink(t_top - j - r, s_eff, ((k >> 6) << 4) | (s_eff & 15));
      }
    }
    nc::mbar_arrive(nc::smem_addr(ring.empty + st));
    if (++st == ring.stages) {
      st = 0;
      parity ^= 1;
    }
  }
  return s;
}

// The walk's extent in a chunk of events [t0, t1) for a read of length
// len: its rows are events t_top down to max(t0, 1), n of them, and the
// state it starts from is end_state when event len - 1 lies in the chunk
// (the events above it pass the carry through), else the carry s.
struct Extent {
  int t_top, n, s;
};

__device__ __forceinline__ Extent extent(int t0, int t1, int len,
                                         int end_state, int s) {
  const int t_top = min(len, t1) - 1;
  const int t_lo = t0 > 1 ? t0 : 1;
  if (len - 1 >= t0 && len - 1 < t1) s = end_state;
  return {t_top, t_top >= t_lo ? t_top - t_lo + 1 : 0, s};
}

// Packs the walk's codes, event t's code as code t - 1 of the read's packed
// row `out`: four codes to three bytes.  A group is flushed at its lowest
// code or at the walk's last event, t_last.  K2 stores every group; K3's
// chunks (OR_CODES) OR in a group that holds an event outside their
// events [t0, t1), which another chunk may set, and store the others (the
// packed row was zeroed, and only this chunk writes them).
template <bool OR_CODES>
struct PackCodes {
  uint8_t* out;
  int t_last, t0, t1;
  uint32_t w = 0;

  __device__ __forceinline__ void operator()(int t, int, int code) {
    const int i = t - 1;
    w |= (uint32_t)code << (6 * (i & 3));
    if ((i & 3) == 0 || t == t_last) {
      uint8_t* o = out + 3 * (i >> 2);
      const int e = (i & ~3) + 1;  // the group's first event
      if (OR_CODES && (e < t0 || e + 3 >= t1)) {
        o[0] |= (uint8_t)(w & 0xff);
        o[1] |= (uint8_t)((w >> 8) & 0xff);
        o[2] |= (uint8_t)((w >> 16) & 0xff);
      } else {
        o[0] = (uint8_t)(w & 0xff);
        o[1] = (uint8_t)((w >> 8) & 0xff);
        o[2] = (uint8_t)((w >> 16) & 0xff);
      }
      w = 0;
    }
  }
};

// the thread that issues the ring's copies (warp 1's first lane)
constexpr int PRODUCER = 32;

__global__ void __launch_bounds__(THREADS)
viterbi_traceback_kernel(const float* __restrict__ final_alpha,
                         const uint8_t* __restrict__ bps,
                         const int32_t* __restrict__ length, int B, int T,
                         int code_bytes, int stages,
                         int32_t* __restrict__ path0,
                         uint8_t* __restrict__ codes,
                         float* __restrict__ logp) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = length[b];
  // the walk's rows: events min(len, T) - 1 .. 1 (row t - 1 of bps)
  const Extent ex = extent(0, T, len, 0, 0);
  const Ring<> ring = make_ring(ring_buf, full, empty, stages,
                                bps + (size_t)b * N, (size_t)B * N, 1,
                                ex.t_top, ex.n);
  if (tid == PRODUCER) ring.start();

  // the code groups past the last real code (and every group of a read
  // without one) are zeros; the walk writes the groups below
  uint8_t* out = codes + (size_t)b * code_bytes;
  for (int i = 3 * (ex.n > 0 ? ((ex.t_top - 1) >> 2) + 1 : 0) + tid;
       i < code_bytes; i += THREADS)
    out[i] = 0;

  // first argmax of the final alpha: 4 states each, then the warps
  end_argmax_partials(final_alpha + (size_t)b * N, tid, w_best, w_idx);
  __syncthreads();  // also publishes the ring's mbarriers
  if (tid == PRODUCER) ring.produce();
  if (tid >= 32) return;
  float best;
  int idx;
  end_argmax(w_best, w_idx, tid, best, idx);
  if (tid != 0) return;

  logp[b] = best;
  path0[b] = walk_ring(ring, ex.t_top, idx, PackCodes<false>{out, 1, 0, T});
}

// One chunk of rows, events [t0, t1): a block per read walks from state[b]
// and leaves the state for the chunk to its left in state[b].  STATES =
// false (K3) ORs the packed codes into `codes`; STATES = true (K9) writes
// the states into `states` (row t - t0, column b, rows of states_stride).
template <bool STATES>
__global__ void __launch_bounds__(CHUNK_THREADS)
viterbi_traceback_chunk_kernel(const int32_t* __restrict__ end_state,
                               int32_t* __restrict__ state,
                               const uint8_t* __restrict__ bps,
                               const int32_t* __restrict__ length, int B,
                               int t0, int t1, int code_bytes, int stages,
                               uint8_t* __restrict__ codes,
                               uint16_t* __restrict__ states,
                               int states_stride) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = length[b];
  const int carry = state[b];
  const Extent ex = extent(t0, t1, len, end_state[b], carry);
  const Ring<> ring = make_ring(ring_buf, full, empty, stages,
                                bps + (size_t)b * N, (size_t)B * N, t0,
                                ex.t_top, ex.n);
  if (tid == PRODUCER) ring.start();
  if (STATES) {
    // events past the read's end (event 0 aside) pass the carry through
    for (int t = max(max(len, t0), 1) + tid; t < t1; t += CHUNK_THREADS)
      states[(size_t)(t - t0) * states_stride + b] = (uint16_t)carry;
  }
  __syncthreads();  // publishes the ring's mbarriers
  if (tid == PRODUCER) ring.produce();
  if (tid != 0) return;
  int s;
  if (STATES) {
    uint16_t* col = states + b;
    const size_t stride = states_stride;
    s = walk_ring(ring, ex.t_top, ex.s, [&](int t, int s_eff, int) {
      col[(size_t)(t - t0) * stride] = (uint16_t)s_eff;
    });
    // event 0's row is filler: it passes s_eff through
    if (t0 == 0) col[0] = (uint16_t)s;
  } else {
    s = walk_ring(ring, ex.t_top, ex.s,
                  PackCodes<true>{codes + (size_t)b * code_bytes,
                                  ex.t_top - ex.n + 1, t0, t1});
  }
  state[b] = s;
}

// K6b on the ring: a block per read, which walks from the end argmax's
// state (K6b's rule, as K2's) over its rows with the from-state table
// `from_states` (deg, N) uint16 in shared memory after the ring's stages,
// and writes the state of every event to path (B, T).
__global__ void __launch_bounds__(THREADS)
viterbi_generic_traceback_ring_kernel(const float* __restrict__ final_alpha,
                                      const uint8_t* __restrict__ bps,
                                      const int32_t* __restrict__ length,
                                      int B, int T, int deg,
                                      const uint16_t* __restrict__ from_states,
                                      int stages, uint16_t* __restrict__ path,
                                      float* __restrict__ logp) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t table_bar;
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int len = length[b];
  // the walk's rows: events min(len, T) - 1 .. 1 (row t - 1 of bps)
  const Extent ex = extent(0, T, len, 0, 0);
  const Ring<> ring = make_ring(ring_buf, full, empty, stages,
                                bps + (size_t)b * N, (size_t)B * N, 1,
                                ex.t_top, ex.n);
  uint8_t* table = ring_buf + stages * STAGE_BYTES;
  const uint32_t tbar = nc::smem_addr(&table_bar);
  if (tid == PRODUCER) {
    // the table first (the walk's first event reads it), then the stages
    if (ex.n > 0) {
      nc::mbar_init_expect(tbar, deg * N * 2);
      for (int k = 0; k < deg; ++k)
        nc::bulk_copy(nc::smem_addr(table + k * N * 2),
                      from_states + (size_t)k * N, N * 2, tbar);
    }
    ring.start();
  }

  // first argmax of the final alpha: 4 states each, then the warps
  end_argmax_partials(final_alpha + (size_t)b * N, tid, w_best, w_idx);
  __syncthreads();  // also publishes the mbarriers
  if (tid == PRODUCER) ring.produce();
  if (tid >= 32 && tid < 64) return;  // the producer's warp
  // every other warp takes the argmax over the warps' partials
  float best;
  int idx;
  end_argmax(w_best, w_idx, lane, best, idx);
  uint16_t* out = path + (size_t)b * T;
  if (tid >= 64) {
    // past the walk's events the path holds the end state
    const int end_state = __shfl_sync(nc::FULL, idx, 0);
    for (int t = max(ex.t_top + 1, 1) + tid - 64; t < T; t += THREADS - 64)
      out[t] = (uint16_t)end_state;
    return;
  }
  if (tid != 0) return;

  logp[b] = best;
  int s = idx;
  if (ex.n > 0) {
    nc::mbar_wait(tbar, 0);
    s = walk_ring(
        ring, ex.t_top, idx,
        [&](int t, int s_eff, int) { out[t] = (uint16_t)s_eff; },
        TableFrom{nc::smem_addr(table)});
  }
  out[0] = (uint16_t)s;
}

// K2m: a block per read; table holds the M = N >> slice_shift ranks'
// (B, W) slices of the final column, then their (T - 1, B, W) backpointer
// rows (16-byte aligned).
constexpr int MAX_SLICES = 64;

__global__ void __launch_bounds__(THREADS)
viterbi_traceback_slices_kernel(const void* const* __restrict__ table,
                                const int32_t* __restrict__ length, int B,
                                int T, int code_bytes, int slice_shift,
                                int stages, int32_t* __restrict__ path0,
                                uint8_t* __restrict__ codes,
                                float* __restrict__ logp) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ const uint8_t* s_slices[MAX_SLICES];
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = 1 << slice_shift, M = N >> slice_shift;
  const int len = length[b];
  // the walk's rows: events min(len, T) - 1 .. 1 (row t - 1 of each slice)
  const Extent ex = extent(0, T, len, 0, 0);
  const size_t stride = (size_t)B * W;
  Ring<true> ring{ring_buf, full, empty, stages, nullptr, stride, ex.n};
  ring.slices = s_slices;
  ring.first = ex.n > 0 ? (size_t)(ex.t_top - 1) * stride + (size_t)b * W : 0;
  ring.shift = slice_shift;
  if (tid >= PRODUCER && tid < PRODUCER + 32) {
    // the producer warp alone reads the slice table
    for (int m = tid - PRODUCER; m < M; m += 32)
      s_slices[m] = static_cast<const uint8_t*>(table[M + m]);
    __syncwarp();
    ring.start();
  }

  uint8_t* out = codes + (size_t)b * code_bytes;
  for (int i = 3 * (ex.n > 0 ? ((ex.t_top - 1) >> 2) + 1 : 0) + tid;
       i < code_bytes; i += THREADS)
    out[i] = 0;

  // the thread's 4 states 4 tid .. 4 tid + 3 lie in one rank's slice
  const int j0 = 4 * tid;
  end_argmax_partials_at(static_cast<const float*>(table[j0 >> slice_shift]) +
                             (size_t)b * W + (j0 & (W - 1)),
                         tid, w_best, w_idx);
  __syncthreads();  // also publishes the ring's mbarriers
  if (tid >= PRODUCER && tid < PRODUCER + 32) ring.produce();
  if (tid >= 32) return;
  float best;
  int idx;
  end_argmax(w_best, w_idx, tid, best, idx);
  if (tid != 0) return;

  logp[b] = best;
  path0[b] = walk_ring(ring, ex.t_top, idx, PackCodes<false>{out, 1, 0, T});
}

// K6bm: a block per read, K6b's ring kernel on K2m's slices: table holds
// the M = N >> slice_shift ranks' (B, W) slices of the final column, then
// their (T - 1, B, W) backpointer rows (16-byte aligned).  The block takes
// K6b's end argmax over the column's slices, the producer warp assembles
// each row from the M slices (Ring<true>), and thread 0 walks with the
// from-state table `from` (deg, N) uint16 in shared memory after the
// ring's stages (kTable; the producer copies it first) or the (deg, N)
// int32 from_idx read from global memory, writing the state of every
// event to path (B, T); the other warps write the end state past the walk.
template <bool kTable>
__global__ void __launch_bounds__(THREADS)
viterbi_generic_traceback_slices_kernel(
    const void* const* __restrict__ table,
    const int32_t* __restrict__ length, int B, int T, int slice_shift,
    int deg, const void* __restrict__ from, int stages,
    uint16_t* __restrict__ path, float* __restrict__ logp) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t table_bar;
  __shared__ const uint8_t* s_slices[MAX_SLICES];
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int W = 1 << slice_shift, M = N >> slice_shift;
  const int len = length[b];
  // the walk's rows: events min(len, T) - 1 .. 1 (row t - 1 of each slice)
  const Extent ex = extent(0, T, len, 0, 0);
  const size_t stride = (size_t)B * W;
  Ring<true> ring{ring_buf, full, empty, stages, nullptr, stride, ex.n};
  ring.slices = s_slices;
  ring.first = ex.n > 0 ? (size_t)(ex.t_top - 1) * stride + (size_t)b * W : 0;
  ring.shift = slice_shift;
  uint8_t* tab = ring_buf + stages * STAGE_BYTES;
  const uint32_t tbar = nc::smem_addr(&table_bar);
  if (tid >= PRODUCER && tid < PRODUCER + 32) {
    // the producer warp alone reads the slice table
    for (int m = tid - PRODUCER; m < M; m += 32)
      s_slices[m] = static_cast<const uint8_t*>(table[M + m]);
    if (kTable && tid == PRODUCER && ex.n > 0) {
      // the from-state table first (the walk's first event reads it)
      nc::mbar_init_expect(tbar, deg * N * 2);
      for (int k = 0; k < deg; ++k)
        nc::bulk_copy(nc::smem_addr(tab + k * N * 2),
                      static_cast<const uint16_t*>(from) + (size_t)k * N,
                      N * 2, tbar);
    }
    __syncwarp();
    ring.start();
  }

  // the thread's 4 states 4 tid .. 4 tid + 3 lie in one rank's slice
  const int j0 = 4 * tid;
  end_argmax_partials_at(static_cast<const float*>(table[j0 >> slice_shift]) +
                             (size_t)b * W + (j0 & (W - 1)),
                         tid, w_best, w_idx);
  __syncthreads();  // also publishes the mbarriers
  if (tid >= PRODUCER && tid < PRODUCER + 32) {
    ring.produce();
    return;
  }
  // every other warp takes the argmax over the warps' partials
  float best;
  int idx;
  end_argmax(w_best, w_idx, lane, best, idx);
  uint16_t* out = path + (size_t)b * T;
  if (tid >= 64) {
    // past the walk's events the path holds the end state
    const int end_state = __shfl_sync(nc::FULL, idx, 0);
    for (int t = max(ex.t_top + 1, 1) + tid - 64; t < T; t += THREADS - 64)
      out[t] = (uint16_t)end_state;
    return;
  }
  if (tid != 0) return;

  logp[b] = best;
  int s = idx;
  if (ex.n > 0) {
    auto sink = [&](int t, int s_eff, int) { out[t] = (uint16_t)s_eff; };
    if constexpr (kTable) {
      nc::mbar_wait(tbar, 0);
      s = walk_ring(ring, ex.t_top, idx, sink, TableFrom{nc::smem_addr(tab)});
    } else {
      s = walk_ring(ring, ex.t_top, idx, sink,
                    IdxFrom{static_cast<const int32_t*>(from)});
    }
  }
  out[0] = (uint16_t)s;
}

// The ring's stages for B blocks of `threads`: the most that fit the blocks
// an SM holds at once, at most MAX_STAGES (192 KB: one block an SM), at
// least MIN_STAGES; with a table of table_bytes beside the ring (K6b), at
// most what the block's shared memory has left beside it.
int ring_stages(int B, int threads, int device, int table_bytes = 0,
                int static_bytes = TABLE_RING_STATIC) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int by_threads = 2048 / threads;
  int per_sm = (B + sms - 1) / sms;
  if (per_sm > by_threads) per_sm = by_threads;
  int s = MAX_STAGES / per_sm;
  if (table_bytes > 0) {
    const int fit = (SMEM_PER_BLOCK - static_bytes - table_bytes) /
                    (int)STAGE_BYTES;
    if (fit < s) s = fit;
  }
  return s < MIN_STAGES ? MIN_STAGES : s;
}

template <class Kernel>
cudaError_t set_ring_smem(Kernel kernel, int stages) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              stages * (int)STAGE_BYTES);
}

}  // namespace

// Plain C entry for ctypes.  bps (T-1, B, 4096) must be 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback(const float* final_alpha,
                                    const uint8_t* bps, const int32_t* length,
                                    int B, int T, int code_bytes,
                                    int32_t* path0, uint8_t* codes,
                                    float* logp, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0) {
    const int stages = ring_stages(B, THREADS, device);
    const cudaError_t err = set_ring_smem(viterbi_traceback_kernel, stages);
    if (err != cudaSuccess) return (int)err;
    viterbi_traceback_kernel<<<B, THREADS, stages * STAGE_BYTES,
                               (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, code_bytes, stages, path0, codes,
        logp);
  }
  return (int)cudaGetLastError();
}

// One chunk: bps holds the t1 - t0 rows of events [t0, t1) (16-byte
// aligned); state (B,) is read and written in place; codes (B, code_bytes)
// were zeroed before the first chunk.  Returns cudaGetLastError() after the
// launch.
extern "C" int nc_viterbi_traceback_chunk(const int32_t* end_state,
                                          int32_t* state, const uint8_t* bps,
                                          const int32_t* length, int B, int t0,
                                          int t1, int code_bytes,
                                          uint8_t* codes, int device,
                                          void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && t1 > (t0 > 1 ? t0 : 1)) {
    const int stages = ring_stages(B, CHUNK_THREADS, device);
    const cudaError_t err =
        set_ring_smem(viterbi_traceback_chunk_kernel<false>, stages);
    if (err != cudaSuccess) return (int)err;
    viterbi_traceback_chunk_kernel<false><<<B, CHUNK_THREADS,
                                            stages * STAGE_BYTES,
                                            (cudaStream_t)stream>>>(
        end_state, state, bps, length, B, t0, t1, code_bytes, stages, codes,
        nullptr, 0);
  }
  return (int)cudaGetLastError();
}

// K9's chunk: as above, but the states of events [t0, t1) go to `states`
// (t1 - t0 rows of states_stride uint16, the read's column b).  Returns
// cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback_chunk_states(
    const int32_t* end_state, int32_t* state, const uint8_t* bps,
    const int32_t* length, int B, int t0, int t1, uint16_t* states,
    int states_stride, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && t1 > t0) {
    const int stages = ring_stages(B, CHUNK_THREADS, device);
    const cudaError_t err =
        set_ring_smem(viterbi_traceback_chunk_kernel<true>, stages);
    if (err != cudaSuccess) return (int)err;
    viterbi_traceback_chunk_kernel<true><<<B, CHUNK_THREADS,
                                           stages * STAGE_BYTES,
                                           (cudaStream_t)stream>>>(
        end_state, state, bps, length, B, t0, t1, 0, stages, nullptr, states,
        states_stride);
  }
  return (int)cudaGetLastError();
}

// K6b on the ring: from_states (deg, N) uint16 (16-byte aligned) is the
// table's from-state copy, 1 to the most slots that leave MIN_STAGES stages
// beside it (24); bps (T-1, B, 4096) must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int nc_viterbi_generic_traceback_ring(
    const float* final_alpha, const uint8_t* bps, const int32_t* length,
    int B, int T, int deg, const uint16_t* from_states, uint16_t* path,
    float* logp, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (deg < 1 || deg * N * 2 + MIN_STAGES * (int)STAGE_BYTES >
                     SMEM_PER_BLOCK - TABLE_RING_STATIC)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int stages = ring_stages(B, THREADS, device, deg * N * 2);
    const int smem = stages * (int)STAGE_BYTES + deg * N * 2;
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_generic_traceback_ring_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_generic_traceback_ring_kernel<<<B, THREADS, smem,
                                            (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, deg, from_states, stages, path, logp);
  }
  return (int)cudaGetLastError();
}

// K2m: table is a device array of the M = 4096 >> slice_shift ranks' (B,
// 4096 / M) final slices, then their (T - 1, B, 4096 / M) backpointer rows
// (16-byte aligned; 6 <= slice_shift <= 12), on this card or on peers it
// can reach (nc_enable_peer_access).  Returns cudaGetLastError() after the
// launch.
extern "C" int nc_viterbi_traceback_slices(const void* table,
                                           const int32_t* length, int B,
                                           int T, int code_bytes,
                                           int slice_shift, int32_t* path0,
                                           uint8_t* codes, float* logp,
                                           int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (slice_shift < 6 || slice_shift > 12) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int stages = ring_stages(B, THREADS, device);
    const cudaError_t err =
        set_ring_smem(viterbi_traceback_slices_kernel, stages);
    if (err != cudaSuccess) return (int)err;
    viterbi_traceback_slices_kernel<<<B, THREADS, stages * STAGE_BYTES,
                                      (cudaStream_t)stream>>>(
        static_cast<const void* const*>(table), length, B, T, code_bytes,
        slice_shift, stages, path0, codes, logp);
  }
  return (int)cudaGetLastError();
}

// K6bm: table as K2m's; from_rule 1: `from` is the table's (deg, N)
// uint16 from-state copy (16-byte aligned, 1 to the most slots that leave
// MIN_STAGES stages beside it), 0: its (deg, N) int32 from_idx (any deg of
// 1 to 256); both on this card.  path (B, T) uint16, logp (B,).  Returns
// cudaGetLastError() after the launch.
extern "C" int nc_viterbi_generic_traceback_slices(
    const void* table, const int32_t* length, int B, int T, int slice_shift,
    int deg, const void* from, int from_rule, uint16_t* path, float* logp,
    int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int table_bytes = from_rule ? deg * N * 2 : 0;
  if (slice_shift < 6 || slice_shift > 12 || deg < 1 || deg > 256 ||
      table_bytes + MIN_STAGES * (int)STAGE_BYTES >
          SMEM_PER_BLOCK - SLICES_TABLE_STATIC)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int stages =
        ring_stages(B, THREADS, device, table_bytes, SLICES_TABLE_STATIC);
    const int smem = stages * (int)STAGE_BYTES + table_bytes;
    auto kernel = from_rule ? viterbi_generic_traceback_slices_kernel<true>
                            : viterbi_generic_traceback_slices_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const void* const*>(table), length, B, T, slice_shift,
        deg, from, stages, path, logp);
  }
  return (int)cudaGetLastError();
}

// Lets kernels on `device` read the memory of `peer` (K1m's exchange and
// K2m's copies across cards); a pair already enabled is not an error.
extern "C" int nc_enable_peer_access(int device, int peer) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clears it
    err = cudaSuccess;
  }
  return (int)err;
}

extern "C" const char* nc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
