// K2: grouped Viterbi traceback into bit-packed 6-bit codes, and K3's
// traceback half: the same walk over one chunk of backpointer rows.
//
// K2 replaces nanocall_tpu/ops/hmm.py viterbi_traceback_grouped(compact=True)
// + _lookup_bp + grouped_from_state + _pack_codes; the chunk form replaces
// viterbi_traceback_grouped_chunk (hmm.py:437), the traceback half of
// viterbi_decode_grouped_tchunk (hmm.py:614).  Per read b:
//   end_state = first argmax of final_alpha[b], logp = its max;
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
// nanocall_tpu/parallel/seqpar.py:40) is the template twin STATES = true of
// the chunk kernel: the same step, but it writes the state s_eff of every
// event t0 .. t1-1 (event 0 included, where it passes s_eff through) as a
// uint16 into row t - t0 of a (t1 - t0, row_stride) states buffer, JAX's
// non-compact output (nanocall_tpu/ops/hmm.py:464-483).  States, not packed
// codes, because K9's ranks walk their slices on streams of their own, so
// two ranks must never share a 3-byte group, and JAX's K9 returns states.
//
// Design: one block per read.  For K2, all 1024 threads reduce the final
// alpha (4 states each, then warp shuffles, ties to the lower index,
// matching argmax's first occurrence); one thread then walks the read
// backwards.  A chunk's walk runs on one thread per read.  A direct byte
// load of the bp row at s replaces the TPU kernel's two-stage one-hot lookup.
//
// What bounds it: the walk is a chain of dependent byte loads from device
// memory, one per event, so a read takes T load latencies; reads run in
// parallel, one block each.  Nothing here is tuned yet.
//
// What bounds K9 as a whole: K3's forward operations (one chunk kernel per
// rank and block) and this walk's dependent byte loads, over D * M launches
// of each half for D ranks and M blocks, with a pipeline fill of
// (D - 1) / (M + D - 1) of the microsteps in which some rank waits.  The
// design does nothing about it yet: it is the simple kernel that is right.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int N = 4096;
constexpr int THREADS = 1024;

__device__ __forceinline__ void take_better(float& best, int& idx, float ob,
                                            int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

// One step of every walk, at event t from state s: s_eff (the state at
// event t, clamped to the end state at the read's last event), the state at
// event t - 1, and the 6-bit code.  Event 0's row and padded events pass
// s_eff through with code 0.
struct Step {
  int s_eff, s, code;
};

__device__ __forceinline__ Step step(const uint8_t* __restrict__ bp_row,
                                     int t, int len, int end_state, int s) {
  const int s_eff = t == len - 1 ? end_state : s;
  const int k = bp_row[s_eff];
  const bool real = t >= 1 && t <= len - 1;
  const int group = k >> 6;
  const int arg = k & 63;
  const int s_prev = group == 0   ? s_eff
                     : group == 1 ? ((arg << 10) | (s_eff >> 2))
                                  : ((arg << 8) | (s_eff >> 4));
  return {s_eff, real ? s_prev : s_eff,
          real ? ((group << 4) | (s_eff & 15)) : 0};
}

// The walk over events t_hi-1 .. t_lo (t_lo >= 1) of one read from state s;
// event t's bp row is bp_b[(t - row0) * row_stride].  Codes are stored into
// `out`, or ORed into it when OR_CODES (a group shared with another chunk).
// Returns the state before event t_lo.
template <bool OR_CODES>
__device__ __forceinline__ int walk(const uint8_t* __restrict__ bp_b,
                                    size_t row_stride, int row0, int t_hi,
                                    int t_lo, int len, int end_state, int s,
                                    uint8_t* __restrict__ out) {
  uint32_t w = 0;
  for (int t = t_hi - 1; t >= t_lo; --t) {
    const Step st =
        step(bp_b + (size_t)(t - row0) * row_stride, t, len, end_state, s);
    s = st.s;
    const uint32_t code = (uint32_t)st.code;
    const int i = t - 1;
    w |= code << (6 * (i & 3));
    if ((i & 3) == 0 || t == t_lo) {
      uint8_t* o = out + 3 * (i >> 2);
      if (OR_CODES) {
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
  return s;
}

__global__ void __launch_bounds__(THREADS)
viterbi_traceback_kernel(const float* __restrict__ final_alpha,
                         const uint8_t* __restrict__ bps,
                         const int32_t* __restrict__ length, int B, int T,
                         int code_bytes, int32_t* __restrict__ path0,
                         uint8_t* __restrict__ codes,
                         float* __restrict__ logp) {
  __shared__ float w_best[THREADS / 32];
  __shared__ int w_idx[THREADS / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* fa = final_alpha + (size_t)b * N;

  float best = fa[4 * tid];
  int idx = 4 * tid;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float v = fa[4 * tid + i];
    if (v > best) {
      best = v;
      idx = 4 * tid + i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_better(best, idx, ob, oi);
  }
  if ((tid & 31) == 0) {
    w_best[tid >> 5] = best;
    w_idx[tid >> 5] = idx;
  }
  __syncthreads();
  if (tid >= 32) return;
  best = w_best[tid];
  idx = w_idx[tid];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_better(best, idx, ob, oi);
  }
  if (tid != 0) return;

  const int end_state = idx;
  logp[b] = best;
  path0[b] = walk<false>(bps + (size_t)b * N, (size_t)B * N, 1, T, 1,
                         length[b], end_state, end_state,
                         codes + (size_t)b * code_bytes);
}

// One chunk of rows, events [t0, t1): one thread per read walks from
// state[b] and leaves the state for the chunk to its left in state[b].
// STATES = false (K3) ORs the packed codes into `codes`; STATES = true (K9)
// writes the states into `states` (row t - t0, column b, rows of
// states_stride).
template <bool STATES>
__global__ void __launch_bounds__(32)
viterbi_traceback_chunk_kernel(const int32_t* __restrict__ end_state,
                               int32_t* __restrict__ state,
                               const uint8_t* __restrict__ bps,
                               const int32_t* __restrict__ length, int B,
                               int t0, int t1, int code_bytes,
                               uint8_t* __restrict__ codes,
                               uint16_t* __restrict__ states,
                               int states_stride) {
  const int b = blockIdx.x * 32 + threadIdx.x;
  if (b >= B) return;
  const uint8_t* bp_b = bps + (size_t)b * N;
  const size_t row_stride = (size_t)B * N;
  if (STATES) {
    const int len = length[b], end = end_state[b];
    int s = state[b];
    for (int t = t1 - 1; t >= t0; --t) {
      const Step st =
          step(bp_b + (size_t)(t - t0) * row_stride, t, len, end, s);
      states[(size_t)(t - t0) * states_stride + b] = (uint16_t)st.s_eff;
      s = st.s;
    }
    state[b] = s;
    return;
  }
  // event 0's row is filler that passes the state through (JAX: real is
  // false at t = 0), so the walk stops at event 1
  state[b] = walk<true>(bp_b, row_stride, t0, t1, t0 > 1 ? t0 : 1, length[b],
                        end_state[b], state[b],
                        codes + (size_t)b * code_bytes);
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback(const float* final_alpha,
                                    const uint8_t* bps, const int32_t* length,
                                    int B, int T, int code_bytes,
                                    int32_t* path0, uint8_t* codes,
                                    float* logp, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0) {
    viterbi_traceback_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, code_bytes, path0, codes, logp);
  }
  return (int)cudaGetLastError();
}

// One chunk: bps holds the t1 - t0 rows of events [t0, t1); state (B,) is
// read and written in place; codes (B, code_bytes) were zeroed before the
// first chunk.  Returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback_chunk(const int32_t* end_state,
                                          int32_t* state, const uint8_t* bps,
                                          const int32_t* length, int B, int t0,
                                          int t1, int code_bytes,
                                          uint8_t* codes, int device,
                                          void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && t1 > (t0 > 1 ? t0 : 1)) {
    viterbi_traceback_chunk_kernel<false><<<(B + 31) / 32, 32, 0,
                                            (cudaStream_t)stream>>>(
        end_state, state, bps, length, B, t0, t1, code_bytes, codes, nullptr,
        0);
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
    viterbi_traceback_chunk_kernel<true><<<(B + 31) / 32, 32, 0,
                                           (cudaStream_t)stream>>>(
        end_state, state, bps, length, B, t0, t1, 0, nullptr, states,
        states_stride);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
