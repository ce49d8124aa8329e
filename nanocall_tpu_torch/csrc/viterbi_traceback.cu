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
// Design: one block per read.  For K2, all 1024 threads reduce the final
// alpha (4 states each, then warp shuffles, ties to the lower index,
// matching argmax's first occurrence); one thread then walks the read
// backwards.  A chunk's walk runs on one thread per read.  A direct byte
// load of the bp row at s replaces the TPU kernel's two-stage one-hot lookup.
//
// What bounds it: the walk is a chain of dependent byte loads from device
// memory, one per event, so a read takes T load latencies; reads run in
// parallel, one block each.  Nothing here is tuned yet.

#include <cuda_runtime.h>
#include <stdint.h>

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
    const int s_eff = t == len - 1 ? end_state : s;
    const int k = bp_b[(size_t)(t - row0) * row_stride + s_eff];
    const bool real = t <= len - 1;
    const int group = k >> 6;
    const int arg = k & 63;
    const int s_prev = group == 0   ? s_eff
                       : group == 1 ? ((arg << 10) | (s_eff >> 2))
                                    : ((arg << 8) | (s_eff >> 4));
    s = real ? s_prev : s_eff;
    const uint32_t code = real ? (uint32_t)((group << 4) | (s_eff & 15)) : 0u;
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
__global__ void __launch_bounds__(32)
viterbi_traceback_chunk_kernel(const int32_t* __restrict__ end_state,
                               int32_t* __restrict__ state,
                               const uint8_t* __restrict__ bps,
                               const int32_t* __restrict__ length, int B,
                               int t0, int t1, int code_bytes,
                               uint8_t* __restrict__ codes) {
  const int b = blockIdx.x * 32 + threadIdx.x;
  if (b >= B) return;
  // event 0's row is filler that passes the state through (JAX: real is
  // false at t = 0), so the walk stops at event 1
  state[b] = walk<true>(bps + (size_t)b * N, (size_t)B * N, t0, t1,
                        t0 > 1 ? t0 : 1, length[b], end_state[b], state[b],
                        codes + (size_t)b * code_bytes);
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int nc_viterbi_traceback(const float* final_alpha,
                                    const uint8_t* bps, const int32_t* length,
                                    int B, int T, int code_bytes,
                                    int32_t* path0, uint8_t* codes,
                                    float* logp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && t1 > (t0 > 1 ? t0 : 1)) {
    viterbi_traceback_chunk_kernel<<<(B + 31) / 32, 32, 0,
                                     (cudaStream_t)stream>>>(
        end_state, state, bps, length, B, t0, t1, code_bytes, codes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
