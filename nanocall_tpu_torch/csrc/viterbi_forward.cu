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
// K1m, the third instance (SLICE = true), is K1 with the 4096 states split
// over M ranks (the production decode under nanocall_tpu/parallel/
// mesh.py:103 shard_pooled_decode_inputs, whose 'model' axis cuts the
// bank's states; parallel/statepar.py drives it).  A launch is one step of
// one rank: it reads the whole column of event t - 1, gathered from every
// rank's slice (state j's step and skip predecessors 1024 r + (j >> 2) and
// 256 r + (j >> 4) lie in every slice), takes K1's column maxima over all
// of it, and runs K1's step body only for its own destination states
// (W = 4096 / M of them; thread c keeps those of its four states 1024 r +
// c that lie in the slice), so it is bit-identical to K1 by construction.
// Its tables, emissions and bp bytes are the slice's: (B, W) rows, and a
// bp row of W bytes stored as W / 4 words.  What bounds K1m: a launch per
// step and rank, and the host that enqueues them and the column's
// exchange (M (M - 1) slice copies a step); on the card, K1's step issue
// for W states plus the column (16 KB a read) and the rank's 9 tables
// (36 W bytes a read) loaded again every step.
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

// CHUNK = false: K1, events [0, t1) with t0 = 0; CHUNK = true: one chunk.
// kPath: write backpointers.  SLICE = true: K1m, one step t = t0 (t1 = t0
// + 1) for the rank that holds the states [slice_lo, slice_lo + W), W = 1
// << slice_shift: it reads alpha of event t - 1 from carry_alpha, the
// gathered column (N / W, B, W) whose slice m holds the states [m W, (m +
// 1) W), and its (B, W) tables; it writes alpha of event t at its states
// to final_alpha (B, W) and their bp bytes to bps, event t's (B, W) row.
// At t = 0 it writes alpha = emission - log(n) at its states.
template <bool CHUNK, bool kPath, bool SLICE = false>
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
                       uint8_t* __restrict__ bps, int slice_lo,
                       int slice_shift) {
  __shared__ MaxKey s4[2][P4N];
  __shared__ MaxKey s16[2][P16N];
  __shared__ uint32_t stage[kPath ? 2 : 1][kPath ? P4N : 1];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, k = lane & 7;
  const int c16 = warp * 8 + k;  // the thread's column of the 16 x 256 view
  const int c = q * N16 + c16;   // and of the 4 x 1024 view
  const size_t rowb = (size_t)b * N;
  // SLICE: the thread's states 1024 r + c that lie in the rank's slice, and
  // each one's index in the rank's (B, W) rows; else all four, in (B, N)
  const int W = SLICE ? 1 << slice_shift : N;
  bool own[4];
  size_t at[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = r * N4 + c;
    own[r] = !SLICE || (unsigned)(j - slice_lo) < (unsigned)W;
    at[r] = SLICE ? (size_t)b * W + (j - slice_lo) : rowb + j;
  }

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_nlls[4],
      r_sm[4], r_slam[4], r_c1[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (!own[r]) {
      r_stay[r] = r_step[r] = r_skip[r] = r_lm[r] = r_ls[r] = r_nlls[r] =
          r_sm[r] = r_slam[r] = r_c1[r] = 0.0f;
      continue;
    }
    const size_t j = at[r];
    r_stay[r] = stay[j];
    r_step[r] = step[j];
    r_skip[r] = skip[j];
    r_lm[r] = level_mean[j];
    r_ls[r] = level_stdv[j];
    r_nlls[r] = -log_level_stdv[j];
    r_sm[r] = sd_mean[j];
    r_slam[r] = sd_lambda[j];
    r_c1[r] = log_sd_lambda[j] - log2pi;
  }
  // event t of read b: column t - ev_t0 of its row
  const float* evm = ev_mean + (size_t)b * ev_stride - ev_t0;
  const float* evs = ev_stdv + (size_t)b * ev_stride - ev_t0;
  const float* evl = ev_log_stdv + (size_t)b * ev_stride - ev_t0;
  const int len = length[b];
  // bp row of event t: bps[t - row0] (SLICE: bps is the step's row)
  const int row0 = CHUNK || SLICE ? t0 : 1;

  float a[4];
  int t = t0;
  if (t0 == 0) {
    const float x = evm[0], y = evs[0], ly3 = 3.0f * evl[0];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = own[r] ? emission_pre(x, y, ly3, r_lm[r], r_ls[r], r_nlls[r],
                                   r_sm[r], r_slam[r], r_c1[r], log2pi) -
                          log_n
                    : 0.0f;
    if (CHUNK && kPath) reinterpret_cast<uint32_t*>(bps + rowb)[tid] = 0u;
    t = 1;
  } else if (SLICE) {
    // every state of the gathered column: the maxima need them all
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = r * N4 + c;
      a[r] = carry_alpha[((size_t)(j >> slice_shift) * B + b) * W +
                         (j & (W - 1))];
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = carry_alpha[rowb + r * N4 + c];
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
    const float x = xn, y = yn, ly3 = 3.0f * lyn;
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
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!own[r]) continue;
      const MaxKey v4 = r4[r * R4];
      const MaxKey v16 = r16[r * R16];
      const float v0 = r_stay[r] + a[r];
      const float v1 = r_step[r] + v4.m;
      const float v2 = r_skip[r] + v16.m;
      const float best = amax(amax(v0, v1), v2);
      if (kPath) {
        const int k0 = v0 == best ? kj + (r << 18) : NOKEY;
        const int k1 = v1 == best ? v4.key + kq + (r << 16) : NOKEY;
        const int k2 = v2 == best ? v16.key + kh + (r << 14) : NOKEY;
        st[r * 4 * R4] = (uint8_t)min(min(k0, k1), k2);
      }
      const float em = emission_pre(x, y, ly3, r_lm[r], r_ls[r], r_nlls[r],
                                    r_sm[r], r_slam[r], r_c1[r], log2pi);
      if (active) a[r] = best + em;
    }
    par ^= 1;
  }
  if (kPath && t1 > first) {
    __syncthreads();
    store_stage(t1 - 1, par ^ 1);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (own[r]) final_alpha[at[r]] = a[r];
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
        sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps, 0, 12);
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
            final_alpha, bps, 0, 12);
  }
  return (int)cudaGetLastError();
}

// K1m's column exchange: `bytes` from src on src_device to dst on
// dst_device, on `stream` of dst_device (peer to peer across cards, with or
// without peer access).  Returns the copy's enqueue error.
extern "C" int nc_copy_async(void* dst, int dst_device, const void* src,
                             int src_device, size_t bytes, void* stream) {
  const nc::DeviceGuard guard(dst_device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)(dst_device == src_device
                   ? cudaMemcpyAsync(dst, src, bytes,
                                     cudaMemcpyDeviceToDevice,
                                     (cudaStream_t)stream)
                   : cudaMemcpyPeerAsync(dst, dst_device, src, src_device,
                                         bytes, (cudaStream_t)stream));
}

// K1m: event t's step for the rank of the states [slice_lo, slice_lo + W),
// W = 1 << slice_shift (64 <= W <= 4096, slice_lo a multiple of W): column
// (N / W, B, W) is the gathered alpha of event t - 1 (unread at t = 0),
// the tables (B, W) the rank's, alpha_out (B, W) its alpha of event t;
// bps (B, W), or nullptr for the score-only instance, gets event t's
// backpointers (t >= 1).  Events (B, T) are read in place.
extern "C" int nc_viterbi_forward_slice(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int t, const float* column,
    const float* stay, const float* step, const float* skip,
    const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* alpha_out,
    uint8_t* bps, int slice_lo, int slice_shift, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (slice_shift < 6 || slice_shift > 12 || t < 0 || t >= T ||
      slice_lo < 0 || slice_lo >= nc::N ||
      (slice_lo & ((1 << slice_shift) - 1)))
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    auto kernel = bps != nullptr ? viterbi_forward_kernel<false, true, true>
                                 : viterbi_forward_kernel<false, false, true>;
    kernel<<<B, nc::THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, 0, t, t + 1, column,
        stay, step, skip, level_mean, level_stdv, log_level_stdv, sd_mean,
        sd_lambda, log_sd_lambda, log2pi, log_n, alpha_out, bps, slice_lo,
        slice_shift);
  }
  return (int)cudaGetLastError();
}
