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
//   v0 = stay[j] + alpha[j]; v1 = step[j] + m4[j>>2]; v2 = skip[j] + m16[j>>4]
//   best = max(v0, v1, v2); ties go to the lowest from-state
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
// Design: one block per read, 1024 threads, 4 states per thread; the time
// loop runs inside the block, so a whole read (or chunk) is one launch.
// alpha lives in shared memory (16 KB; one buffer suffices because each
// thread keeps its own 4 states in registers and the two barriers per step
// separate the column reductions from the updates).  The 9 per-read tables
// are loaded once into registers.  Each thread stores its 4 backpointer
// bytes as one 32-bit word, so a warp writes 128 contiguous bytes of a bp
// row.  The chunk form is the template instance CHUNK = true of the same
// kernel: it reads alpha from the carry at t0 > 0 and reads events t0..t1-1
// of the (B, ev_stride) event rows in place, and runs the one step body, so
// chunked and full scans are bit-identical by construction.
//
// What bounds it: the two block barriers per step and the serial 16-row
// column max (256 threads do it while 768 wait), plus 4096 bytes of
// backpointer stores per read and step.  A chunk of 8192 events bounds one
// launch's length (a 100k-event read is 13 launches, not one); the bytes
// and operations are those of the full scan.  Making it fast (several reads
// per block, warp-level column reductions, fewer barriers) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to the
// plain version in nanocall_tpu_torch/ops/hmm.py on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "device_guard.cuh"

namespace {

constexpr int N = 4096;
constexpr int N4 = N / 4;
constexpr int N16 = N / 16;
constexpr int THREADS = 1024;
constexpr int BIG = 0x7fffffff;

using nc::emission;

// CHUNK = false: K1, events [0, t1) with t0 = 0; CHUNK = true: one chunk.
template <bool CHUNK>
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
  __shared__ float alpha[N];
  __shared__ float m4[N4];
  __shared__ uint8_t g4[N4];
  __shared__ float m16[N16];
  __shared__ uint8_t g16[N16];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N + 4 * tid;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_lls[4], r_sm[4],
      r_slam[4], r_lsl[4];
  {
    const float4 v0 = *reinterpret_cast<const float4*>(stay + row);
    const float4 v1 = *reinterpret_cast<const float4*>(step + row);
    const float4 v2 = *reinterpret_cast<const float4*>(skip + row);
    const float4 v3 = *reinterpret_cast<const float4*>(level_mean + row);
    const float4 v4 = *reinterpret_cast<const float4*>(level_stdv + row);
    const float4 v5 = *reinterpret_cast<const float4*>(log_level_stdv + row);
    const float4 v6 = *reinterpret_cast<const float4*>(sd_mean + row);
    const float4 v7 = *reinterpret_cast<const float4*>(sd_lambda + row);
    const float4 v8 = *reinterpret_cast<const float4*>(log_sd_lambda + row);
#define NC_UNPACK(dst, v) \
  dst[0] = v.x;           \
  dst[1] = v.y;           \
  dst[2] = v.z;           \
  dst[3] = v.w;
    NC_UNPACK(r_stay, v0)
    NC_UNPACK(r_step, v1)
    NC_UNPACK(r_skip, v2)
    NC_UNPACK(r_lm, v3)
    NC_UNPACK(r_ls, v4)
    NC_UNPACK(r_lls, v5)
    NC_UNPACK(r_sm, v6)
    NC_UNPACK(r_slam, v7)
    NC_UNPACK(r_lsl, v8)
#undef NC_UNPACK
  }
  // event t of read b: column t - ev_t0 of its row
  const float* evm = ev_mean + (size_t)b * ev_stride;
  const float* evs = ev_stdv + (size_t)b * ev_stride;
  const float* evl = ev_log_stdv + (size_t)b * ev_stride;
  const int len = length[b];
  // bp row of event t: bps[t - row0]
  const int row0 = CHUNK ? t0 : 1;

  float a[4];
  int t = t0;
  if (t0 == 0) {
    const int c = -ev_t0;
    const float x = evm[c], y = evs[c], ly = evl[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                      r_slam[i], r_lsl[i], log2pi) -
             log_n;
      alpha[4 * tid + i] = a[i];
    }
    if (CHUNK && bps != nullptr)
      reinterpret_cast<uint32_t*>(bps + (size_t)b * N)[tid] = 0u;
    t = 1;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(carry_alpha + row);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[4 * tid + i] = a[i];
  }
  __syncthreads();

  for (; t < t1; ++t) {
    // column maxima with first-occurrence argmax (strict > in increasing r)
    {
      float m = alpha[tid];
      int g = 0;
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        const float v = alpha[r * N4 + tid];
        if (v > m) {
          m = v;
          g = r;
        }
      }
      m4[tid] = m;
      g4[tid] = (uint8_t)g;
    }
    if (tid < N16) {
      float m = alpha[tid];
      int g = 0;
#pragma unroll
      for (int r = 1; r < 16; ++r) {
        const float v = alpha[r * N16 + tid];
        if (v > m) {
          m = v;
          g = r;
        }
      }
      m16[tid] = m;
      g16[tid] = (uint8_t)g;
    }
    __syncthreads();

    const int c = t - ev_t0;
    const float x = evm[c], y = evs[c], ly = evl[c];
    const bool active = t < len;
    const float mm4 = m4[tid];
    const int gg4 = g4[tid];
    const float mm16 = m16[tid >> 2];
    const int gg16 = g16[tid >> 2];
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * tid + i;
      const float v0 = r_stay[i] + a[i];
      const float v1 = r_step[i] + mm4;
      const float v2 = r_skip[i] + mm16;
      const float best = fmaxf(fmaxf(v0, v1), v2);
      const int k0 = v0 == best ? j : BIG;
      const int k1 = v1 == best ? ((gg4 << 10) | (j >> 2)) : BIG;
      const int k2 = v2 == best ? ((gg16 << 8) | (j >> 4)) : BIG;
      const int fmin = min(min(k0, k1), k2);
      const uint32_t bp =
          k0 == fmin ? 0u : (k1 == fmin ? 64u + gg4 : 128u + gg16);
      packed |= bp << (8 * i);
      const float em = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                                r_slam[i], r_lsl[i], log2pi);
      if (active) a[i] = best + em;
    }
    if (bps != nullptr) {
      reinterpret_cast<uint32_t*>(bps + ((size_t)(t - row0) * B + b) * N)[tid] =
          packed;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[4 * tid + i] = a[i];
    __syncthreads();
  }
  *reinterpret_cast<float4*>(final_alpha + row) =
      make_float4(a[0], a[1], a[2], a[3]);
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
    viterbi_forward_kernel<false><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, 0, 0, T, nullptr, stay,
        step, skip, level_mean, level_stdv, log_level_stdv, sd_mean,
        sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps);
  }
  return (int)cudaGetLastError();
}

// One chunk, events [t0, t1) of (B, ev_stride) event rows whose column 0
// holds event ev_t0 (ev_t0 <= t0); carry_alpha (B, 4096) is alpha at event
// t0 - 1 (unread when t0 == 0); bps holds t1 - t0 rows of (B, 4096).
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
  if (B > 0 && t1 > t0) {
    viterbi_forward_kernel<true><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, ev_stride, ev_t0, t0, t1,
        carry_alpha, stay, step, skip, level_mean, level_stdv, log_level_stdv,
        sd_mean, sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps);
  }
  return (int)cudaGetLastError();
}
