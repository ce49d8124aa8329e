// K6a: generic max-plus Viterbi forward under a loaded transition table,
// and K6b: its traceback into a full state path.
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
// Design: one block per read, 1024 threads x 4 contiguous states, the time
// loop inside the block, as K1.  alpha lives in shared memory (16 KB), since
// any state may be any state's predecessor; each thread keeps its own 4
// states in registers, and two barriers per step separate the gathers
// from the update.  The slot tables (21 x 4096 x 8 B = 688 KB for the r73
// tables) do not fit on chip: each thread reads its 4 states' slots as one
// int4 and one float4 per slot, coalesced over j, from L2, where the tables
// stay resident.  The traceback reduces the final alpha with all threads
// and walks the read with one, as K2.
//
// What bounds it: per step, deg x 32 KB of table reads from L2 per read and
// deg x 4096 shared-memory gathers; the traceback's chain of 2(T-1)
// dependent loads (backpointer, then from_idx).  Only B of the 132 SMs
// work when B < 132.  Speed work (several reads per block sharing one table
// read, tables in fewer bits) is later work.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernels are bit-identical to
// viterbi_forward_plain / viterbi_traceback_plain in
// nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"

namespace {

using namespace nc;

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
  __shared__ float alpha[N];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)b * N + 4 * tid;

  float r_lm[4], r_ls[4], r_lls[4], r_sm[4], r_slam[4], r_lsl[4];
  unpack4(r_lm, load4(level_mean + row));
  unpack4(r_ls, load4(level_stdv + row));
  unpack4(r_lls, load4(log_level_stdv + row));
  unpack4(r_sm, load4(sd_mean + row));
  unpack4(r_slam, load4(sd_lambda + row));
  unpack4(r_lsl, load4(log_sd_lambda + row));
  const int4* fidx = reinterpret_cast<const int4*>(from_idx) + tid;
  const float4* flp = reinterpret_cast<const float4*>(from_logp) + tid;
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];

  float a[4];
  {
    const float x = evm[0], y = evs[0], ly = evl[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i], r_sm[i],
                      r_slam[i], r_lsl[i], log2pi) -
             log_n;
      alpha[4 * tid + i] = a[i];
    }
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
      for (int i = 0; i < 4; ++i) {
        const float v = lp[i] + alpha[id[i]];
        if (k == 0) {
          best[i] = v;
          bfrom[i] = id[i];
          bslot[i] = 0;
        } else if (v > best[i] || (v != v && best[i] == best[i])) {
          best[i] = v;
          bfrom[i] = id[i];
          bslot[i] = k;
        } else if (kPath && v == best[i] && id[i] < bfrom[i]) {
          bfrom[i] = id[i];
          bslot[i] = k;
        }
      }
    }
    const float x = evm[t], y = evs[t], ly = evl[t];
    const bool active = t < len;
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = best[i] != best[i] ? 0 : bslot[i];
      packed |= (uint32_t)slot << (8 * i);
      const float em = emission(x, y, ly, r_lm[i], r_ls[i], r_lls[i],
                                r_sm[i], r_slam[i], r_lsl[i], log2pi);
      if (active) a[i] = best[i] + em;
    }
    if (kPath) {
      reinterpret_cast<uint32_t*>(bps + ((size_t)(t - 1) * B + b) * N)[tid] =
          packed;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[4 * tid + i] = a[i];
    __syncthreads();
  }
  *reinterpret_cast<float4*>(final_alpha + row) =
      make_float4(a[0], a[1], a[2], a[3]);
}

// torch.argmax's order: a NaN above every number, ties to the lower index
__device__ __forceinline__ void take_better(float& best, int& idx, float ob,
                                            int oi) {
  const bool o_nan = ob != ob, b_nan = best != best;
  const bool take = (o_nan || b_nan) ? o_nan && (!b_nan || oi < idx)
                                     : ob > best || (ob == best && oi < idx);
  if (take) {
    best = ob;
    idx = oi;
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
  float best = fa[4 * tid];
  int idx = 4 * tid;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    take_better(best, idx, fa[4 * tid + i], 4 * tid + i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, idx, off);
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
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, idx, off);
    take_better(best, idx, ob, oi);
  }
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
// (no backpointer stores).  Each returns cudaGetLastError() after the
// launch.
extern "C" int nc_viterbi_generic_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, int deg, const int32_t* from_idx,
    const float* from_logp, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, float log2pi, float log_n, float* final_alpha,
    uint8_t* bps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && T > 0) {
    if (bps != nullptr) {
      viterbi_generic_forward_kernel<true>
          <<<B, THREADS, 0, (cudaStream_t)stream>>>(
              ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, from_idx,
              from_logp, level_mean, level_stdv, log_level_stdv, sd_mean,
              sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps);
    } else {
      viterbi_generic_forward_kernel<false>
          <<<B, THREADS, 0, (cudaStream_t)stream>>>(
              ev_mean, ev_stdv, ev_log_stdv, length, B, T, deg, from_idx,
              from_logp, level_mean, level_stdv, log_level_stdv, sd_mean,
              sd_lambda, log_sd_lambda, log2pi, log_n, final_alpha, bps);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int nc_viterbi_generic_traceback(
    const float* final_alpha, const uint8_t* bps, const int32_t* length,
    int B, int T, const int32_t* from_idx, uint16_t* path, float* logp,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    viterbi_generic_traceback_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        final_alpha, bps, length, B, T, from_idx, path, logp);
  }
  return (int)cudaGetLastError();
}
