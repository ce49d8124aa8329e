// K4: grouped log-sum-exp forward over all T events of a read (the EM
// E-step's forward half).
//
// Replaces nanocall_tpu/ops/hmm.py fwbw_grouped_forward (+ log_emission,
// inlined), a lax.scan body that XLA compiled for the TPU.  Per step
// t = 1..T-1 and destination state j (n = 4096, K = 6):
//   m      = max over j of alpha[j] (NaN-propagating, torch.amax)
//   E[j]   = exp(alpha[j] - m)
//   S4[c]  = sum over r = 0..3  of E[r*1024 + c]   (added in r order)
//   S16[c] = sum over r = 0..15 of E[r*256 + c]    (added in r order)
//   total  = e_stay[j] E[j] + e_step[j] (S4[j>>2] - H[j] E[j])
//            + e_skip[j] (S16[j>>4] - P2mH[j] E[j] - S5[j] S4[j>>2])
//   alpha'[j] = t < length ? (em(t, j) + m) + log(total) : alpha[j]
// with alpha0 = em(0, j) - log(n).  alphas[t] (T, B, n) holds the carry
// after event t, so rows past a read's length repeat its last alpha, as
// the JAX scan's ys do; without an alphas buffer nothing is stored per step.
// log_pr_data = mfin + log(sum_j exp(final[j] - mfin)), mfin the
// NaN-propagating max, the sum as the pairwise tree of ops/hmm.py tree_sum.
//
// Design (for the H100): one block per read, 1024 threads, the time loop
// inside the block (one launch per EM round), alpha in registers only, in
// K1's column layout (viterbi_forward.cu): thread (warp w, lane 8q + k)
// owns column c = 256q + 8w + k of the 4 x 1024 view, the states
// j = 1024r + c, r < 4.
//   - S4[c] is a sum over the thread's own 4 registers, in r order.
//   - S16[c16] (c16 = 8w + k) needs the rows r16 = 4r + q' in increasing
//     r16 order; row 4r + q' is register r of lane 8q' + k of the same
//     warp.  sum16 takes the 16 values by shuffles, which do not depend on
//     each other, and adds them in r16 order in every lane of the column:
//     no shared memory, no serial loop on a subset of threads.
//   - Two block barriers a step: (1) the block max, from the per-warp
//     maxima published at the end of the step before (NaN-propagating from
//     step 0); (2) the S4 and S16 columns, written to padded shared arrays
//     (K1's p4 / p16: free of bank conflicts) and read back at j>>2 and
//     j>>4.  Barrier 1 also separates a step's reads of the column arrays
//     from the next step's writes, so single buffers suffice.
//   - The maxima propagate NaN as torch.amax does, at fmaxf's cost: fmaxf
//     and one vote for NaN (common.cuh warp_max_nan; fmaxf alone drops a
//     NaN).
//   - The 9 per-read tables live in registers, with -log_level_stdv and
//     log_sd_lambda - log2pi taken once per read (emission_pre).
//   - Alphas are stored per row r: 4 runs of 32 B (whole sectors) per warp
//     and row.  The fit-only variant (alphas == nullptr) stores nothing per
//     step.
//
// What bounds it: issue on the read's one SM (per state and step one exp,
// one log, the emission's 3 IEEE divisions, 4 shuffles of sum16) and the 2
// barriers; then the 16 KB alpha store per read and step.  Only B of the
// 132 SMs work when B < 132.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_grouped_forward_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "common.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

// bits of the per-state flag byte (ops/hmm.py FWD_FLAG_BITS)
constexpr unsigned F_H = 1u, F_P2 = 2u, F_S5 = 4u;

// Padded slots of the S4 and S16 column arrays (K1's), free of bank
// conflicts for the step's writes (column c, c16) and reads (j>>2, j>>4):
// tests/test_torch_kernel_forms.py
__device__ __forceinline__ int p4(int i) { return i + 2 * (i >> 6); }
__device__ __forceinline__ int p16(int i) { return i + (i >> 4); }
constexpr int P4N = N4 + 2 * (N4 >> 6);
constexpr int P16N = N16 + (N16 >> 4);
// state j = 1024 r + c reads S4 slot p4(j >> 2) = p4(c >> 2) + r * R4 and
// S16 slot p16(j >> 4) = p16(c >> 4) + r * R16
constexpr int R4 = N16 + 2 * (N16 >> 6);
constexpr int R16 = 64 + (64 >> 4);

__global__ void __launch_bounds__(THREADS, 1)
fwbw_forward_kernel(const float* __restrict__ ev_mean,
                    const float* __restrict__ ev_stdv,
                    const float* __restrict__ ev_log_stdv,
                    const int32_t* __restrict__ length, int B, int T,
                    const float* __restrict__ e_stay,
                    const float* __restrict__ e_step,
                    const float* __restrict__ e_skip,
                    const float* __restrict__ level_mean,
                    const float* __restrict__ level_stdv,
                    const float* __restrict__ log_level_stdv,
                    const float* __restrict__ sd_mean,
                    const float* __restrict__ sd_lambda,
                    const float* __restrict__ log_sd_lambda,
                    const uint8_t* __restrict__ flags, float log2pi,
                    float log_n, float* __restrict__ alphas,
                    float* __restrict__ lpd) {
  __shared__ float sS4[P4N];
  __shared__ float sS16[P16N];
  __shared__ float sMax[WARPS];
  __shared__ float sSum[WARPS];
  __shared__ __align__(16) float sFin[N];  // exp(final - mfin), in j order

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, k = lane & 7;
  const int c16 = warp * 8 + k;  // the thread's column of the 16 x 256 view
  const int c = q * N16 + c16;   // and of the 4 x 1024 view
  const size_t rowb = (size_t)b * N;

  float r_stay[4], r_step[4], r_skip[4], r_lm[4], r_ls[4], r_nlls[4],
      r_sm[4], r_slam[4], r_c1[4];
  uint32_t fl = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t j = rowb + r * N4 + c;
    r_stay[r] = e_stay[j];
    r_step[r] = e_step[j];
    r_skip[r] = e_skip[j];
    r_lm[r] = level_mean[j];
    r_ls[r] = level_stdv[j];
    r_nlls[r] = -log_level_stdv[j];
    r_sm[r] = sd_mean[j];
    r_slam[r] = sd_lambda[j];
    r_c1[r] = log_sd_lambda[j] - log2pi;
    fl |= (uint32_t)flags[r * N4 + c] << (8 * r);
  }
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  const int len = length[b];

  float a[4];
  // alphas[t] at the thread's 4 states: one run of 32 B per 8 lanes
  auto store_row = [&](int t) {
    float* o = alphas + (size_t)t * B * N + rowb + c;
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r * N4] = a[r];
  };
  // each warp's NaN-propagating max of alpha, for the next barrier
  auto publish_max = [&]() {
    const float mx = warp_max_nan4(a);
    if (lane == 0) sMax[warp] = mx;
  };
  // the block's, from the warps'
  auto block_max = [&]() {
    return warp_max_nan(sMax[lane], sMax[lane] != sMax[lane]);
  };

  {
    const float x = evm[0], y = evs[0], ly3 = 3.0f * evl[0];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = emission_pre(x, y, ly3, r_lm[r], r_ls[r], r_nlls[r], r_sm[r],
                          r_slam[r], r_c1[r], log2pi) -
             log_n;
    if (alphas != nullptr) store_row(0);
    publish_max();
  }

  const float* rd4 = sS4 + p4(c >> 2);
  const float* rd16 = sS16 + p16(c >> 4);
  for (int t = 1; t < T; ++t) {
    // the step's event, loaded before the barriers that hide its latency
    const float x = evm[t], y = evs[t], ly = evl[t];
    __syncthreads();  // 1: the warps' maxima of alpha(t-1)
    const float m = block_max();
    float E[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) E[r] = expf(a[r] - m);
    sS4[p4(c)] = ((E[0] + E[1]) + E[2]) + E[3];
    {
      // sum16: rows r16 = 0..15 of column c16, row 4r + q' from register
      // r of lane 8q' + k, added in r16 order
      float s = __shfl_sync(FULL, E[0], k);
#pragma unroll
      for (int r16 = 1; r16 < 16; ++r16)
        s = s + __shfl_sync(FULL, E[r16 >> 2], (r16 & 3) * 8 + k);
      if (q == 0) sS16[p16(c16)] = s;
    }
    __syncthreads();  // 2: the S4 and S16 columns

    const bool active = t < len;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s4 = rd4[r * R4];
      const float s16 = rd16[r * R16];
      const unsigned f = (fl >> (8 * r)) & 0xffu;
      const float hE = (f & F_H) ? E[r] : 0.0f;
      const float p2E = (f & F_P2) ? E[r] : 0.0f;
      const float s5S4 = (f & F_S5) ? s4 : 0.0f;
      const float total = (r_stay[r] * E[r] + r_step[r] * (s4 - hE)) +
                          r_skip[r] * ((s16 - p2E) - s5S4);
      const float em = emission_pre(x, y, 3.0f * ly, r_lm[r], r_ls[r],
                                    r_nlls[r], r_sm[r], r_slam[r], r_c1[r],
                                    log2pi);
      if (active) a[r] = (em + m) + logf(total);
    }
    if (alphas != nullptr) store_row(t);
    // every thread has read sMax in this step (it passed barrier 2)
    publish_max();
  }

  // log_pr_data of the final alpha: its exps in state order, then the
  // pairwise tree over 4 contiguous states a thread, the warp, the warps
  __syncthreads();
  const float mfin = block_max();
#pragma unroll
  for (int r = 0; r < 4; ++r) sFin[r * N4 + c] = expf(a[r] - mfin);
  __syncthreads();
  float v[4];
  unpack4(v, *reinterpret_cast<const float4*>(sFin + 4 * tid));
  const float ws = warp_tree_sum(quad_sum(v));
  if (lane == 0) sSum[warp] = ws;
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_sum(sSum[lane]);
    if (lane == 0) lpd[b] = mfin + logf(s);
  }
}

}  // namespace

// Plain C entry for ctypes.  alphas == nullptr stores no per-step alphas
// (only log_pr_data).  Returns cudaGetLastError() after the launch.
extern "C" int nc_fwbw_forward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_stay,
    const float* e_step, const float* e_skip, const float* level_mean,
    const float* level_stdv, const float* log_level_stdv,
    const float* sd_mean, const float* sd_lambda, const float* log_sd_lambda,
    const uint8_t* flags, float log2pi, float log_n, float* alphas,
    float* lpd, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    fwbw_forward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_stay, e_step, e_skip,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, flags, log2pi, log_n, alphas, lpd);
  }
  return (int)cudaGetLastError();
}
