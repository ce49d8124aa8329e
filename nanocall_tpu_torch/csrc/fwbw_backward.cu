// K6d: grouped log-sum-exp backward pass with the betas stored.
//
// Replaces the reverse lax.scan of nanocall_tpu/ops/hmm.py fwbw_grouped
// (bwd_step, + log_emission inlined), which XLA compiled for the TPU.  Per
// read (row) b, for t = T-2 down to 0, with beta = 0 after the last event,
// the beta recursion of csrc/beta_step.cuh (K5's, csrc/em_backward.cu):
//   g = em(t+1) + beta;  m = max g;  G = exp(g - m);  the 4- and 16-block
//   sums of G;  beta = t >= length-1 ? 0 : m + log(total)
// and betas (B, T, n) holds beta after each event (0 at T-1), the layout
// the legacy EM round (train._legacy_estep) reads.  K5 runs the same
// recursion for the fused EM round without storing it; the legacy round of
// a --trans run needs the betas themselves, and no statistics.
//
// Design (for the H100): K5's step (beta_step.cuh: one block per read,
// 1024 threads x 4 contiguous states, the model rows in shared memory by
// cp.async.bulk, the transition tables as per-read codebooks, 2 barriers
// a step, sum16 by shuffles, the max by fmaxf and a NaN vote), with no
// alphas read and no statistics; each step's betas are stored as one
// float4 a thread.  A block holds one read, so a step at t >= length - 1
// is the same for the whole block: there beta is a stored +0.0 (the plain
// version's torch.where), with no emission, exp, log or barrier.  Those
// steps are the first of the loop; a row of length <= 1 skips the model
// rows' copy too.
//
// What bounds it: issue on the read's one SM, the emission's 3 IEEE
// divisions and one exp and one log per state and step, then the 2
// barriers; the 16 KB beta store per read and step (the roofline bound,
// bytes).  Only B of the 132 SMs work when B < 132.  A design with 3
// barriers, a serial 16-term sum on 256 of the 1024 threads, 9 tables in
// registers and every step computed takes 2.1-2.2 ms at 512 x 128 on an
// H100, against 1.3-1.4 ms for this one.
//
// Build with -fmad=false: every float operation then rounds on its own, as
// each elementwise PyTorch op does, so the kernel is bit-identical to
// fwbw_grouped_backward_plain in nanocall_tpu_torch/ops/hmm.py on the card.

#include "beta_step.cuh"
#include "device_guard.cuh"

namespace {

using namespace nc;

__global__ void __launch_bounds__(THREADS, 1)
fwbw_backward_kernel(const float* __restrict__ ev_mean,
                     const float* __restrict__ ev_stdv,
                     const float* __restrict__ ev_log_stdv,
                     const int32_t* __restrict__ length, int B, int T,
                     const float* __restrict__ e_codes,
                     const uint8_t* __restrict__ pattern,
                     const float* __restrict__ level_mean,
                     const float* __restrict__ level_stdv,
                     const float* __restrict__ log_level_stdv,
                     const float* __restrict__ sd_mean,
                     const float* __restrict__ sd_lambda,
                     const float* __restrict__ log_sd_lambda,
                     const uint8_t* __restrict__ flags, float log2pi,
                     float* __restrict__ betas) {
  extern __shared__ __align__(16) float rows[];  // the MODEL_ROWS rows
  __shared__ __align__(8) uint64_t bar;
  __shared__ __align__(16) BetaShared sh;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = length[b];
  float* out = betas + (size_t)b * T * N + 4 * tid;

  // steps t >= len - 1 and row T-1: beta = 0
  const int t_zero = min(max(len - 1, 0), T - 1);
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = t_zero; t < T; ++t) store4(out + (size_t)t * N, zero);
  if (t_zero == 0) return;

  const uint32_t bar_addr = smem_addr(&bar);
  if (tid == 0)
    copy_model_rows(rows, bar_addr, b, 0, level_mean, level_stdv,
                    log_level_stdv, sd_mean, sd_lambda, log_sd_lambda);
  if (tid < BWD_BOOKS * BWD_CODES)
    sh.book[tid / BWD_CODES][tid % BWD_CODES] =
        e_codes[(size_t)b * BWD_BOOKS * BWD_CODES + tid];
  const uint32_t fl = *reinterpret_cast<const uint32_t*>(flags + 4 * tid);
  const uint32_t pat = *reinterpret_cast<const uint32_t*>(pattern + 4 * tid);
  const float* evm = ev_mean + (size_t)b * T;
  const float* evs = ev_stdv + (size_t)b * T;
  const float* evl = ev_log_stdv + (size_t)b * T;
  // the first step's event, t_zero; then one step ahead
  float xn = evm[t_zero], yn = evs[t_zero], lyn = evl[t_zero];

  __syncthreads();  // orders the mbarrier's init before every wait; books
  mbar_wait(bar_addr, 0);
  prepare_model_rows(rows, tid, log2pi);

  float beta[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = t_zero - 1; t >= 0; --t) {
    const float x = xn, y = yn, ly3 = 3.0f * lyn;
    if (t > 0) {
      xn = evm[t];
      yn = evs[t];
      lyn = evl[t];
    }
    float g[4];
    beta_g(rows, tid, x, y, ly3, beta, log2pi, g);
    beta_step(g, false, fl, pat, sh, nullptr, tid, beta, [] {});
    store4(out + (size_t)t * N, beta);
  }
}

}  // namespace

// Plain C entry for ctypes.  e_codes (B, 3, 32) and pattern (4096,) are
// ops/hmm.py bwd_codebooks' transition codebooks and pattern bytes; the
// model rows must be 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int nc_fwbw_backward(
    const float* ev_mean, const float* ev_stdv, const float* ev_log_stdv,
    const int32_t* length, int B, int T, const float* e_codes,
    const uint8_t* pattern, const float* level_mean, const float* level_stdv,
    const float* log_level_stdv, const float* sd_mean, const float* sd_lambda,
    const float* log_sd_lambda, const uint8_t* flags, float log2pi,
    float* betas, int device, void* stream) {
  const nc::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B > 0 && T > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwbw_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        nc::MODEL_BYTES);
    if (err != cudaSuccess) return (int)err;
    fwbw_backward_kernel<<<B, nc::THREADS, nc::MODEL_BYTES,
                           (cudaStream_t)stream>>>(
        ev_mean, ev_stdv, ev_log_stdv, length, B, T, e_codes, pattern,
        level_mean, level_stdv, log_level_stdv, sd_mean, sd_lambda,
        log_sd_lambda, flags, log2pi, betas);
  }
  return (int)cudaGetLastError();
}
