// Device helpers shared by the kernels of nanocall_tpu_torch/csrc.
//
// Every kernel here gives one read (one row) to one block of 1024 threads,
// and thread t holds the 4 contiguous states 4t .. 4t+3 of the 4096.  The
// reductions below follow the plain PyTorch versions' fixed orders, so that
// with -fmad=false a kernel is bit-identical to its plain version:
//   - maxima are exact in any order;
//   - a full-width sum is the pairwise tree of ops/hmm.py tree_sum
//     (x[2i] + x[2i+1], level by level): each thread's 4 states, then the
//     warp's 32 threads by shuffles, then the 32 warps' sums in warp 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nc {

constexpr int N = 4096;
constexpr int N4 = N / 4;
constexpr int N16 = N / 16;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// log_emission in the op order of nanocall_tpu/ops/hmm.py:230-244
__device__ __forceinline__ float emission(float x, float y, float ly, float lm,
                                          float ls, float lls, float sm,
                                          float slam, float lsl,
                                          float log2pi) {
  const float a = (x - lm) / ls;
  const float lnorm = -lls - (log2pi + a * a) * 0.5f;
  const float b = (y - sm) / sm;
  const float linv = (lsl - log2pi - 3.0f * ly - slam * b * b / y) * 0.5f;
  return lnorm + linv;
}

// The same emission with the state's loop-invariant parts taken out once
// per read: nlls = -log_level_stdv and c1 = log_sd_lambda - log2pi (the
// first operation of each chain, so the bits are emission()'s), and
// ly3 = 3 * log(event stdv), the event's share.
__device__ __forceinline__ float emission_pre(float x, float y, float ly3,
                                              float lm, float ls, float nlls,
                                              float sm, float slam, float c1,
                                              float log2pi) {
  const float a = (x - lm) / ls;
  const float lnorm = nlls - (log2pi + a * a) * 0.5f;
  const float b = (y - sm) / sm;
  const float linv = ((c1 - ly3) - slam * b * b / y) * 0.5f;
  return lnorm + linv;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void unpack4(float (&d)[4], const float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// torch.amax of two values: NaN-propagating (fmaxf drops a NaN)
__device__ __forceinline__ float amax(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// NaN or +inf: a value that a sum with a slot's log-prob may turn into NaN
// (the resident K6a and K6c take the NaN-propagating max only after one)
__device__ __forceinline__ bool nan_prone(float x) {
  return !(x < __int_as_float(0x7f800000));
}

__device__ __forceinline__ bool any_prone(const float (&v)[4]) {
  return nan_prone(v[0]) || nan_prone(v[1]) || nan_prone(v[2]) ||
         nan_prone(v[3]);
}

// the NaN-propagating max over the warp, in every lane (torch.amax)
__device__ __forceinline__ float warp_amax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = amax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// torch.amax over the warp at fmaxf's cost, in every lane: the max of the
// lanes' m by fmaxf, or NaN when any lane's `nan` is set (one vote; fmaxf
// alone drops a NaN).  Against warp_amax it may differ only in the sign of
// a zero max (a tie of -0 and +0) and in a NaN's payload: K4 and K5 use it
// where neither shows (exp(x - m), m + log(s) with s >= 1, NaN through a
// float operation).
__device__ __forceinline__ float warp_max_nan(float m, bool nan) {
  const bool any = __any_sync(FULL, nan);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  return any ? __int_as_float(0x7fffffff) : m;
}

// warp_max_nan of a thread's 4 values
__device__ __forceinline__ float warp_max_nan4(const float (&v)[4]) {
  return warp_max_nan(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
                      (v[0] != v[0]) || (v[1] != v[1]) || (v[2] != v[2]) ||
                          (v[3] != v[3]));
}

// the pairwise-tree sum of the warp's 32 values, in lane 0 (other lanes
// hold partial sums)
__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  return v;
}

// the pairwise-tree sum of a thread's 4 states
__device__ __forceinline__ float quad_sum(const float (&v)[4]) {
  return (v[0] + v[1]) + (v[2] + v[3]);
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

// torch.argmax over the warp's (best, idx) pairs, in lane 0
__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, idx, off);
    take_better(best, idx, ob, oi);
  }
}

// The end argmax of a traceback (K2, K6b) over a read's final alpha `fa`
// (N states) in a block of THREADS, in two phases around the caller's
// barrier.  First each thread's 4 states, then its warp's: lane 0 writes
// the warp's partial into w_best / w_idx (WARPS each).
// The thread's 4 states are 4 tid .. 4 tid + 3, their values at q[0..3]
// (K2m reads them from the slice of the rank that holds them).
__device__ __forceinline__ void end_argmax_partials_at(const float* q,
                                                       int tid,
                                                       float* w_best,
                                                       int* w_idx) {
  float best = q[0];
  int idx = 4 * tid;
#pragma unroll
  for (int i = 1; i < 4; ++i) take_better(best, idx, q[i], 4 * tid + i);
  warp_argmax(best, idx);
  if ((tid & 31) == 0) {
    w_best[tid >> 5] = best;
    w_idx[tid >> 5] = idx;
  }
}

__device__ __forceinline__ void end_argmax_partials(const float* fa, int tid,
                                                    float* w_best,
                                                    int* w_idx) {
  end_argmax_partials_at(fa + 4 * tid, tid, w_best, w_idx);
}

// Then, after the barrier, a warp's argmax over the WARPS partials: the
// read's maximum and its first state, in lane 0.
__device__ __forceinline__ void end_argmax(const float* w_best,
                                          const int* w_idx, int lane,
                                          float& best, int& idx) {
  best = w_best[lane];
  idx = w_idx[lane];
  warp_argmax(best, idx);
}

// lse over the deg slots of lp[k, j] + x[idx[k, j]] for the thread's 4
// states (idx / lp point at the thread's column of slot 0 of a (deg, n)
// table; x in shared memory), in ops/hmm.py logsumexp_slots' order:
//   m = max over k (NaN-propagating); safe = isfinite(m) ? m : 0
//   s = sum over k = 0, 1, .., deg-1 (in that order) of exp(v[k] - safe)
//   lse = isfinite(m) ? safe + log(s) : m
// The table is read twice, once for the max and once for the sum, so that
// the sum runs in the plain version's order (K6c and K6e).
__device__ __forceinline__ void lse_slots(const int4* idx, const float4* lp,
                                          int deg, const float* x,
                                          float (&out)[4]) {
  float m[4];
  for (int k = 0; k < deg; ++k) {
    const int4 iv = __ldg(idx + (size_t)k * N4);
    const float4 lv = __ldg(lp + (size_t)k * N4);
    const int id[4] = {iv.x, iv.y, iv.z, iv.w};
    const float l[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = l[i] + x[id[i]];
      m[i] = k == 0 ? v : amax(m[i], v);
    }
  }
  float safe[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) safe[i] = isfinite(m[i]) ? m[i] : 0.0f;
  for (int k = 0; k < deg; ++k) {
    const int4 iv = __ldg(idx + (size_t)k * N4);
    const float4 lv = __ldg(lp + (size_t)k * N4);
    const int id[4] = {iv.x, iv.y, iv.z, iv.w};
    const float l[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf((l[i] + x[id[i]]) - safe[i]);
      s[i] = k == 0 ? e : s[i] + e;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = isfinite(m[i]) ? safe[i] + logf(s[i]) : m[i];
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// --- asynchronous bulk copies into shared memory (PTX, sm_90) -------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier initialised for `count` arrivals a phase (no bytes expected
// yet); fence_mbarrier_init and a block barrier publish it
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the next phase of an initialised mbarrier: one arrival, then `bytes` of
// bulk copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// one arrival expected, then `bytes` of bulk copies to complete the phase
__device__ __forceinline__ void mbar_init_expect(uint32_t bar,
                                                 uint32_t bytes) {
  mbar_init(bar, 1);
  fence_mbarrier_init();
  mbar_expect(bar, bytes);
}

// one arrival on an mbarrier (a consumer handing a buffer back)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, reported to the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// orders this thread's view of shared memory (after a block barrier: every
// thread's reads) before bulk copies it issues next into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one byte of shared memory (ld.shared: no generic load that a census of
// the SASS could not tell from a global one)
__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// two bytes of shared memory, as lds_u8
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity)
        : "memory");
  }
}

}  // namespace nc
