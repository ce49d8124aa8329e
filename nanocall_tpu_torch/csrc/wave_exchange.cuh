// The column exchange of the state-parallel forward kernels, K1m
// (viterbi_forward.cu viterbi_forward_wave_kernel) and K6am
// (viterbi_generic.cu viterbi_generic_wave_kernel): one block a (read,
// rank) pair of a cooperative grid, each rank owning a (2, B, W) column
// buffer (its slice of column t at parity t & 1) and a step counter a
// read.  A step publishes the counter by a release store, polls the peers'
// counters with acquire loads, then reads the peers' slices in place by
// relaxed (L1-bypassing) loads, never the non-coherent path.  On one card
// the operations take gpu scope, across cards (SYS) system scope.  A poll
// that waits longer than the launch's timeout records (t, read, rank,
// peer) in a host-mapped word and traps: a fault in the exchange fails the
// decode, never hangs it.

#pragma once

#include <stdint.h>

namespace nc {

constexpr int MAX_RANKS = 64;

// The exchange's memory operations, at gpu scope (every rank of the row on
// one card) or system scope (SYS: across cards).
template <bool SYS>
__device__ __forceinline__ float ld_column(const float* p) {
  float v;
  if (SYS)
    asm volatile("ld.relaxed.sys.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  else
    asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <bool SYS>
__device__ __forceinline__ int ld_flag(const int32_t* p) {
  int v;
  if (SYS)
    asm volatile("ld.acquire.sys.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool SYS>
__device__ __forceinline__ void st_flag(int32_t* p, int v) {
  if (SYS)
    asm volatile("st.release.sys.global.b32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The exchange, in shared memory so that none of it stays in a register
// through the time loop: the M ranks' column buffers and counters at read
// b, the block's rank and slice, and the wait's timeout and record.
struct Exchange {
  float* col[MAX_RANKS];
  int32_t* flag[MAX_RANKS];
  int32_t* timed_out;
  long long timeout_ns;
  int ranks, rank, read;
};

// Until every peer's counter reaches t (warp 0; lane p waits on rank p, p
// + 32); after the timeout, records (t, read, rank, peer) in the host-
// mapped word and traps.
template <bool SYS>
__device__ __forceinline__ void wait_peers(const Exchange& x, int t,
                                           int lane) {
  for (int p = lane; p < x.ranks; p += 32) {
    if (p == x.rank || ld_flag<SYS>(x.flag[p]) >= t) continue;
    const unsigned long long t_start = global_ns();
    while (ld_flag<SYS>(x.flag[p]) < t) {
      if ((long long)(global_ns() - t_start) > x.timeout_ns) {
        volatile int32_t* rec = x.timed_out;
        rec[1] = x.read;
        rec[2] = x.rank;
        rec[3] = p;
        rec[0] = t;
        __threadfence_system();
        __trap();
      }
    }
  }
}

}  // namespace nc
