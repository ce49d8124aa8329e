// The exchange of the state-parallel kernels, K1m (viterbi_forward.cu
// viterbi_forward_wave_kernel), K6am (viterbi_generic.cu
// viterbi_generic_wave_kernel), K4m (fwbw_forward.cu) and K5m
// (em_backward.cu), on two paths.  The cooperative path (K1m always; K6am,
// K4m and K5m across cards or over more than MAX_CLUSTER ranks): one block
// a (read, rank) pair of a cooperative grid, each rank owning the buffers
// it publishes (K1m's and K6am's slice of column t at parity t & 1; K4m's
// and K5m's: their sources) and a step counter a read.  A step publishes
// the counter by a release store, polls the peers' counters with acquire
// loads, then reads the peers' buffers in place by relaxed (L1-bypassing)
// loads, never the non-coherent path.  On one card the operations take gpu
// scope, across cards (SYS) system scope.  A poll that waits longer than
// the launch's timeout records (t, read, rank, peer) in a host-mapped word
// and traps: a fault in the exchange fails the pass, never hangs it.  The
// cluster path (K6am, K4m and K5m on one card with M <= MAX_CLUSTER): a
// read's M blocks one thread block cluster, exchanging through their
// shared memory behind the cluster barrier (below); K6cm and K6dm
// (fwbw_generic_wave.cu, fwbw_backward_wave.cu) push into it onto the
// receiver's mbarrier instead (st_async, mbar_wait_cluster).

#pragma once

#include <stdint.h>

#include "common.cuh"

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

// four floats of a column slice (16-byte aligned), as ld_column
template <bool SYS>
__device__ __forceinline__ float4 ld_column4(const float* p) {
  float4 v;
  if (SYS)
    asm volatile("ld.relaxed.sys.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
  else
    asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
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

// K4m's and K5m's blocks: W / 4 threads, 4 contiguous states a thread,
// and at least a warp (a slice of 64 states: lanes 16.. repeat lanes
// 0..15 and store nothing); 512 at 2 ranks, the most
constexpr int SLICE_MAX_THREADS = N / 8;
constexpr int SLICE_MAX_WARPS = SLICE_MAX_THREADS / 32;

__host__ __device__ __forceinline__ int slice_threads(int slice_shift) {
  return (1 << (slice_shift - 2)) > 32 ? 1 << (slice_shift - 2) : 32;
}

// The block's part of the exchange, in shared memory so that none of it
// stays in a register through the time loop: the wait's timeout and
// record, the row's rank count, the block's rank and read.  The M ranks'
// counters and published buffers at the read are pointer tables of their
// own: K1m's and K6am's (its cooperative path) in Exchange, K4m's and K5m's
// in dynamic shared memory (M entries each, so that a block of a small
// slice keeps little).
struct WaveSync {
  int32_t* timed_out;
  long long timeout_ns;
  int ranks, rank, read;
};

// K1m's and K6am's: the M ranks' column buffers and counters at read b
struct Exchange : WaveSync {
  float* col[MAX_RANKS];
  int32_t* flag[MAX_RANKS];
};

// Until the counter of peer p (flag[p]) reaches t; after timeout_ns,
// records (t, read, rank, peer) in the host-mapped word and traps.
template <bool SYS>
__device__ __forceinline__ void wait_rank(const WaveSync& x,
                                          int32_t* const* flag, int p,
                                          int t) {
  if (ld_flag<SYS>(flag[p]) >= t) return;
  const unsigned long long t_start = global_ns();
  while (ld_flag<SYS>(flag[p]) < t) {
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

// Until the counter of every peer p (p != rank, p < ranks) reaches t
// (warp 0; lane p waits on rank p, p + 32).
template <bool SYS>
__device__ __forceinline__ void wait_ranks(const WaveSync& x,
                                           int32_t* const* flag, int t,
                                           int lane) {
  for (int p = lane; p < x.ranks; p += 32)
    if (p != x.rank) wait_rank<SYS>(x, flag, p, t);
}

// The wait of a fold of one value a rank (log Pr[data]'s partial sums, K5m's
// records) that warp 0 adds pairwise in rank order: lane l reads rank l,
// or ranks 2 l and 2 l + 1 at more than 32 ranks, and waits on the
// counters of those peers, so that each lane's acquire precedes its own
// reads.
template <bool SYS>
__device__ __forceinline__ void wait_fold_ranks(const WaveSync& x,
                                                int32_t* const* flag, int t,
                                                int lane) {
  const int per_lane = x.ranks > 32 ? 2 : 1;
  for (int q = 0; q < per_lane; ++q) {
    const int p = per_lane * lane + q;
    if (p < x.ranks && p != x.rank) wait_rank<SYS>(x, flag, p, t);
  }
}

// torch.amax over the M ranks' partial maxima, K of them a rank: out[k]
// the max of src[p][off + k] over the ranks p (warp 0, every lane), fmaxf
// with one vote for NaN (common.cuh warp_max_nan); the K loads of a peer
// are issued together
template <bool SYS, int K>
__device__ __forceinline__ void ranks_max(const float* const* src,
                                          size_t off, int ranks, int lane,
                                          float (&out)[K]) {
  float v[K];
  bool nan[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = -INFINITY;
    nan[k] = false;
  }
  for (int p = lane; p < ranks; p += 32) {
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = ld_column<SYS>(src[p] + off + k);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = fmaxf(v[k], w[k]);
      nan[k] = nan[k] || w[k] != w[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = warp_max_nan(v[k], nan[k]);
}

// --- the exchange inside a thread block cluster ---------------------------
// On one card a read's M <= MAX_CLUSTER ranks run as one cluster of M
// blocks (K6am's, K4m's and K5m's cluster path): the hardware schedules a
// cluster's blocks at once, so they may wait on each other without a
// cooperative grid, and each block reaches its peers' shared memory
// (distributed shared memory) behind the cluster barrier's release and
// acquire, with no counter in global memory and no L2 round trip.  K4m and
// K5m read what their peers publish in place (ld_cluster); K6am pushes its
// slice into every peer's double-buffered column (st_cluster2), so that a
// step reads only its own shared memory.

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// this thread's arrival at the cluster barrier, releasing its writes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

// until every thread of the cluster has arrived, acquiring their writes
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address in block `rank`'s shared memory of this block's `addr`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// stores into a block's shared memory at a cluster_map address: two floats
// (8-byte aligned), one word
__device__ __forceinline__ void st_cluster2(uint32_t addr, float v0,
                                            float v1) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr),
               "f"(v0), "f"(v1)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// --- pushes completing on the receiver's mbarrier (K6cm, K6dm) ------------
// A block that pushes into a peer's shared memory by st.async reports the
// bytes to the peer's mbarrier (both at cluster_map addresses of the peer);
// the peer arms its mbarrier for the bytes of an exchange (mbar_rearm) and
// waits on it alone, so that no step ends at a rendezvous of the whole
// cluster.  The complete_tx of st.async releases at cluster scope,
// mbar_wait_cluster acquires at cluster scope.
//
// NC_BARRIER (defined only by tools/torch_decode_times.py
// --legacy-exchange, which times the two in turns) swaps in the exchange
// this one replaced: a push a plain store into the peer's shared memory,
// the wait a cluster barrier of every thread, nothing armed.  Every thread
// of every block calls the waits of K6cm and K6dm, so the swap keeps their
// results.

#ifdef NC_BARRIER
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t) {
  st_cluster(addr, __float_as_int(v));
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t, uint32_t) {
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void mbar_rearm(uint32_t, uint32_t) {}
#else
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(mbar)
      : "memory");
}

// until the phase of parity `parity` of this block's mbarrier at `bar` has
// completed, acquiring the pushes that completed it at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity)
        : "memory");
  }
}

// thread 0's arming of its mbarrier at `bar` for an exchange of `bytes`
__device__ __forceinline__ void mbar_rearm(uint32_t bar, uint32_t bytes) {
  mbar_expect(bar, bytes);
}
#endif

// ranks_max over the cluster: out[k] the max of the K floats at `addr` in
// the shared memory of each of the cluster's `ranks` blocks (every lane of
// the calling warp)
template <int K>
__device__ __forceinline__ void cluster_max(uint32_t addr, int ranks,
                                            int lane, float (&out)[K]) {
  float v[K];
  bool nan[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = -INFINITY;
    nan[k] = false;
  }
  if (lane < ranks) {
    const uint32_t a = cluster_map(addr, lane);
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = ld_cluster(a + 4 * k);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = w[k];
      nan[k] = w[k] != w[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = warp_max_nan(v[k], nan[k]);
}

}  // namespace nc
