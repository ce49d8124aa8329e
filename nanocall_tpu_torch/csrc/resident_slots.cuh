// The resident slot tables of K6c (fwbw_generic.cu fwbw_resident_kernel)
// and K6e (fwbw_custom.cu fwbw_custom_resident_kernel): one side of a
// loaded transition table at a time in shared memory, and the slot
// log-sum-exp over it.
//
// Layout (ops/hmm.py pack_slots with groups = GROUPS): entry [k, j] of a
// side is 16 bits, the state in the low 12 and a code into the codebook of
// (slot k, j's block of N / GROUPS states) in the high 4; the codebooks
// are deg x GROUPS x CODES float32.  A kernel's dynamic shared memory
// holds two N-float buffers of its gathered vector, then the codebooks,
// then the table (deg the larger side's):
//   2 * N * 4 + deg * (GROUPS * CODES * 4 + N * 2) bytes.
// Thread tid holds the states 1024 i + tid, i < 4 (block i of the
// codebooks): a warp's entry reads are 64 contiguous bytes and its
// codebook reads fall in one block's 16 words, free of bank conflicts.
//
// A candidate book + x[state] can be NaN only when the gathered vector
// holds NaN or +inf (a kernel votes on that at the barrier that publishes
// the vector, __syncthreads_or of any_prone) or the side's codebooks do
// (book_prone); only then does lse_resident take the NaN-propagating max.

#pragma once

#include "common.cuh"

namespace nc {

// The resident layout: codebooks per slot (one per block of N / GROUPS
// states) and codes per codebook; the most slots whose layout fits one
// block (ops/hmm.py MAX_FWBW_RESIDENT_SLOTS)
constexpr int GROUPS = 4;
constexpr int CODES = 16;
constexpr int MAX_DEG = 23;
static_assert(N / GROUPS == N4, "state 1024 i + tid lies in block i");

// lse over the slots of one state from the resident table: ent points at
// the state's entry of slot 0 (slot k's is k * N on), book at slot 0's
// codebook of the state's block (slot k's is k * GROUPS * CODES on), x is
// the gathered vector.  DEG > 0: the table has DEG slots; DEG == 0: deg
// slots, at most MAX_DEG.  The candidates are taken once into registers;
// kNan: a candidate may be NaN (then the max is NaN-propagating).  stride:
// the entries of slot k lie k * stride on (N; K6cm's rank cut: its W).
template <bool kNan, int DEG>
__device__ __forceinline__ float lse_resident(const uint16_t* ent,
                                              const float* book,
                                              const float* x, int deg,
                                              int stride = N) {
  constexpr int D = DEG > 0 ? DEG : MAX_DEG;
  float v[D];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (DEG > 0 || k < deg) {
      const uint32_t e = ent[k * stride];
      v[k] = book[k * GROUPS * CODES + (e >> 12)] + x[e & 0xfffu];
      // without NaN, fmaxf is the max (on a tie of +0 and -0 either zero
      // gives the same lse: v - safe and safe + log(s) with s >= 1)
      if (k == 0)
        m = v[0];
      else
        m = kNan ? amax(m, v[k]) : fmaxf(m, v[k]);
    }
  }
  const float safe = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (DEG > 0 || k < deg) {
      const float e = expf(v[k] - safe);
      s = k == 0 ? e : s + e;
    }
  }
  return isfinite(m) ? safe + logf(s) : m;
}

// The lse of the thread's 4 states, 1024 i + tid (block i), one state at a
// time (ent and book at state tid, block 0): the loop is not unrolled, so
// the results rotate through out[] (static indices: registers) and out[i]
// ends as state i's.
template <bool kNan, int DEG>
__device__ __forceinline__ void lse4_states(const uint16_t* ent,
                                            const float* book,
                                            const float* x, int deg,
                                            float (&out)[4]) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const float r = lse_resident<kNan, DEG>(ent + i * N4, book + i * CODES,
                                            x, deg);
    out[0] = out[1];
    out[1] = out[2];
    out[2] = out[3];
    out[3] = r;
  }
}

template <int DEG>
__device__ __forceinline__ void lse4_resident(bool nan, const uint16_t* ent,
                                              const float* book,
                                              const float* x, int deg,
                                              float (&out)[4]) {
  if (nan)
    lse4_states<true, DEG>(ent, book, x, deg, out);
  else
    lse4_states<false, DEG>(ent, book, x, deg, out);
}

// The bytes of one side (deg slots): its codebooks and its packed table.
__host__ __device__ constexpr uint32_t side_bytes(int deg) {
  return (uint32_t)(deg * (GROUPS * CODES * 4 + N * 2));
}

// Thread 0: one side's codebooks `cb` and packed table `packed` (deg
// slots, 16-byte aligned) into shared memory at `book` and `table`, by
// bulk copies reported to the mbarrier at `bar`, which must expect
// side_bytes(deg) in its current phase.
__device__ __forceinline__ void copy_side(float* book, uint16_t* table,
                                          int deg, const uint16_t* packed,
                                          const float* cb, uint32_t bar) {
  const uint32_t book_bytes = deg * GROUPS * CODES * 4, slot_bytes = N * 2;
  bulk_copy(smem_addr(book), cb, book_bytes, bar);
  for (int k = 0; k < deg; ++k)
    bulk_copy(smem_addr(table + k * N), packed + (size_t)k * N, slot_bytes,
              bar);
}

// Whether a side's codebooks in shared memory hold NaN or +inf: a block
// reduction, which every thread must call.
__device__ __forceinline__ bool book_prone(const float* book, int deg,
                                           int tid) {
  bool p = false;
  for (int e = tid; e < deg * GROUPS * CODES; e += THREADS)
    p = p || nan_prone(book[e]);
  return __syncthreads_or(p) != 0;
}

}  // namespace nc
