#!/usr/bin/env python3
"""How fast one SM of the GPU takes 32 KB tiles of a table that lives in L2,
by two paths: per-thread __ldg loads into registers (what the streaming
K6c and K6e do, common.cuh lse_slots), and cp.async.bulk copies into a
ring of shared-memory stages on mbarriers (a design tried for them that
ran slower, PERF.md section 6).

    python3 tools/torch_ring_bench.py [--tiles 20000]

Builds its own micro-kernels (nvcc, sm_90a) into build/ring_bench/ and
times each with CUDA events over --tiles tiles of a 1.3 MB table (42 tiles:
a loaded table's 21 slots a side), one block of 1024 threads an SM, on 1
and on 132 blocks:

- ldg: each thread loads its 16 bytes of the tile's two 16 KB rows;
- bulk, dedicated producer: warp 0's lane 0 only issues copies (a tile as
  1, 2, 8 or 32 bulk copies) into 4 or 6 stages, the other 31 warps wait on
  the stage, load their 16 bytes of each row and release it;
- bulk, the tried ring's pattern: thread 0 issues from inside the
  consumer loop, every warp waits, loads its entries from the stage,
  gathers 4 values from a 16 KB vector in shared memory and releases it
  ("copies + loads + gathers"); the same without the copies (the stage
  loaded once: the consumers' work alone), and without the gathers.

Prints microseconds a tile and GB/s a block, with the card's nvidia-smi
name and power limit.  Used by no kernel of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "common.cuh"
using namespace nc;

__device__ __forceinline__ bool tryw(uint32_t bar, uint32_t par) {
  uint32_t d;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}"
               : "=r"(d) : "r"(bar), "r"(par) : "memory");
  return d;
}

constexpr int TILE = 32768;

// each thread loads its 16 bytes of both rows of every tile
__global__ void __launch_bounds__(1024, 1)
ldg_kernel(const uint8_t* src, int nrows, int tiles, float* out) {
  float acc = 0.f;
  for (int g = 0; g < tiles; ++g) {
    const uint8_t* p = src + (size_t)(g % nrows) * TILE;
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + 16 * threadIdx.x));
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + TILE / 2 + 16 * threadIdx.x));
    acc += v.x + w.y;
  }
  if (acc == 1.2345f) out[blockIdx.x] = acc;
}

// warp 0's lane 0 issues every tile as `pieces` bulk copies into S stages;
// warps 1..31 wait, load their 16 bytes of each row, release
__global__ void __launch_bounds__(1024, 1)
producer_kernel(const uint8_t* src, int nrows, int tiles, int S, int pieces,
                float* out) {
  extern __shared__ __align__(128) uint8_t st[];
  __shared__ __align__(8) uint64_t full[8], empty[8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 31);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  float acc = 0.f;
  if (warp == 0) {
    if (lane == 0) {
      for (int g = 0; g < tiles; ++g) {
        const int s = g % S;
        const uint32_t par = (g / S) & 1;
        if (g >= S) while (!tryw(smem_addr(&empty[s]), par ^ 1)) {}
        mbar_expect(smem_addr(&full[s]), TILE);
        const uint8_t* p = src + (size_t)(g % nrows) * TILE;
        const int piece = TILE / pieces;
        for (int i = 0; i < pieces; ++i)
          bulk_copy(smem_addr(st + s * TILE + i * piece), p + i * piece,
                    piece, smem_addr(&full[s]));
      }
    }
  } else {
    for (int g = 0; g < tiles; ++g) {
      const int s = g % S;
      const uint32_t par = (g / S) & 1;
      while (!tryw(smem_addr(&full[s]), par)) {}
      const float4 v = *reinterpret_cast<const float4*>(st + s * TILE + 16 * tid);
      const float4 w = *reinterpret_cast<const float4*>(st + s * TILE + TILE / 2 + 16 * tid);
      acc += v.x + w.y;
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    }
  }
  if (acc == 1.2345f) out[blockIdx.x] = acc;
}

// the tried ring's pattern: thread 0 issues from inside the consumer loop into
// 4 stages; mode 0 copies + loads + gathers, 1 loads + gathers (no copies),
// 2 copies + loads (no gathers)
__global__ void __launch_bounds__(1024, 1)
inloop_kernel(const uint8_t* src, int nrows, int tiles, int mode,
              float* out) {
  constexpr int S = 4;
  extern __shared__ __align__(128) uint8_t st[];
  __shared__ float x[4096];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 4096; i += 1024) x[i] = (float)i;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  if (mode == 1 && tid == 0) {
    mbar_expect(smem_addr(&full[0]), TILE);
    bulk_copy(smem_addr(st), src, TILE, smem_addr(&full[0]));
  }
  float m[4] = {0, 0, 0, 0};
  int next = 0;
  for (int g = 0; g < tiles; ++g) {
    const int s = mode == 1 ? 0 : g % S;
    const uint32_t par = mode == 1 ? 0 : (g / S) & 1;
    if (tid == 0 && mode != 1) {
      while (next < g + S && next < tiles) {
        const int ns = next % S;
        if (next >= S && !tryw(smem_addr(&empty[ns]), ((next / S) & 1) ^ 1))
          break;
        mbar_expect(smem_addr(&full[ns]), TILE);
        const uint8_t* p = src + (size_t)(next % nrows) * TILE;
        bulk_copy(smem_addr(st + ns * TILE), p, TILE / 2,
                  smem_addr(&full[ns]));
        bulk_copy(smem_addr(st + ns * TILE + TILE / 2), p + TILE / 2,
                  TILE / 2, smem_addr(&full[ns]));
        ++next;
      }
    }
    __syncwarp();
    while (!tryw(smem_addr(&full[s]), par)) {}
    const int4 iv = *reinterpret_cast<const int4*>(st + s * TILE + 16 * tid);
    const float4 lv = *reinterpret_cast<const float4*>(st + s * TILE + TILE / 2 + 16 * tid);
    if (mode == 2) {
      m[0] += lv.x + (float)iv.x;
    } else {
      const int id[4] = {iv.x & 4095, iv.y & 4095, iv.z & 4095, iv.w & 4095};
      const float l[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], l[i] + x[id[i]]);
    }
    __syncwarp();
    if (mode != 1 && lane == 0) mbar_arrive(smem_addr(&empty[s]));
  }
  const float a = m[0] + m[1] + m[2] + m[3];
  if (a == 1.2345f) out[blockIdx.x] = a;
}

extern "C" int run_ldg(const void* src, int nrows, int tiles, int blocks,
                       float* out) {
  ldg_kernel<<<blocks, 1024>>>((const uint8_t*)src, nrows, tiles, out);
  return cudaGetLastError();
}

extern "C" int run_producer(const void* src, int nrows, int tiles, int S,
                            int pieces, int blocks, float* out) {
  const int smem = S * TILE;
  cudaFuncSetAttribute(producer_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  producer_kernel<<<blocks, 1024, smem>>>((const uint8_t*)src, nrows, tiles,
                                          S, pieces, out);
  return cudaGetLastError();
}

extern "C" int run_inloop(const void* src, int nrows, int tiles, int mode,
                          int blocks, float* out) {
  const int smem = 4 * TILE;
  cudaFuncSetAttribute(inloop_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  inloop_kernel<<<blocks, 1024, smem>>>((const uint8_t*)src, nrows, tiles,
                                        mode, out);
  return cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "ring_bench")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "ring_bench.cu")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    lib = os.path.join(out, "ring_bench.so")
    csrc = os.path.join(ROOT, "nanocall_tpu_torch", "csrc")
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.run_ldg.argtypes = [vp, ci, ci, ci, vp]
    so.run_producer.argtypes = [vp, ci, ci, ci, ci, ci, vp]
    so.run_inloop.argtypes = [vp, ci, ci, ci, ci, vp]
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=20000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    so = build()
    rows = 42
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randint(0, 4096, (rows * 8192,), dtype=torch.int32,
                        device="cuda", generator=g)
    out = torch.zeros(256, device="cuda")

    def ms(fn, *a) -> float:
        assert fn(*a) == 0
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        assert fn(*a) == 0
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    n = args.tiles
    for blocks in (1, 132):
        def line(what, t):
            us = t * 1e3 / n
            print(f"blocks={blocks} {what}: {us:.3f} us a 32 KB tile, "
                  f"{32768 / us / 1e3:.1f} GB/s a block [{card}]",
                  flush=True)

        line("ldg", ms(so.run_ldg, src.data_ptr(), rows, n, blocks,
                       out.data_ptr()))
        for S in (4, 6):
            for pieces in (1, 2, 8, 32):
                line(f"bulk, dedicated producer, {S} stages, {pieces} "
                     f"copies a tile",
                     ms(so.run_producer, src.data_ptr(), rows, n, S, pieces,
                        blocks, out.data_ptr()))
        for mode, what in ((0, "copies + loads + gathers"),
                           (1, "loads + gathers, no copies"),
                           (2, "copies + loads, no gathers")):
            line(f"bulk, issued from the consumer loop, {what}",
                 ms(so.run_inloop, src.data_ptr(), rows, n, mode, blocks,
                    out.data_ptr()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
