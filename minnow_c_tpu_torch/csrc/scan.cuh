// Block-level u32 prefix sums shared by K9 (scan.cu) and K10 / K11
// (chunked.cu).  All arithmetic is u32 addition, which wraps mod 2^32 and is
// associative, so any blocking of a sum gives the same bits as a sequential
// one (and as jnp.cumsum on u32).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mnw {

// Inclusive scan of v over the 32 lanes of the warp.
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Exclusive scan of v over the block; *total receives the block's sum.
// blockDim.x must be a multiple of 32 (at most 1024), every thread of the
// block must call it, and warp_sums is 32 words of shared memory, free again
// when the call returns.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const uint32_t incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t s = lane < n_warps ? warp_sums[lane] : 0u;
    warp_sums[lane] = warp_inclusive_scan(s);
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return before + incl - v;
}

// out[i] = init + vals[0] + ... + vals[i-1] for i < m: one block walks the
// array a block-width at a time and carries the running sum.  K10 scans its
// chunk totals with it (with init = the plane's first value).  Static: each
// source that includes this header gets its own copy of the kernel, so the
// linked library holds no duplicate symbol.
static __global__ void exclusive_scan_one_block(
    const uint32_t* __restrict__ vals, int64_t m, uint32_t init,
    uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[32];
  uint32_t carry = init;
  for (int64_t base = 0; base < m; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const uint32_t v = i < m ? vals[i] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(v, warp_sums, &total);
    if (i < m) out[i] = carry + ex;
    carry += total;
  }
}

constexpr int kScanOneBlockThreads = 1024;

}  // namespace mnw
