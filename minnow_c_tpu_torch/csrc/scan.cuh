// u32 prefix sums shared by K9 (scan.cu) and K10 / K11 (chunked.cu): the
// block-level scan, and the decoupled look-back across the tiles of a
// launch.  K9 and K10 / K11 run the same look-back code.  All
// arithmetic is u32 addition, which wraps mod 2^32 and is associative, so
// any blocking of a sum gives the same bits as a sequential one (and as
// jnp.cumsum on u32).

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

// ---------------------------------------------------------------------------
// Decoupled look-back.  Blocks take tiles by ticket from an atomic counter
// (K9: a persistent grid; K10 / K11: one block a tile), so a tile only ever
// waits on tiles whose blocks have started, whatever the grid's residency
// or the order the card runs blocks in.  Tile t publishes its aggregate
// (its own sum), then, once its carry is known, its inclusive prefix.  Each
// goes out as one 64-bit status word -- (kind << 32) | value -- so a flag
// and its value never tear; the words carry no other data, so relaxed
// atomic loads and stores at device scope order them enough.  The status
// words start at zero (kind 0: nothing yet), cleared by the launch's
// cudaMemsetAsync.
// ---------------------------------------------------------------------------

constexpr uint32_t kAggregate = 1u;
constexpr uint32_t kPrefix = 2u;

__device__ __forceinline__ void publish(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t observe(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t status_word(uint32_t kind,
                                                uint32_t value) {
  return (static_cast<uint64_t>(kind) << 32) | value;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// The sum of every tile before tile t (t >= 1) plus what tile 0's prefix
// holds beyond its own sum, by one whole warp: lane l reads the status of
// tile t - 1 - l - 32 k in round k, waits (with a short sleep) until each
// has published, sums the aggregates up to the nearest prefix, and stops
// there.  Every lane returns the same value.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status,
                                              uint32_t t) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = 0;
  for (int64_t k = static_cast<int64_t>(t) - 1 - lane;; k -= 32) {
    uint32_t kind, value;
    bool again = false;
    do {
      if (again) __nanosleep(32);
      if (k >= 0) {
        const uint64_t w = observe(status + k);
        kind = static_cast<uint32_t>(w >> 32);
        value = static_cast<uint32_t>(w);
      } else {  // before tile 0: a prefix of nothing
        kind = kPrefix;
        value = 0u;
      }
      again = __any_sync(0xFFFFFFFFu, kind == 0u);
    } while (again);
    const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, kind == kPrefix);
    if (prefixes) {
      // the nearest predecessor with a prefix ends the walk
      const int first = __ffs(prefixes) - 1;
      return carry + warp_sum(lane <= first ? value : 0u);
    }
    carry += warp_sum(value);
  }
}

// Tile t's carry (the sum before its first element, `seed` included) from
// its total, by one whole warp; publishes the tile's aggregate and then its
// inclusive prefix.  Tile 0 has the carry `seed` and publishes only its
// prefix.  Every lane returns the same value.
__device__ __forceinline__ uint32_t tile_carry(uint64_t* status, uint32_t t,
                                               uint32_t total,
                                               uint32_t seed) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (t == 0) {
    if (lead) publish(status, status_word(kPrefix, seed + total));
    return seed;
  }
  if (lead) publish(status + t, status_word(kAggregate, total));
  const uint32_t carry = look_back(status, t);
  if (lead) publish(status + t, status_word(kPrefix, carry + total));
  return carry;
}

}  // namespace mnw
