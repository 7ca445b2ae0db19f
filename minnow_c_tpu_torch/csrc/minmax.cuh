// Min and max of f32 slices as XLA's jnp.min / jnp.max give them, shared by
// the stats kernel (stats.cu: K6) and the fused recip encode
// (encode_recip.cu: K12): subnormals read as zeros of their sign, NaN
// propagates (as the canonical quiet NaN), and -0.0 counts below +0.0 (IEEE
// minimum / maximum), so the result does not depend on the order of the
// reduction.  Bits equal kernels.minmax in minnow_c_tpu_torch/ops.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bins.cuh"

namespace mnw {

constexpr uint32_t kQuietNaN = 0x7FC00000u;

__device__ __forceinline__ float min_op(float a, float b) {
  if (isnan(a) || isnan(b)) return __uint_as_float(kQuietNaN);
  if (a < b) return a;
  if (b < a) return b;
  // Equal: identical bits, or +-0.0, where the sign bit of either wins.
  return __uint_as_float(__float_as_uint(a) | __float_as_uint(b));
}

__device__ __forceinline__ float max_op(float a, float b) {
  if (isnan(a) || isnan(b)) return __uint_as_float(kQuietNaN);
  if (a > b) return a;
  if (b > a) return b;
  return __uint_as_float(__float_as_uint(a) & __float_as_uint(b));
}

// Reduces every thread's (mn, mx) over the whole block of kThreads threads;
// the result is valid in thread 0.  Every thread of the block must call it
// (it synchronises the block).
template <int kThreads>
__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min_op(mn, __shfl_down_sync(0xFFFFFFFFu, mn, off));
    mx = max_op(mx, __shfl_down_sync(0xFFFFFFFFu, mx, off));
  }
  __shared__ float smin[kThreads / 32];
  __shared__ float smax[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    smin[warp] = mn;
    smax[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mn = min_op(mn, smin[w]);
      mx = max_op(mx, smax[w]);
    }
  }
  __syncthreads();  // smin / smax may be reused by the next call
}

// (min, max) of row[lo, hi) after the optional unwrap around anchor, reduced
// over the whole block (block_minmax); the result is valid in thread 0.
template <int kThreads>
__device__ __forceinline__ void slice_minmax(const float* __restrict__ row,
                                             int64_t lo, int64_t hi,
                                             int periodic, float box,
                                             float half, float anchor,
                                             float& mn, float& mx) {
  mn = __uint_as_float(0x7F800000u);   // +inf
  mx = __uint_as_float(0xFF800000u);   // -inf
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    float v = ftz(row[i]);
    if (periodic) v = unwrap(v, box, half, anchor);
    mn = min_op(mn, v);
    mx = max_op(mx, v);
  }
  block_minmax<kThreads>(mn, mx);
}

}  // namespace mnw
