// Min and max of f32 slices as XLA's jnp.min / jnp.max give them, shared by
// the stats kernel (stats.cu: K6, which replaces
// minnow_c_tpu/ops/encode_pallas.py:stats_pallas_rows) and the first step
// of the fused recip encode (encode_recip.cu: K12, which replaces
// encode_pallas.py:encode_recip_fused_blocks): subnormals read as zeros of
// their sign, NaN propagates (as the canonical quiet NaN), and -0.0 counts
// below +0.0 (IEEE minimum / maximum), so the result does not depend on the
// order of the reduction.  Bits equal kernels.minmax in
// minnow_c_tpu_torch/ops.
//
// Bound on the card: memory, 4 bytes read an element.  The slice routine
// (slice_keys) therefore reads 16-byte vectors with streaming loads, four
// in flight a thread, and keeps the work per element to the optional
// unwrap, its integer key and two integer min / max.
//
// The slices reduce in integers.  order_key maps the bits b of a float to
// the signed 32-bit key b ^ ((b >> 31) & 0x7FFFFFFF): a non-negative float
// keeps its bits, a negative one has its magnitude bits flipped, so keys
// order as the floats do, with -0.0 (key -1) just below +0.0 (key 0), -inf
// and +inf at the ends of the non-NaN keys, and every NaN beyond them (a
// positive NaN above +inf's key, a negative one below -inf's).  Integer min
// and max of the keys (one IMNMX each) are therefore min_op / max_op on the
// non-NaN values -- IEEE minimum / maximum, the ties of +-0 included -- and
// a NaN anywhere leaves the max key above +inf's or the min key below
// -inf's, which no reduction step can undo; key_range_to_floats turns that
// into the canonical NaN for both results.  The map is its own inverse.
// The subnormal flush is applied once, to the two results, not to every
// element: flushing is monotone in this order (-normal < -sub < -0 < +0 <
// +sub < +normal goes to -normal < -0 = -0 < +0 = +0 < +normal), so the
// flush of the min is the min of the flushed values, and likewise the max.
// The unwrap may read the raw value: under -ftz=true its subtractions and
// comparisons read a subnormal operand as the zero of its sign, so it moves
// a value exactly when it would move the flushed value, and then to the
// same result.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bins.cuh"

namespace mnw {

constexpr uint32_t kQuietNaN = 0x7FC00000u;
constexpr int kKeyPosInf = 0x7F800000;           // order_key(+inf)
constexpr int kKeyNegInf = -0x7F800000 - 1;      // order_key(-inf)

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

__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// The min and max keys of a set of floats; the empty set is (+inf, -inf).
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange empty_key_range() {
  return {kKeyPosInf, kKeyNegInf};
}

__device__ __forceinline__ void take_key(KeyRange& r, int k) {
  r.lo = min(r.lo, k);
  r.hi = max(r.hi, k);
}

// (min, max) of the floats behind a key range: the canonical NaN for both
// when a NaN was taken, else the two ends flushed; the empty range gives
// (+inf, -inf), the identities of min_op / max_op.
__device__ __forceinline__ void key_range_to_floats(const KeyRange& r,
                                                    float& mn, float& mx) {
  if (r.hi > kKeyPosInf || r.lo < kKeyNegInf) {
    mn = mx = __uint_as_float(kQuietNaN);
    return;
  }
  mn = ftz(key_float(r.lo));
  mx = ftz(key_float(r.hi));
}

// Reduces every thread's key range over the whole block of kThreads
// threads (one redux instruction a warp and a value); the result is valid
// in thread 0.  Every thread of the block must call it (it synchronises
// the block).
template <int kThreads>
__device__ __forceinline__ KeyRange block_key_range(KeyRange r) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int slo[kWarps];
  __shared__ int shi[kWarps];
  r.lo = __reduce_min_sync(0xFFFFFFFFu, r.lo);
  r.hi = __reduce_max_sync(0xFFFFFFFFu, r.hi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    slo[warp] = r.lo;
    shi[warp] = r.hi;
  }
  __syncthreads();
  if (warp == 0) {
    r = lane < kWarps ? KeyRange{slo[lane], shi[lane]} : empty_key_range();
    r.lo = __reduce_min_sync(0xFFFFFFFFu, r.lo);
    r.hi = __reduce_max_sync(0xFFFFFFFFu, r.hi);
  }
  __syncthreads();  // slo / shi may be reused by the next call
  return r;
}

// One element: the optional unwrap around the anchor, then its key.
template <bool kPeriodic>
__device__ __forceinline__ void take(KeyRange& r, float v, float box,
                                     float half, float anchor) {
  if (kPeriodic) v = unwrap(v, box, half, anchor);
  take_key(r, order_key(v));
}

template <bool kPeriodic>
__device__ __forceinline__ void take4(KeyRange& r, float4 v, float box,
                                      float half, float anchor) {
  take<kPeriodic>(r, v.x, box, half, anchor);
  take<kPeriodic>(r, v.y, box, half, anchor);
  take<kPeriodic>(r, v.z, box, half, anchor);
  take<kPeriodic>(r, v.w, box, half, anchor);
}

// The key range of slice `slice` of a row of n floats, reduced over the
// block (block_key_range; valid in thread 0).  The row is read as its
// 16-byte-aligned body of float4s, cut into slices of slice_len / 4 of them
// (slice_len a multiple of 4), plus the at most 3 scalars before the body's
// first 16-byte boundary and the at most 3 after its last, which slice 0
// takes.  A row that does not start on 16 bytes (an odd n, an offset view)
// so has one float4 fewer than slice_len / 4 per slice at most, and its last
// slice of ceil(n / slice_len) may be empty.  Neighbouring threads load
// neighbouring float4s, 4 at a time (64 bytes in flight a thread), with
// streaming loads that do not allocate in L1.
template <int kThreads, bool kPeriodic>
__device__ __forceinline__ KeyRange slice_keys(const float* __restrict__ row,
                                               int64_t n, int64_t slice,
                                               int slice_len, float box,
                                               float half, float anchor) {
  const int64_t skip =
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2;
  const int64_t head = skip < n ? skip : n;
  const int64_t vecs = (n - head) >> 2;
  const int per = slice_len >> 2;
  const int64_t v0 = slice * per;
  const int64_t left = vecs - v0;
  const int count = left <= 0 ? 0 : left < per ? static_cast<int>(left) : per;
  const float4* body = reinterpret_cast<const float4*>(row + head) + v0;
  KeyRange r = empty_key_range();
  int k = threadIdx.x;
  for (; k + 3 * kThreads < count; k += 4 * kThreads) {
    const float4 a = __ldcs(body + k);
    const float4 b = __ldcs(body + k + kThreads);
    const float4 c = __ldcs(body + k + 2 * kThreads);
    const float4 d = __ldcs(body + k + 3 * kThreads);
    take4<kPeriodic>(r, a, box, half, anchor);
    take4<kPeriodic>(r, b, box, half, anchor);
    take4<kPeriodic>(r, c, box, half, anchor);
    take4<kPeriodic>(r, d, box, half, anchor);
  }
  for (; k < count; k += kThreads) {
    take4<kPeriodic>(r, __ldcs(body + k), box, half, anchor);
  }
  if (slice == 0) {
    const int64_t tail = head + 4 * vecs;
    if (threadIdx.x < head) {
      take<kPeriodic>(r, row[threadIdx.x], box, half, anchor);
    }
    if (threadIdx.x < n - tail) {
      take<kPeriodic>(r, row[tail + threadIdx.x], box, half, anchor);
    }
  }
  return block_key_range<kThreads>(r);
}

}  // namespace mnw
