// The encode side's element maps, shared by the pack kernels (pack.cu: K4,
// K7), the stats kernel (stats.cu: K6) and the recip-mode encodes
// (encode_recip.cu: K5, K8, K12): the subnormal flush of a raw value, the
// anchored periodic unwrap, the recip bin map, the trunc / clamp of a
// pre-scaled value to its bin, and the assembly of one packed word.
//
// Bits equal the plain torch versions in minnow_c_tpu_torch/ops/kernels.py
// (ftz, unwrap_anchored, recip_scaled_bins, scaled_to_bins).  Every float
// step names its rounding (the library builds with -fmad=false).  The
// library also builds with -ftz=true, so each __f*_rn, __frcp_rn and
// comparison reads a subnormal operand as a zero of its sign and flushes a
// subnormal result, as XLA does on the CPU; ftz() is needed only where a raw
// value reaches a result without arithmetic (the min / max of minmax.cuh).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mnw {

// An f32 subnormal becomes a zero of the same sign; anything else passes.
__device__ __forceinline__ float ftz(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x7F800000u) == 0u ? __uint_as_float(b & 0x80000000u) : v;
}

// The unwrap's half box, box * 0.5 (exact, XLA's box / 2).
__device__ __forceinline__ float half_box(float box) {
  return __fmul_rn(box, 0.5f);
}

// The periodic unwrap around the raw element 0 of the stream (anchor):
// v - a >= half moves v down a box, then the moved v - a < -half moves it up
// (kernels.undo_periodic; half = box * 0.5).
__device__ __forceinline__ float unwrap(float v, float box, float half,
                                        float anchor) {
  if (__fsub_rn(v, anchor) >= half) v = __fsub_rn(v, box);
  if (__fsub_rn(v, anchor) < -half) v = __fadd_rn(v, box);
  return v;
}

// C cast semantics on a pre-scaled value s = delta * 2^width: NaN -> 0
// (tested before any cast, never by cast), < 0 -> 0, >= 2^width -> top =
// 2^width - 1, else trunc.
__device__ __forceinline__ uint32_t scaled_to_bin(float s, int width,
                                                  uint32_t top) {
  if (isnan(s) || s < 0.0f) return 0u;
  if (s >= static_cast<float>(1u << width)) return top;
  return static_cast<uint32_t>(s);
}

// The recip bin map of one raw value (encode_pallas._recip_body): the
// optional anchored unwrap, then ((v - x0) * recip) * 2^width in three
// roundings, then the clamp.  A constant plane has recip = inf, so 0 * inf
// = NaN, which bins to 0.
struct RecipMap {
  float x0, recip, box, half, anchor, nb;
  int width;
  uint32_t top;
  int periodic;

  __device__ __forceinline__ RecipMap(float x0_, float recip_, float box_,
                                      float anchor_, int width_,
                                      int periodic_)
      : x0(x0_), recip(recip_), box(box_), half(half_box(box_)),
        anchor(anchor_), nb(static_cast<float>(1u << width_)),
        width(width_), top((1u << width_) - 1u), periodic(periodic_) {}

  __device__ __forceinline__ uint32_t operator()(float v) const {
    if (periodic) v = unwrap(v, box, half, anchor);
    return scaled_to_bin(__fmul_rn(__fmul_rn(__fsub_rn(v, x0), recip), nb),
                         width, top);
  }
};

// Word q of the uniform pack of n elements at width bits (util.c layout:
// bit b of element i lands at global bit i*width + b): ORs in the bins of
// the at most ceil(32/width)+1 elements whose bits overlap the word, bin(i)
// giving element i's bin below 2^width.  Spare bits of the last word stay 0.
template <class BinFn>
__device__ __forceinline__ uint32_t pack_word(int64_t q, int64_t n,
                                              int width, BinFn bin) {
  const int64_t bit0 = q * 32;
  int64_t i_end = (bit0 + 32 + width - 1) / width;  // first element at or
  if (i_end > n) i_end = n;                          // past bit0 + 32
  uint32_t word = 0;
  for (int64_t i = bit0 / width; i < i_end; ++i) {
    const uint32_t v = bin(i);
    const int64_t sh = i * width - bit0;  // in (-width, 32)
    word |= sh >= 0 ? (v << sh) : (v >> -sh);
  }
  return word;
}

}  // namespace mnw
