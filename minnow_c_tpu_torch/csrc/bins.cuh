// The encode side's element maps, shared by the pack kernels (pack.cu: K4,
// K5, K7, K8), the stats kernel (stats.cu: K6) and the one-pass recip
// encode (encode_recip.cu: K12): the subnormal flush of a raw value, the
// anchored periodic unwrap, the recip bin map and the trunc / clamp of a
// pre-scaled value to its bin.
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
// 2^width - 1, else trunc.  One comparison catches NaN and < 0: both fail
// s >= 0.
__device__ __forceinline__ uint32_t scaled_to_bin(float s, int width,
                                                  uint32_t top) {
  if (!(s >= 0.0f)) return 0u;
  if (s >= static_cast<float>(1u << width)) return top;
  return static_cast<uint32_t>(s);
}

// One stream's (row's) scalars of the recip map: x0, recip = rn(1 / range),
// the box and the anchor (the stream's raw element 0).
struct RecipParams {
  float x0, recip, box, anchor;
};

// The recip bin map of one raw value at W bits (encode_pallas._recip_body):
// the optional anchored unwrap, then ((v - x0) * recip) * 2^W in three
// roundings, then the clamp.  A constant plane has recip = inf, so
// 0 * inf = NaN, which bins to 0.
template <int W>
struct RecipMap {
  float x0, recip, box, half, anchor;
  int periodic;

  __device__ __forceinline__ RecipMap(const RecipParams& p, int periodic_)
      : x0(p.x0), recip(p.recip), box(p.box), half(half_box(p.box)),
        anchor(p.anchor), periodic(periodic_) {}

  __device__ __forceinline__ uint32_t operator()(float v) const {
    constexpr float kNb = static_cast<float>(1u << W);
    if (periodic) v = unwrap(v, box, half, anchor);
    return scaled_to_bin(__fmul_rn(__fmul_rn(__fsub_rn(v, x0), recip), kNb),
                         W, (1u << W) - 1u);
  }
};

}  // namespace mnw
