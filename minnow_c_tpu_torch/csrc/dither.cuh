// The decode tail shared by every float-decode kernel: the stream-format
// Threefry-2x32-13 dither and the undo of one bin index.  Included by
// decode.cu (K1, K2) and chunked.cu (K11), so the cipher and the rounding of
// `x0 + dx_bin*(bin + u)` exist once.
//
// Bits equal minnow_c_tpu_torch/ops/rng.py (uniform_dither) and
// ops/kernels.py (undo_bins, periodic), and the JAX package's decode: the
// dither is part of the wire.  Every float step names its rounding; the
// library is compiled with -fmad=false, so nothing else is contracted.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mnw {

// A left rotation by r in 1..31, one funnel shift.
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32 with 13 rounds (minnow_c_tpu/ops/rng.py:_threefry2x32).
__device__ __forceinline__ void threefry2x32_13(uint32_t k0, uint32_t k1,
                                                uint32_t c0, uint32_t c1,
                                                uint32_t& a, uint32_t& b) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int r = 0; r < 13; ++r) {
    x0 += x1;
    x1 = rotl32(x1, kRot[r % 8]) ^ x0;
    if (r % 4 == 3) {
      const int j = r / 4 + 1;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  a = x0;
  b = x1;
}

// The four 16-bit dither grains of counter ctr as floats in [0, 1): element
// e of a plane uses counter e >> 2, lane e & 3.  Grain g becomes g * 2^-16
// exactly, built from bits: 1 + g * 2^-16 has g in the top 16 bits of its
// mantissa, and subtracting 1 is exact.
__device__ __forceinline__ void dither_quad(uint32_t k0, uint32_t k1,
                                            uint32_t ctr, float u[4]) {
  uint32_t a, b;
  threefry2x32_13(k0, k1, ctr, 0u, a, b);
  const uint32_t grain[4] = {a & 0xFFFFu, a >> 16, b & 0xFFFFu, b >> 16};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    u[l] = __fsub_rn(__uint_as_float(0x3F800000u | (grain[l] << 7)), 1.0f);
  }
}

// A bin below 2^W as f32, exactly: below 2^23 from bits (2^23 + bin has
// bin as its mantissa), at W = 24 by conversion.
template <int W>
__device__ __forceinline__ float bin_to_float(uint32_t bin) {
  if (W < 24) {
    return __fsub_rn(__uint_as_float(0x4B000000u | bin), 8388608.0f);
  }
  return __uint2float_rn(bin);
}

// One element's undo: bin + u rounds on its own, then the multiply and the
// add round once together, as in the frozen decode digests (see
// ops/kernels.undo_bins); then the optional periodic rewrap
// (kernels.periodic).  The bin comes as its exact f32 value.  The library
// builds with -ftz=true, so every operand and result that would be
// subnormal is a zero of its sign, as on XLA.
__device__ __forceinline__ float undo_binf(float bin, float u, float x0,
                                           float dx_bin, float box,
                                           int periodic) {
  float x = __fmaf_rn(dx_bin, __fadd_rn(bin, u), x0);
  if (periodic) {
    if (x >= box) x = __fsub_rn(x, box);
    if (x < 0.0f) x = __fadd_rn(x, box);
  }
  return x;
}

// undo_binf of a u32 bin, converted to f32 directly (exact below 2^24).
__device__ __forceinline__ float undo_bin(uint32_t bin, float u, float x0,
                                          float dx_bin, float box,
                                          int periodic) {
  return undo_binf(__uint2float_rn(bin), u, x0, dx_bin, box, periodic);
}

}  // namespace mnw
