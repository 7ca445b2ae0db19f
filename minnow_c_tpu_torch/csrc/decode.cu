// K1: fused uniform decode of one Trim plane -- unpack, Threefry-2x32-13
// dither, undo of the bin index, optional periodic rewrap -- in one pass.
//
// Replaces the Pallas kernel minnow_c_tpu/ops/decode_pallas.py:decode_pallas
// (_decode_body, _unpack_128, _threefry13_tile).  Output bits equal the
// plain torch version decode_cuda.decode_plain and the JAX package's decode
// (the dither is part of the wire, so the cipher is Threefry bit for bit).
//
// Bound on the card: memory.  Per element it reads width/8 bytes of packed
// words and writes 4 bytes of f32; the 13 cipher rounds are shared by four
// elements, so the arithmetic stays below the bandwidth line.
//
// Design: one thread per Threefry counter, i.e. 4 consecutive elements per
// thread.  Each element takes a 64-bit funnel window of two words (served
// from L1 for neighbouring threads).  Every float step names its rounding
// (__fadd_rn, __fmaf_rn), and the library is compiled with -fmad=false so
// that the compiler contracts nothing else.
// Left for later work: vectorised 16-byte loads/stores, staging the words of
// a block in shared memory, and grid-stride loops over a persistent grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
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

// words: the plane's packed stream (n_words u32); element e of the plane
// uses dither counter ctr0 + e/4 (ctr0 = the plane's first element / 4).
__global__ void decode_uniform_kernel(const uint32_t* __restrict__ words,
                                      int64_t n_words, uint32_t k0,
                                      uint32_t k1, float x0, float dx_bin,
                                      float box, int64_t n, int width,
                                      int64_t ctr0, int periodic,
                                      float* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t e0 = q * 4;
  if (e0 >= n) return;
  uint32_t a, b;
  threefry2x32_13(k0, k1, static_cast<uint32_t>(ctr0 + q), 0u, a, b);
  const uint32_t grain[4] = {a & 0xFFFFu, a >> 16, b & 0xFFFFu, b >> 16};
  const uint32_t mask = (1u << width) - 1u;  // width <= 24
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int64_t e = e0 + l;
    if (e >= n) break;
    const uint64_t start = static_cast<uint64_t>(e) * width;
    const int64_t j = static_cast<int64_t>(start >> 5);
    uint64_t window = words[j];
    if (j + 1 < n_words) window |= static_cast<uint64_t>(words[j + 1]) << 32;
    const uint32_t bin = static_cast<uint32_t>(window >> (start & 31)) & mask;
    const float u = __fmul_rn(static_cast<float>(grain[l]), 1.0f / 65536.0f);
    // bin + u rounds on its own; the multiply and the add round once
    // together, as in the frozen decode digests (see ops/kernels.undo_bins).
    float x = __fmaf_rn(dx_bin, __fadd_rn(static_cast<float>(bin), u), x0);
    if (periodic) {
      if (x >= box) x = __fsub_rn(x, box);
      if (x < 0.0f) x = __fadd_rn(x, box);
    }
    out[e] = x;
  }
}

}  // namespace

extern "C" int mnw_decode_uniform(const void* words, int64_t n_words,
                                  uint32_t k0, uint32_t k1, float x0,
                                  float dx_bin, float box, int64_t n,
                                  int width, int64_t ctr0, int periodic,
                                  void* out, void* stream) {
  constexpr int kThreads = 256;
  const int64_t counters = (n + 3) / 4;
  const int64_t blocks = (counters + kThreads - 1) / kThreads;
  decode_uniform_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, k0, k1, x0, dx_bin, box,
      n, width, ctr0, periodic, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mnw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
