// K4: uniform-width bitpack of one plane, from u32 bins or from a pre-scaled
// f32 plane (delta * 2^width) that it first truncates and clamps.
//
// Replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:pack_pallas
// (_pack_body, _scaled_to_bins).  Layout is util.c's: bit b of element i
// lands at global bit i*width + b; spare bits of the last word are zero.
// Output bits equal encode_cuda.pack_plain and the JAX package's pack.
//
// Bound on the card: memory.  Per element it reads 4 bytes and writes
// width/8 bytes.
//
// Design: one thread per output word.  The thread ORs in the at most
// ceil(32/width)+1 elements whose bits overlap its word, so no atomics are
// needed and the result is deterministic.  Neighbouring threads read
// neighbouring elements, which L1 serves.  Left for later work: for small
// widths each element is read by two threads, and a block could instead
// stage 32*width elements in shared memory and emit width words at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// C cast semantics on the pre-scaled plane: NaN -> 0 (tested before any
// cast, never by cast), < 0 -> 0, >= 2^width -> 2^width - 1, else trunc.
__device__ __forceinline__ uint32_t scaled_to_bin(float s, int width,
                                                  uint32_t top) {
  if (isnan(s) || s < 0.0f) return 0u;
  if (s >= static_cast<float>(1u << width)) return top;
  return static_cast<uint32_t>(s);
}

template <bool kFromF32>
__global__ void pack_uniform_kernel(const void* __restrict__ vals, int64_t n,
                                    int width, uint32_t* __restrict__ out,
                                    int64_t n_words) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= n_words) return;
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
  const int64_t bit0 = q * 32;
  int64_t i_end = (bit0 + 32 + width - 1) / width;  // first element at or
  if (i_end > n) i_end = n;                          // past bit0 + 32
  uint32_t word = 0;
  for (int64_t i = bit0 / width; i < i_end; ++i) {
    uint32_t v;
    if (kFromF32) {
      v = scaled_to_bin(static_cast<const float*>(vals)[i], width, mask);
    } else {
      v = static_cast<const uint32_t*>(vals)[i] & mask;
    }
    const int64_t sh = i * width - bit0;  // in (-width, 32)
    word |= sh >= 0 ? (v << sh) : (v >> -sh);
  }
  out[q] = word;
}

}  // namespace

extern "C" int mnw_pack_uniform(const void* vals, int64_t n, int width,
                                int from_f32, void* out, int64_t n_words,
                                void* stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (n_words + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (from_f32) {
    pack_uniform_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(vals, n, width, o, n_words);
  } else {
    pack_uniform_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(vals, n, width, o, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
