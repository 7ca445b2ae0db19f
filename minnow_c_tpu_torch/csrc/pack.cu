// K4: uniform-width bitpack of one plane, from u32 bins or from a pre-scaled
// f32 plane (delta * 2^width) that it first truncates and clamps.
// K7: the same pack of R rows of n u32 bins each, every row its own stream.
//
// K4 replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:pack_pallas
// (_pack_body, _scaled_to_bins), K7 encode_pallas.py:pack_pallas_rows
// (_pack_rows_kernel), which the snapshot writer packs every field with.
// Layout is util.c's: bit b of element i lands at global bit i*width + b;
// spare bits of the last word are zero.  Output bits equal
// encode_cuda.pack_plain / pack_rows_plain and the JAX package's packs.
//
// K7 needs 32 | n.  Then every row packs into exactly (n / 32) * width words
// and starts on a word boundary, so the rows pack is K4's pack of the
// flattened R * n elements: K7 launches K4's device code over them.
//
// Bound on the card: memory.  Per element it reads 4 bytes and writes
// width/8 bytes.
//
// Design: one thread per output word.  The thread ORs in the at most
// ceil(32/width)+1 elements whose bits overlap its word (bins.cuh:
// pack_word, shared with the recip encodes), so no atomics are needed and
// the result is deterministic.  Neighbouring threads read
// neighbouring elements, which L1 serves.  Left for later work: for small
// widths each element is read by two threads, and a block could instead
// stage 32*width elements in shared memory and emit width words at once.

#include <cstdint>
#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

template <bool kFromF32>
__global__ void pack_uniform_kernel(const void* __restrict__ vals, int64_t n,
                                    int width, uint32_t* __restrict__ out,
                                    int64_t n_words) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= n_words) return;
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
  out[q] = mnw::pack_word(q, n, width, [&](int64_t i) {
    if (kFromF32) {
      return mnw::scaled_to_bin(static_cast<const float*>(vals)[i], width,
                                mask);
    }
    return static_cast<const uint32_t*>(vals)[i] & mask;
  });
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

extern "C" int mnw_pack_rows(const void* vals, int64_t rows, int64_t n,
                             int width, void* out, void* stream) {
  constexpr int kThreads = 256;
  const int64_t n_words = rows * (n / 32) * width;
  const int64_t blocks = (n_words + kThreads - 1) / kThreads;
  pack_uniform_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      vals, rows * n, width, static_cast<uint32_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}
