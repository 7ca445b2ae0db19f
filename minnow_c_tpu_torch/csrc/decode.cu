// The decode kernels of the Trim planes.
//
// K1 (decode_uniform_kernel): fused uniform decode of one plane -- unpack,
// Threefry-2x32-13 dither, undo of the bin index, optional periodic rewrap --
// in one pass.  Replaces minnow_c_tpu/ops/decode_pallas.py:decode_pallas
// (_decode_body, _unpack_128, _threefry13_tile).
//
// K2 (decode_rows_kernel): K1 over R independent streams in one launch, each
// with its own key, x0 and bin width, the dither counter restarting at 0 in
// every row.  Replaces decode_pallas.py:decode_pallas_rows
// (_decode_rows_kernel).  The snapshot reader decodes all blocks of a field
// dimension with it.
//
// K3 (unpack_rows_kernel): bare unpack of R streams to u32 bins.  Replaces
// decode_pallas.py:unpack_pallas_rows (_unpack_rows_kernel); the snapshot
// reader's ID planes.
//
// Output bits equal the plain torch versions in ops/decode_cuda.py and the
// JAX package's decode (the dither is part of the wire, so the cipher is
// Threefry bit for bit, dither.cuh).
//
// Bound on the card: memory.  Per element K1 and K2 read width/8 bytes of
// packed words and write 4 bytes of f32; the 13 cipher rounds are shared by
// four elements, so the arithmetic stays below the bandwidth line.  K3 reads
// width/8 bytes and writes 4.
//
// Design: K1 and K2 run one thread per Threefry counter, i.e. 4 consecutive
// elements per thread, through one __device__ function (decode_quad).  Each
// element takes a 64-bit funnel window of two words (served from L1 for
// neighbouring threads).  The dither and the undo of a bin are dither.cuh's,
// shared with K11 (chunked.cu).  Every float step names its rounding
// (__fadd_rn, __fmaf_rn), and the library is compiled with -fmad=false so
// that the compiler contracts nothing else.  The rows kernels flatten (row,
// element) onto a 1-D grid, so any row count fits the grid's x dimension; K2
// splits the flat index into row and counter, K3 needs no split at all,
// because 32 | n starts every row's stream on a word boundary and the rows
// are one contiguous stream.
// Left for later work: vectorised 16-byte loads/stores, staging the words of
// a block in shared memory, and grid-stride loops over a persistent grid.

#include <cstdint>
#include <cuda_runtime.h>

#include "dither.cuh"

namespace {

constexpr int kThreads = 256;

// Decodes elements e0 .. e0+3 (those below n) of one stream: words holds its
// n_words packed u32 words, out its n floats, and the four elements share
// dither counter ctr.
__device__ __forceinline__ void decode_quad(
    const uint32_t* __restrict__ words, int64_t n_words, uint32_t k0,
    uint32_t k1, uint32_t ctr, int64_t e0, int64_t n, int width, float x0,
    float dx_bin, float box, int periodic, float* __restrict__ out) {
  float u[4];
  mnw::dither_quad(k0, k1, ctr, u);
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
    out[e] = mnw::undo_bin(bin, u[l], x0, dx_bin, box, periodic);
  }
}

// K1.  Element e of the plane uses dither counter ctr0 + e/4 (ctr0 = the
// plane's first element / 4).
__global__ void decode_uniform_kernel(const uint32_t* __restrict__ words,
                                      int64_t n_words, uint32_t k0,
                                      uint32_t k1, float x0, float dx_bin,
                                      float box, int64_t n, int width,
                                      int64_t ctr0, int periodic,
                                      float* __restrict__ out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q * 4 >= n) return;
  decode_quad(words, n_words, k0, k1, static_cast<uint32_t>(ctr0 + q), q * 4,
              n, width, x0, dx_bin, box, periodic, out);
}

// K2.  rows streams of n elements (32 | n), each (n / 32) * width words;
// keys holds (k0, k1) per row.
__global__ void decode_rows_kernel(const uint32_t* __restrict__ words,
                                   int64_t rows, int64_t n, int width,
                                   const uint32_t* __restrict__ keys,
                                   const float* __restrict__ x0,
                                   const float* __restrict__ dx_bin,
                                   float box, int periodic,
                                   float* __restrict__ out) {
  const int64_t quads = n / 4;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= rows * quads) return;
  const int64_t r = q / quads;
  const int64_t c = q - r * quads;  // the counter, from 0 in every row
  const int64_t row_words = n / 32 * width;
  decode_quad(words + r * row_words, row_words, keys[2 * r], keys[2 * r + 1],
              static_cast<uint32_t>(c), c * 4, n, width, x0[r], dx_bin[r],
              box, periodic, out + r * n);
}

// K3.  One thread per element of the flattened rows (total = rows * n).
__global__ void unpack_rows_kernel(const uint32_t* __restrict__ words,
                                   int64_t total, int width,
                                   uint32_t* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= total) return;
  const uint64_t start = static_cast<uint64_t>(e) * width;
  const int64_t j = static_cast<int64_t>(start >> 5);
  const int off = static_cast<int>(start & 31);
  uint64_t window = words[j];
  // Read the next word only when the element crosses into it: the last
  // element of the stream never does, since the stream ends on a word.
  if (off + width > 32) window |= static_cast<uint64_t>(words[j + 1]) << 32;
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
  out[e] = static_cast<uint32_t>(window >> off) & mask;
}

unsigned grid_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int mnw_decode_uniform(const void* words, int64_t n_words,
                                  uint32_t k0, uint32_t k1, float x0,
                                  float dx_bin, float box, int64_t n,
                                  int width, int64_t ctr0, int periodic,
                                  void* out, void* stream) {
  decode_uniform_kernel<<<grid_for((n + 3) / 4), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, k0, k1, x0, dx_bin, box,
      n, width, ctr0, periodic, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mnw_decode_rows(const void* words, int64_t rows, int64_t n,
                               int width, const void* keys, const void* x0,
                               const void* dx_bin, float box, int periodic,
                               void* out, void* stream) {
  decode_rows_kernel<<<grid_for(rows * (n / 4)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), rows, n, width,
      static_cast<const uint32_t*>(keys), static_cast<const float*>(x0),
      static_cast<const float*>(dx_bin), box, periodic,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mnw_unpack_rows(const void* words, int64_t rows, int64_t n,
                               int width, void* out, void* stream) {
  unpack_rows_kernel<<<grid_for(rows * n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), rows * n, width,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mnw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
