// K7: uniform-width bitpack of R rows of n u32 bins each (32 | n), every row
// its own stream.  K4: the same pack of one plane of any length, from u32
// bins or from a pre-scaled f32 plane (delta * 2^width) that it first
// truncates and clamps.
//
// K7 replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:
// pack_pallas_rows (_pack_rows_kernel), which the snapshot writer packs
// every field with; K4 replaces encode_pallas.py:pack_pallas (_pack_body,
// _scaled_to_bins).  Layout is util.c's: bit b of element i lands at global
// bit i*width + b; spare bits of the last word are zero.  Output bits equal
// encode_cuda.pack_plain / pack_rows_plain and the JAX package's packs.
//
// With 32 | n every row packs into exactly (n / 32) * width words and
// starts on a word boundary, so the rows pack is the pack of the flattened
// R * n elements: K7 and K4 are one kernel.
//
// Bound on the card: memory.  Per element it reads 4 bytes and writes
// width/8 bytes (0.72 ms for 192 rows of 2^21 at 16 bits at 3.35 TB/s).
//
// Design: the flat stream is cut into tiles of `tile` elements (a multiple
// of 1024, from the wrapper's plan, ops/encode_cuda.pack_plan); every tile
// packs into tile / 32 * width words, which start on a 16-byte boundary.  A
// persistent grid of a few blocks per SM walks the tiles.  A block loads a
// tile with coalesced 16-byte loads (4-byte ones when the input is not
// 16-byte aligned, and past the end of a ragged plane) into registers, so
// the next tile's loads are in flight while the current tile is packed;
// the registers go to shared memory (element i at word i + i / 32, a skew
// that keeps the loads of neighbouring threads' first elements on distinct
// banks), bins masked (or, from f32, truncated and clamped: bins.cuh
// scaled_to_bin) and zero past the end of the plane.  Each thread then
// assembles four consecutive output words from the at most ceil(32/w)+1
// bins overlapping each, with constant shifts (the width is a template
// parameter, 1-32) and 32-bit index math, and writes them as one 16-byte
// store: neighbouring threads, neighbouring 16 bytes.  No atomics, no 64-bit
// division.  The recip encodes (K5, K8, K12) keep bins.cuh's pack_word.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;  // 16-byte chunks a thread loads, tile <= 4096

struct PackArgs {
  const uint32_t* vals;  // u32 bins, or the bits of pre-scaled f32 values
  int64_t n;             // elements
  int64_t n_words;       // ceil(n * width / 32)
  int64_t tiles;         // ceil(n / tile)
  int tile;              // elements per tile, a multiple of 1024
  int vec16;             // vals starts on a 16-byte boundary
  uint32_t* out;
};

__device__ __forceinline__ uint32_t skew(uint32_t i) { return i + (i >> 5); }

// Loads chunk c (elements 4 * (c * kThreads + thread)) of tile t into r.
__device__ __forceinline__ void load_tile(const PackArgs& a, int64_t t,
                                          uint4 (&r)[kChunks]) {
  const int64_t e0 = t * a.tile;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t e = e0 + 4 * (c * kThreads + threadIdx.x);
    if (c * kThreads * 4 >= a.tile) break;
    if (a.vec16 && e + 4 <= a.n) {
      r[c] = __ldg(reinterpret_cast<const uint4*>(a.vals + e));
    } else {
      uint32_t v[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) v[l] = e + l < a.n ? __ldg(a.vals + e + l)
                                                     : 0u;
      r[c] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int W, bool kFromF32>
__device__ __forceinline__ uint32_t to_bin(uint32_t v) {
  constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  if (kFromF32) return mnw::scaled_to_bin(__uint_as_float(v), W, kMask);
  return v & kMask;
}

// Word k of the tile from the skewed bins in s.
template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t* s, uint32_t k) {
  const uint32_t bit0 = k * 32;
  const uint32_t i = bit0 / W;
  const int sh = static_cast<int>(i * W) - static_cast<int>(bit0);  // <= 0
  uint32_t w = s[skew(i)] >> -sh;
#pragma unroll
  for (int m = 1; m <= (32 + W - 1) / W; ++m) {
    const int at = sh + m * W;
    if (at < 32) w |= s[skew(i + m)] << at;
  }
  return w;
}

template <int W, bool kFromF32>
__global__ void __launch_bounds__(kThreads, 4)
pack_tiles_kernel(const PackArgs a) {
  extern __shared__ uint32_t s[];
  const int wpt = a.tile / 32 * W;
  uint4 r[kChunks];
  int64_t t = blockIdx.x;
  if (t < a.tiles) load_tile(a, t, r);
  for (; t < a.tiles; t += gridDim.x) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * kThreads * 4 >= a.tile) break;
      const uint32_t i = 4 * (c * kThreads + threadIdx.x);
      s[skew(i)] = to_bin<W, kFromF32>(r[c].x);
      s[skew(i + 1)] = to_bin<W, kFromF32>(r[c].y);
      s[skew(i + 2)] = to_bin<W, kFromF32>(r[c].z);
      s[skew(i + 3)] = to_bin<W, kFromF32>(r[c].w);
    }
    __syncthreads();
    const int64_t next = t + gridDim.x;
    if (next < a.tiles) load_tile(a, next, r);
    const int64_t w0 = t * wpt;
    for (uint32_t g = threadIdx.x; 4 * g < static_cast<uint32_t>(wpt);
         g += kThreads) {
      const int64_t w = w0 + 4 * g;
      if (w >= a.n_words) break;
      uint32_t v[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) v[l] = word_at<W>(s, 4 * g + l);
      if (w + 4 <= a.n_words) {
        __stwb(reinterpret_cast<uint4*>(a.out + w),
               make_uint4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (w + l < a.n_words) a.out[w + l] = v[l];
        }
      }
    }
    __syncthreads();
  }
}

using PackLaunch = void (*)(const PackArgs&, unsigned, int, cudaStream_t);

template <int W, bool kFromF32>
void launch_pack(const PackArgs& a, unsigned grid, int smem,
                 cudaStream_t st) {
  pack_tiles_kernel<W, kFromF32><<<grid, kThreads, smem, st>>>(a);
}

template <int... Ws>
PackLaunch pack_table(int width, bool from_f32,
                      std::integer_sequence<int, Ws...>) {
  PackLaunch u32[] = {&launch_pack<Ws + 1, false>...};
  PackLaunch f32[] = {&launch_pack<(Ws < 24 ? Ws + 1 : 24), true>...};
  return from_f32 ? f32[width - 1] : u32[width - 1];
}

}  // namespace

// K4 and K7: width 1-32 (1-24 from f32); tiles, tile, vec16, grid and
// smem_bytes come from the wrapper's plan.
extern "C" int mnw_pack_tiles(const void* vals, int64_t n, int width,
                              int from_f32, int64_t tiles, int tile,
                              int vec16, unsigned grid, int smem_bytes,
                              void* out, int64_t n_words, void* stream) {
  if (width < 1 || width > (from_f32 ? 24 : 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackArgs a{static_cast<const uint32_t*>(vals), n, n_words, tiles, tile,
             vec16, static_cast<uint32_t*>(out)};
  pack_table(width, from_f32 != 0, std::make_integer_sequence<int, 32>())(
      a, grid, smem_bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
