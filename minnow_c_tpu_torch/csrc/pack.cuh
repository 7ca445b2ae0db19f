// The tile routine of the pack kernels: uniform-width bitpack of a flat
// stream of n elements into ceil(n * W / 32) words (util.c's layout: bit b
// of element i lands at global bit i*W + b; spare bits of the last word are
// zero), each element first mapped to its bin by an element policy:
//
//   MaskBins<W>       u32 bins, masked to W bits (K4, K7);
//   ScaledBins<W>     pre-scaled f32 values, truncated and clamped (K4);
//   RecipBins<W, C>   raw f32 values through the recip map of their row,
//                     with per-row (or one stream's) x0, recip, box and
//                     anchor (K5, K8; K12's third step with C = true, which
//                     reads the row scalars through L2 because the same
//                     launch wrote them).
//
// Used by pack.cu (K4, K5, K7, K8) and encode_recip.cu (K12).
//
// The flat stream is cut into tiles of `tile` elements (a multiple of 1024,
// from the wrapper's plan, ops/encode_cuda.pack_plan); every tile packs into
// tile / 32 * W words, which start on a 16-byte boundary.  The blocks of a
// persistent grid walk the tiles.  A block loads a tile with coalesced
// 16-byte loads (4-byte ones when the input is not 16-byte aligned, and past
// the end of a ragged plane) into registers, so the next tile's loads are in
// flight while the current tile is packed; the registers go through the
// policy to shared memory (element i at word i + i / 32, a skew that keeps
// the stores of neighbouring threads on distinct banks), zero past the end
// of the plane.  Each thread then assembles four consecutive output words
// from the at most ceil(32/W)+1 bins overlapping each, with constant shifts
// (W is a template parameter, 1-32) and 32-bit index math, and writes them
// as one 16-byte store: neighbouring threads, neighbouring 16 bytes.  No
// atomics, no 64-bit division per element.
//
// Rows (RecipBins): with 4 | n a thread's 4-element chunk lies in one row.
// One thread finds the tile's first row, its offset there and that row's
// scalars once per tile (one 64-bit division), for the next tile while the
// current one is packed; a chunk past the end of that row finds its row
// with rows.cuh's 32-bit magic division and loads its scalars.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bins.cuh"
#include "rows.cuh"

namespace mnw {

constexpr int kPackThreads = 256;
constexpr int kPackChunks = 4;  // 16-byte chunks a thread loads, tile <= 4096

struct PackArgs {
  const uint32_t* vals;  // u32 bins, or the bits of f32 values
  int64_t n;             // elements
  int64_t n_words;       // ceil(n * width / 32)
  int64_t tiles;         // ceil(n / tile)
  int tile;              // elements per tile, a multiple of 1024
  int vec16;             // vals starts on a 16-byte boundary
  uint32_t* out;
};

// A tile's first row, its offset in that row, and that row's scalars.
struct TileRow {
  int64_t row0;
  uint32_t off0;
  RecipParams p;
};

__device__ __forceinline__ uint32_t skew(uint32_t i) { return i + (i >> 5); }

template <int W>
struct MaskBins {
  static constexpr bool kRows = false;
  __device__ __forceinline__ TileRow first_row(int64_t) const { return {}; }
  __device__ __forceinline__ uint32_t bin(uint32_t v) const {
    return v & (W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u);
  }
  __device__ __forceinline__ void map4(const uint4& v, int64_t, uint32_t,
                                       const TileRow&, uint32_t (&b)[4]) const {
    b[0] = bin(v.x);
    b[1] = bin(v.y);
    b[2] = bin(v.z);
    b[3] = bin(v.w);
  }
};

template <int W>
struct ScaledBins {
  static constexpr bool kRows = false;
  __device__ __forceinline__ TileRow first_row(int64_t) const { return {}; }
  __device__ __forceinline__ uint32_t bin(uint32_t v) const {
    return scaled_to_bin(__uint_as_float(v), W, (1u << W) - 1u);
  }
  __device__ __forceinline__ void map4(const uint4& v, int64_t, uint32_t,
                                       const TileRow&, uint32_t (&b)[4]) const {
    b[0] = bin(v.x);
    b[1] = bin(v.y);
    b[2] = bin(v.z);
    b[3] = bin(v.w);
  }
};

// Per-row scalars of the recip map: (R,) arrays, or, with x0 null, one
// stream's scalars.  A null box or anchor array gives every row the scalar.
struct RecipRows {
  const float* x0;
  const float* recip;
  const float* box;
  const float* anchor;
  RecipParams one;   // the one stream's, and box / anchor without arrays
  uint32_t n;        // elements per row (rows only; 4 | n, n <= 2^31)
  uint32_t n_magic;  // rows.cuh's magic for n; 0: one stream
  int periodic;
};

template <int W, bool kCoherent>
struct RecipBins {
  static constexpr bool kRows = true;
  RecipRows r;
  int64_t n;  // elements in the stream: past it, bins are 0

  __device__ __forceinline__ float ld(const float* p) const {
    return kCoherent ? __ldcg(p) : __ldg(p);
  }
  __device__ __forceinline__ RecipParams params(int64_t row) const {
    if (!r.x0) return r.one;
    return {ld(r.x0 + row), ld(r.recip + row),
            r.box ? ld(r.box + row) : r.one.box,
            r.anchor ? ld(r.anchor + row) : r.one.anchor};
  }
  __device__ __forceinline__ TileRow first_row(int64_t e0) const {
    if (!r.n_magic) return {0, 0u, params(0)};
    const int64_t row0 = e0 / r.n;
    return {row0, static_cast<uint32_t>(e0 - row0 * r.n), params(row0)};
  }
  // the 4 elements from in-tile offset i (element e of the stream)
  __device__ __forceinline__ void map4(const uint4& v, int64_t e, uint32_t i,
                                       const TileRow& t,
                                       uint32_t (&b)[4]) const {
    uint32_t off = t.off0 + i;
    const RecipParams p =
        !r.n_magic || off < r.n
            ? t.p
            : params(t.row0 + split_row(off, r.n, r.n_magic));
    const RecipMap<W> map(p, r.periodic);
    b[0] = map(__uint_as_float(v.x));
    b[1] = map(__uint_as_float(v.y));
    b[2] = map(__uint_as_float(v.z));
    b[3] = map(__uint_as_float(v.w));
    if (e + 4 > n) {  // the ragged end of one plane
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (e + l >= n) b[l] = 0u;
      }
    }
  }
};

// Loads chunk c (elements 4 * (c * threads + thread)) of tile t into r.
__device__ __forceinline__ void load_tile(const PackArgs& a, int64_t t,
                                          uint4 (&r)[kPackChunks]) {
  const int64_t e0 = t * a.tile;
#pragma unroll
  for (int c = 0; c < kPackChunks; ++c) {
    const int64_t e = e0 + 4 * (c * kPackThreads + threadIdx.x);
    if (c * kPackThreads * 4 >= a.tile) break;
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

// Packs every tile of a (blocks b, b + gridDim.x, ...) through bins; s is
// the tile's shared memory, tile + tile / 32 words.  Every thread of the
// block calls it.
template <int W, class Bins>
__device__ __forceinline__ void pack_tiles(const PackArgs& a,
                                           const Bins& bins, uint32_t* s) {
  __shared__ TileRow row_s;
  const int wpt = a.tile / 32 * W;
  uint4 r[kPackChunks];
  int64_t t = blockIdx.x;
  if (t < a.tiles) load_tile(a, t, r);
  if constexpr (Bins::kRows) {
    if (threadIdx.x == 0 && t < a.tiles) row_s = bins.first_row(t * a.tile);
    __syncthreads();
  }
  for (; t < a.tiles; t += gridDim.x) {
    const int64_t e0 = t * a.tile;
    TileRow row{};
    if constexpr (Bins::kRows) row = row_s;
#pragma unroll
    for (int c = 0; c < kPackChunks; ++c) {
      if (c * kPackThreads * 4 >= a.tile) break;
      const uint32_t i = 4 * (c * kPackThreads + threadIdx.x);
      uint32_t b[4];
      bins.map4(r[c], e0 + i, i, row, b);
      s[skew(i)] = b[0];
      s[skew(i + 1)] = b[1];
      s[skew(i + 2)] = b[2];
      s[skew(i + 3)] = b[3];
    }
    __syncthreads();
    const int64_t next = t + gridDim.x;
    if (next < a.tiles) {
      load_tile(a, next, r);
      // every thread read row_s before the barrier above
      if constexpr (Bins::kRows) {
        if (threadIdx.x == 0) row_s = bins.first_row(next * a.tile);
      }
    }
    const int64_t w0 = t * wpt;
    for (uint32_t g = threadIdx.x; 4 * g < static_cast<uint32_t>(wpt);
         g += kPackThreads) {
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

}  // namespace mnw
