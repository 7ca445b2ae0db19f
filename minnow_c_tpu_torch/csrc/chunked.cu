// K10 and K11: the decode of a chunked-width delta plane (Coil v1.1 and
// Octo v1.1 at 16384-element chunks).
//
// K10 (decode_chunk_kernel<false>): per-chunk-width unpack of the
// column-major chunk bodies -> optional un-zigzag -> optional global
// inclusive u32 prefix sum + `first` -> u32 bins.  K11
// (decode_chunk_kernel<true>): the same pass, with the store of a bin
// replaced by K1's tail: Threefry dither + x0 + dx_bin*(bin + u) + optional
// periodic rewrap -> f32 (dither.cuh, shared with decode.cu).  They replace
// the one Pallas kernel minnow_c_tpu/ops/chunked_pallas.py:_delta_kernel
// behind chunked_delta_bins / decode_chunked_stream (floats=False) and
// decode_chunked_stream_floats (floats=True, _undo_floats_tail).
//
// Wire layout (doc/wire_format.md, algo_coil_v1_1.py): chunk ci of 16384
// elements packs at widths[ci] <= 32 bits into 512 * w words starting at
// word woff[ci]; its words are stored column-major: flat word f = c*128 + m
// holds natural bitstream word 4*w*m + c.  Element e of the plane uses
// dither counter e >> 2, lane e & 3.
//
// Bound on the card: memory.  K10 reads the packed words twice (w/4 bytes
// per element) and writes 4 bytes; K11 writes 4 bytes of f32 and adds 13
// Threefry rounds per 4 elements, still below the bandwidth line.
//
// Design: one block of 512 threads per chunk.  A block stages its chunk's
// words in shared memory in natural order (coalesced global reads; one pad
// word every 32 against bank conflicts), then thread t decodes elements
// 32t .. 32t+31, which occupy natural words t*w .. t*w+w-1 exactly, through
// a 64-bit bit buffer.  The carry across chunks comes from a first pass
// (chunk_totals_kernel) that only sums each chunk's deltas, an exclusive scan
// of the chunk totals seeded with `first` (scan.cuh), and the
// second pass, which re-unpacks, scans the chunk in-block, adds its carry
// and writes once.  Width-0 chunks have no words and carry the sum through.
// Nothing reads past the body: the wrapper checks that the body holds every
// chunk's words.  The TPU kernel's answers to TPU limits are dropped: the
// single-grid-step DMA loop, the body padding for fixed-size DMA, and the
// lax.switch over the widths present (width is a run-time value here).
// Left for later work: a single pass with a decoupled look-back over chunk
// totals, which reads the words once.

#include <cstdint>
#include <cuda_runtime.h>

#include "dither.cuh"
#include "scan.cuh"

namespace {

constexpr int kChunk = 16384;
constexpr int kThreads = 512;
constexpr int kItems = kChunk / kThreads;  // 32 elements = w words a thread
constexpr int kM = kChunk / 128;           // columns of the wire layout

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// Shared memory words for a chunk of width w (natural order, padded).
__host__ __device__ inline int staged_words(int w) {
  return kChunk / 32 * w + kChunk / 32 * w / 32 + 1;
}

// Copies chunk ci's 512*w words from the column-major wire layout into s in
// natural order.  Every thread of the block must call it.
__device__ __forceinline__ void stage_chunk(const uint32_t* __restrict__ body,
                                            int64_t woff, int w,
                                            uint32_t* s) {
  const int nw = kChunk / 32 * w;
  for (int f = threadIdx.x; f < nw; f += kThreads) {
    const int c = f / kM;
    const int m = f % kM;
    s[padded(4 * w * m + c)] = body[woff + f];
  }
  __syncthreads();
}

// This thread's 32 consecutive elements of the staged chunk, optionally
// un-zigzagged (logical shift: (z >> 1) ^ -(z & 1) in u32).
__device__ __forceinline__ void thread_values(const uint32_t* s, int w,
                                              int zigzag,
                                              uint32_t v[kItems]) {
  const uint32_t mask = w == 32 ? 0xFFFFFFFFu : (1u << w) - 1u;
  int k = threadIdx.x * w;
  uint64_t buf = 0;
  int nbits = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    uint32_t z = 0;
    if (w != 0) {
      if (nbits < w) {  // never past word t*w + w - 1: 32 elements = w words
        buf |= static_cast<uint64_t>(s[padded(k++)]) << nbits;
        nbits += 32;
      }
      z = static_cast<uint32_t>(buf) & mask;
      buf >>= w;
      nbits -= w;
    }
    v[j] = zigzag ? (z >> 1) ^ (0u - (z & 1u)) : z;
  }
}

// First pass: the u32 sum of each chunk's (un-zigzagged) values.
__global__ void chunk_totals_kernel(const uint32_t* __restrict__ body,
                                    const int64_t* __restrict__ woff,
                                    const uint8_t* __restrict__ widths,
                                    int zigzag,
                                    uint32_t* __restrict__ totals) {
  extern __shared__ uint32_t s[];
  __shared__ uint32_t warp_sums[32];
  const int ci = blockIdx.x;
  const int w = widths[ci];
  stage_chunk(body, woff[ci], w, s);
  uint32_t v[kItems];
  thread_values(s, w, zigzag, v);
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) sum += v[j];
  uint32_t total;
  mnw::block_exclusive_scan(sum, warp_sums, &total);
  if (threadIdx.x == 0) totals[ci] = total;
}

// Second pass (K10 with kFloats = false, K11 with kFloats = true).  carries
// holds each chunk's exclusive prefix plus `first` (unused without prefix).
template <bool kFloats>
__global__ void decode_chunk_kernel(
    const uint32_t* __restrict__ body, const int64_t* __restrict__ woff,
    const uint8_t* __restrict__ widths, int64_t n, int zigzag, int prefix,
    const uint32_t* __restrict__ carries, uint32_t k0, uint32_t k1, float x0,
    float dx_bin, float box, int periodic, void* __restrict__ out) {
  extern __shared__ uint32_t s[];
  __shared__ uint32_t warp_sums[32];
  const int ci = blockIdx.x;
  const int w = widths[ci];
  stage_chunk(body, woff[ci], w, s);
  uint32_t v[kItems];
  thread_values(s, w, zigzag, v);
  if (prefix) {
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sum += v[j];
      v[j] = sum;
    }
    uint32_t total;
    const uint32_t ex =
        mnw::block_exclusive_scan(sum, warp_sums, &total) + carries[ci];
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] += ex;
  }
  const int64_t e0 = static_cast<int64_t>(ci) * kChunk +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  if (e0 >= n) return;
  const bool whole = e0 + kItems <= n;
  if (kFloats) {
    float x[kItems];
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      float u[4];
      mnw::dither_quad(k0, k1, static_cast<uint32_t>((e0 >> 2) + q), u);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        x[4 * q + l] =
            mnw::undo_bin(v[4 * q + l], u[l], x0, dx_bin, box, periodic);
      }
    }
    float* o = static_cast<float*>(out) + e0;
    if (whole) {  // e0 is a multiple of 32: 16-byte aligned
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        reinterpret_cast<float4*>(o)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      }
    } else {
      for (int j = 0; j < kItems && e0 + j < n; ++j) o[j] = x[j];
    }
  } else {
    uint32_t* o = static_cast<uint32_t*>(out) + e0;
    if (whole) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        reinterpret_cast<uint4*>(o)[q] =
            make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    } else {
      for (int j = 0; j < kItems && e0 + j < n; ++j) o[j] = v[j];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// body: the plane's packed words; woff (int64) and widths (u8): per chunk,
// on the card.  scratch holds 2 * n_chunks words (totals, then carries);
// with prefix = 0 it is not touched.  floats selects K11 (out f32) over K10
// (out u32).
extern "C" int mnw_chunked_decode(
    const void* body, const void* woff, const void* widths, int64_t n_chunks,
    int max_width, int64_t n, int zigzag, int prefix, uint32_t first,
    void* scratch, int floats, uint32_t k0, uint32_t k1, float x0,
    float dx_bin, float box, int periodic, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(body);
  const auto* wo = static_cast<const int64_t*>(woff);
  const auto* wd = static_cast<const uint8_t*>(widths);
  auto* totals = static_cast<uint32_t*>(scratch);
  uint32_t* carries = totals + n_chunks;
  const int smem = staged_words(max_width) * 4;
  const auto grid = static_cast<unsigned>(n_chunks);
  cudaError_t err;
  if (prefix) {
    err = allow_smem(chunk_totals_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    chunk_totals_kernel<<<grid, kThreads, smem, s>>>(b, wo, wd, zigzag,
                                                     totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mnw::exclusive_scan_one_block<<<1, mnw::kScanOneBlockThreads, 0, s>>>(
        totals, n_chunks, first, carries);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (floats) {
    err = allow_smem(decode_chunk_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_chunk_kernel<true><<<grid, kThreads, smem, s>>>(
        b, wo, wd, n, zigzag, prefix, carries, k0, k1, x0, dx_bin, box,
        periodic, out);
  } else {
    err = allow_smem(decode_chunk_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_chunk_kernel<false><<<grid, kThreads, smem, s>>>(
        b, wo, wd, n, zigzag, prefix, carries, k0, k1, x0, dx_bin, box,
        periodic, out);
  }
  return static_cast<int>(cudaGetLastError());
}
