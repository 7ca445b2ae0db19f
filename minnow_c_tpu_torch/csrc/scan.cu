// K9: inclusive u32 prefix sum mod 2^32 of one stream, bit-identical to
// jnp.cumsum on u32 (and to the int64 cumsum masked to 32 bits of
// ops/scan_cuda.cumsum_u32_plain).  Replaces the Pallas kernel
// minnow_c_tpu/ops/scan_pallas.py:cumsum_u32 (_tile_prefix, _cumsum_kernel).
// The delta codecs' decode runs it over the un-zigzagged deltas of a plane.
//
// Bound on the card: memory.  Per element it reads 4 bytes twice and writes
// 4 bytes once.
//
// Design (reduce, scan the sums, rescan): launch 1 sums each tile of 4096
// elements (256 threads x 16); launch 2, one block, turns the tile sums into
// each tile's carry (exclusive scan, scan.cuh); launch 3 rescans each tile
// with its carry and writes.  A tile is staged in shared memory with one
// pad word every 32, so both the coalesced global loads / stores and the
// per-thread runs of 16 consecutive elements are free of bank conflicts.
// The TPU kernel's tile cascade (2^19, 2^16, 2^14) and its n >= 2^14
// cut-over exist for the TPU's per-grid-step latency and are dropped: every
// n runs the same three launches.
// Left for later work: a single-pass decoupled look-back scan, which reads
// the input once.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void tile_sums_kernel(const uint32_t* __restrict__ x, int64_t n,
                                 uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_sums[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    if (i < n) s += x[i];
  }
  uint32_t total;
  mnw::block_exclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void tile_scan_kernel(const uint32_t* __restrict__ x, int64_t n,
                                 const uint32_t* __restrict__ carries,
                                 uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile + kTile / 32];
  __shared__ uint32_t warp_sums[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    tile[padded(i)] = base + i < n ? x[base + i] : 0u;
  }
  __syncthreads();
  uint32_t v[kItems];
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += tile[padded(threadIdx.x * kItems + j)];
    v[j] = s;
  }
  uint32_t total;
  const uint32_t ex = mnw::block_exclusive_scan(s, warp_sums, &total) +
                      carries[blockIdx.x];
  // Each thread rewrites only the elements it read itself.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    tile[padded(threadIdx.x * kItems + j)] = v[j] + ex;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (base + i < n) out[base + i] = tile[padded(i)];
  }
}

}  // namespace

// scratch holds 2 * ceil(n / 4096) words: the tile sums, then the carries.
extern "C" int mnw_cumsum_u32(const void* x, int64_t n, void* scratch,
                              void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  auto* sums = static_cast<uint32_t*>(scratch);
  uint32_t* carries = sums + tiles;
  const auto* in = static_cast<const uint32_t*>(x);
  tile_sums_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(in, n,
                                                                      sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mnw::exclusive_scan_one_block<<<1, mnw::kScanOneBlockThreads, 0, s>>>(
      sums, tiles, 0u, carries);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, n, carries, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
