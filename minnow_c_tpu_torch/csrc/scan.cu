// K9: inclusive u32 prefix sum mod 2^32 of one stream, bit-identical to
// jnp.cumsum on u32 (and to the int64 cumsum masked to 32 bits of
// ops/scan_cuda.cumsum_u32_plain).  Replaces the Pallas kernel
// minnow_c_tpu/ops/scan_pallas.py:cumsum_u32 (_tile_prefix, _cumsum_kernel).
// The delta codecs' decode runs it over the un-zigzagged deltas of a plane.
//
// Bound on the card: memory.  Per element it must read 4 bytes and write 4
// (0.040 ms for 2^24 elements at 3.35 TB/s).
//
// Design: one launch, one read and one write of every element (a
// single-pass scan with decoupled look-back).  A persistent grid of small
// blocks (128 threads, 8 a SM, from the wrapper's plan) takes tiles of 4096
// elements (128 threads x 32) by ticket from an atomic counter: tiles are
// handed out in the order blocks ask, so a tile only ever waits on tiles
// whose blocks are running, whatever the grid's residency.  A block takes
// its next ticket and has that tile's 16-byte loads in flight in registers
// while it scans the current one (4-byte loads when the input is not
// 16-byte aligned, and for a ragged last tile).  A tile goes through shared
// memory skewed by one word every 32 (conflict-free both for the loads'
// stripes and for each thread's run of 32 consecutive elements), is summed
// per thread and across the block, and publishes its aggregate, then, once
// its carry is known, its inclusive prefix, as 64-bit status words; one warp
// looks back over up to 32 predecessors at a time (scan.cuh: the look-back
// code that K10 / K11 run too).
// The ticket counter and the status words are cleared by one
// cudaMemsetAsync on the launch's stream before the kernel (ops/scan_cuda.py
// keeps the buffer per device and stream, so calls on two streams never
// share one).
// u32 addition wraps and is associative, so any blocking gives the same
// bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 32;
constexpr int kTile = kThreads * kItems;
constexpr int kChunks = kItems / 4;  // 16-byte chunks a thread moves
constexpr int kBlocksPerSm = 8;

struct ScanArgs {
  const uint32_t* x;
  uint32_t* out;       // 16-byte aligned
  int64_t n;
  uint32_t tiles;      // ceil(n / kTile), below 2^31
  int vec16;           // x starts on a 16-byte boundary
  unsigned* counter;   // the tickets; 0 on entry
  uint64_t* status;    // one word per tile
};

__device__ __forceinline__ uint32_t skew(uint32_t i) { return i + (i >> 5); }

// Loads tile t's chunk c (elements 4 * (c * kThreads + thread)) into r[c].
__device__ __forceinline__ void load_tile(const ScanArgs& a, uint32_t t,
                                          uint4 (&r)[kChunks]) {
  const int64_t e0 = static_cast<int64_t>(t) * kTile;
  const int64_t left = a.n - e0;
  const int count = left < kTile ? static_cast<int>(left) : kTile;
  const uint32_t* x = a.x + e0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = 4 * (c * kThreads + threadIdx.x);
    if (a.vec16 && i + 4 <= count) {
      r[c] = __ldg(reinterpret_cast<const uint4*>(x + i));
    } else {
      r[c].x = i < count ? __ldg(x + i) : 0u;
      r[c].y = i + 1 < count ? __ldg(x + i + 1) : 0u;
      r[c].z = i + 2 < count ? __ldg(x + i + 2) : 0u;
      r[c].w = i + 3 < count ? __ldg(x + i + 3) : 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scan_kernel(const ScanArgs a) {
  __shared__ uint32_t tile[kTile + kTile / 32];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t ticket_s, next_s, carry_s;
  if (threadIdx.x == 0) ticket_s = atomicAdd(a.counter, 1u);
  __syncthreads();
  uint32_t t = ticket_s;
  uint4 r[kChunks];
  if (t < a.tiles) load_tile(a, t, r);
  while (t < a.tiles) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = 4 * (c * kThreads + threadIdx.x);
      tile[skew(i)] = r[c].x;
      tile[skew(i + 1)] = r[c].y;
      tile[skew(i + 2)] = r[c].z;
      tile[skew(i + 3)] = r[c].w;
    }
    if (threadIdx.x == 0) next_s = atomicAdd(a.counter, 1u);
    __syncthreads();
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) s += tile[skew(threadIdx.x * kItems + j)];
    uint32_t total;
    const uint32_t ex = mnw::block_exclusive_scan(s, warp_sums, &total);
    // the next tile's loads fly while this one looks back and stores
    const uint32_t next = next_s;
    if (next < a.tiles) load_tile(a, next, r);

    if (threadIdx.x < 32) {
      const uint32_t carry = mnw::tile_carry(a.status, t, total, 0u);
      if (threadIdx.x == 0) carry_s = carry;
    }
    __syncthreads();
    // Each thread rescans only the elements it summed itself.
    uint32_t run = carry_s + ex;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t k = skew(threadIdx.x * kItems + j);
      run += tile[k];
      tile[k] = run;
    }
    __syncthreads();

    const int64_t e0 = static_cast<int64_t>(t) * kTile;
    const int64_t left = a.n - e0;
    const int count = left < kTile ? static_cast<int>(left) : kTile;
    uint32_t* out = a.out + e0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = 4 * (c * kThreads + threadIdx.x);
      const uint4 w = make_uint4(tile[skew(i)], tile[skew(i + 1)],
                                 tile[skew(i + 2)], tile[skew(i + 3)]);
      if (i + 4 <= count) {
        *reinterpret_cast<uint4*>(out + i) = w;
      } else {
        if (i < count) out[i] = w.x;
        if (i + 1 < count) out[i + 1] = w.y;
        if (i + 2 < count) out[i + 2] = w.z;
      }
    }
    __syncthreads();  // the tile's shared memory is free for the next
    t = next;
  }
}

}  // namespace

// scratch: 8 bytes of ticket counter then one 64-bit status word per tile,
// all cleared here on the stream before the launch; tiles, grid (at most
// tiles, and at most 8 blocks a SM) and vec16 come from the wrapper
// (ops/scan_cuda.scan_plan).
extern "C" int mnw_cumsum_u32(const void* x, int64_t n, int64_t tiles,
                              unsigned grid, int vec16, void* scratch,
                              void* out, void* stream) {
  if (n < 1 || tiles != (n + kTile - 1) / kTile || tiles >= (1ll << 31) ||
      grid < 1 || grid > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<uint64_t*>(scratch);
  const cudaError_t rc =
      cudaMemsetAsync(words, 0, sizeof(uint64_t) * (1 + tiles), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const ScanArgs a{static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(out),
                   n,
                   static_cast<uint32_t>(tiles),
                   vec16,
                   reinterpret_cast<unsigned*>(words),
                   words + 1};
  scan_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
