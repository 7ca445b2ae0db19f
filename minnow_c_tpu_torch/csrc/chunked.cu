// K10 and K11: the decode of a chunked-width delta plane (Coil v1.1 and
// Octo v1.1 at 16384-element chunks).
//
// K10 (decode_chunk_kernel<false>): per-chunk-width unpack of the
// column-major chunk bodies -> optional un-zigzag -> optional global
// inclusive u32 prefix sum + `first` -> u32 bins.  K11
// (decode_chunk_kernel<true>): the same pass, with the store of a bin
// replaced by K1's tail: Threefry dither + x0 + dx_bin*(bin + u) + optional
// periodic rewrap -> f32 (dither.cuh, shared with decode.cu; the bin turns
// into a float as a u32).  They replace the one Pallas kernel
// minnow_c_tpu/ops/chunked_pallas.py:_delta_kernel behind
// chunked_delta_bins / decode_chunked_stream (floats=False) and
// decode_chunked_stream_floats (floats=True, _undo_floats_tail).
//
// Wire layout (doc/wire_format.md, algo_coil_v1_1.py): chunk ci of 16384
// elements packs at widths[ci] <= 32 bits into 512 * w words starting at
// word woff[ci] (a multiple of 512); its words are stored column-major as
// 4w rows of 128 columns: flat word f = c*128 + m holds natural bitstream
// word 4*w*m + c.  Column m holds elements 128m .. 128m+127, and the 32
// elements 128m + 32r .. +31 sit in rows r*w .. r*w + w - 1 of it.  Element
// e of the plane uses dither counter e >> 2, lane e & 3.
//
// Bound on the card: memory.  Per element K10 reads w/8 bytes of packed
// words and writes 4 bytes (0.0307 ms for 2^24 elements at 17 bits at
// 3.35 TB/s); K11 writes 4 bytes of f32 and adds 13 Threefry rounds per 4
// elements on the integer lanes, below the memory line.  What holds the
// kernel back on the card is latency: each tile's carry waits on its
// predecessors' sums, and a tile's reads, scan, look-back and stores
// follow one another.
//
// Design: one launch, one read of the body.  A tile is half a chunk, its
// columns 0-63 or 64-127 (8192 elements, 256 threads x 32), and one block
// takes one tile: the grid has a block a tile, and small blocks (at most 48
// registers a thread, 38 KB of shared memory) let 5 sit on an SM, so one
// block's waits hide behind the others' work.
// * The order: a block takes its tile by ticket from an atomic counter, so
//   a tile only ever waits on tiles whose blocks have started, whatever
//   order the card runs the blocks in.  With the prefix, each tile
//   publishes its aggregate and, once its carry is known, its inclusive
//   prefix; tile 0's carry is `first` (the decoupled look-back of scan.cuh,
//   the same code as K9's).  Without it, no status word is touched.
// * The reads: no copy and no transpose pass.  Thread t = 4q + r owns tile
//   column q, quarter r: elements 32t .. 32t+31, whose w words lie in
//   column q of rows r*w + j.  It loads them straight into registers; a
//   warp's load of one j reads 8 consecutive words of each of 4 rows (four
//   whole 32-byte sectors), so every byte fetched is used, and a body that
//   starts off a 16-byte boundary needs no other path.  The body is read
//   once, as streaming loads.
// * The extract is specialised on the width: one switch per tile to a
//   routine templated on w (0-32), every shift and mask a constant; width 0
//   reads no word and only carries the running sum.
// * The stores go out coalesced: each warp turns its 1024 results around
//   through its own 4.5 KB of shared memory (a pad quad every 8 quads:
//   conflict-free both ways), so each store instruction of a warp writes
//   512 contiguous bytes.  The ragged last tile stores only below n.
// * The table: the C entry point builds the chunk table in a pinned host
//   buffer and copies it to the card, one copy a call, with an event that
//   keeps a later call from rewriting the buffer before the copy has run
//   (the wrapper keeps four such buffers a stream, taken in turn).
// Tried on the card and dropped: a persistent grid taking tiles by ticket,
// each block copying its next tile's rows into shared memory (cp.async,
// two stages) while it decodes the current one.  Its blocks stall in each
// tile's look-back with the next tile's data waiting, and it ran slower.
// Nothing reads past the body: the wrapper checks that it holds every
// chunk's words.  The TPU kernel's answers to TPU limits are dropped: the
// single-grid-step DMA loop, the body padding for fixed-size DMA, and the
// lax.switch over the widths present.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "dither.cuh"
#include "scan.cuh"

namespace {

constexpr int kChunk = 16384;
constexpr int kRow = kChunk / 128;          // words of a wire row
constexpr int kCols = 64;                   // columns of a tile
constexpr int kThreads = 4 * kCols;         // 256
constexpr int kItems = 32;                  // elements a thread
constexpr int kTile = kThreads * kItems;    // 8192: half a chunk
constexpr int kTilesPerChunk = kChunk / kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpQuads = 256 + 32;        // a warp's results, padded
constexpr int kMinBlocks = 5;               // an SM's share: <= 48 registers

struct ChunkArgs {
  const uint32_t* body;    // the plane's packed words
  const int64_t* table;    // per chunk: (word offset << 8) | width
  int64_t n;               // elements to write
  int zigzag, prefix;
  uint32_t first;          // tile 0's carry
  unsigned* counter;       // the tickets; 0 on entry
  uint64_t* status;        // one word per tile (with prefix), 0 on entry
  uint32_t k0, k1;         // K11: dither key, x0, bin width, box
  float x0, dx_bin, box;
  int periodic;
  uint32_t* out;           // u32 bins or f32 bits, 16-byte aligned
};

// The 32 W-bit fields of one thread from its W words src[j * kRow].
template <int W>
__device__ __forceinline__ void extract(const uint32_t* src,
                                        uint32_t (&v)[kItems]) {
  if constexpr (W == 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = 0u;
  } else {
    constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << (W & 31)) - 1u;
    uint32_t word[W];
#pragma unroll
    for (int j = 0; j < W; ++j) word[j] = __ldcs(src + j * kRow);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int lo = i * W / 32, sh = i * W % 32;
      const uint32_t x =
          sh + W <= 32
              ? word[lo] >> sh
              : __funnelshift_r(word[lo], word[lo + 1 < W ? lo + 1 : lo], sh);
      v[i] = x & kMask;
    }
  }
}

template <int... Ws>
__device__ __forceinline__ void extract_width(
    int w, const uint32_t* src, uint32_t (&v)[kItems],
    std::integer_sequence<int, Ws...>) {
  (void)((w == Ws && (extract<Ws>(src, v), true)) || ...);
}

// One block a tile: take a ticket (the tile), unpack and scan it, park it
// in the warps' buffers, publish its aggregate and look back (warp 0),
// store.
template <bool kFloats>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_chunk_kernel(const ChunkArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ uint4 xpose_all[kWarps * kWarpQuads];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t adds[kThreads];  // each thread's exclusive block sum
  __shared__ uint32_t ticket_s, carry_s;
  __shared__ int64_t entry_s;
  uint4* xpose = xpose_all + warp * kWarpQuads;

  if (threadIdx.x == 0) {
    const uint32_t t0 = atomicAdd(a.counter, 1u);
    ticket_s = t0;
    entry_s = a.table[t0 / kTilesPerChunk];
  }
  __syncthreads();
  const uint32_t t = ticket_s;
  const int64_t entry = entry_s;
  const int w = static_cast<int>(entry & 0xFF);
  const int q = threadIdx.x >> 2, r = threadIdx.x & 3;
  uint32_t sum = 0;
  {
    uint32_t v[kItems];
    extract_width(w,
                  a.body + (entry >> 8) + (t % kTilesPerChunk) * kCols +
                      r * w * kRow + q,
                  v, std::make_integer_sequence<int, 33>());
    if (a.zigzag) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i] = (v[i] >> 1) ^ (0u - (v[i] & 1u));
    }
    if (a.prefix) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        sum += v[i];
        v[i] = sum;
      }
    }
    // quad k of lane l is the warp's quad Q = 8l + k, kept at Q + Q / 8
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      xpose[9 * lane + k] =
          make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }
  uint32_t carry = 0;
  if (a.prefix) {
    uint32_t total;
    adds[threadIdx.x] = mnw::block_exclusive_scan(sum, warp_sums, &total);
    if (warp == 0) {
      const uint32_t c = mnw::tile_carry(a.status, t, total, a.first);
      if (lane == 0) carry_s = c;
    }
    __syncthreads();
    carry = carry_s;
  } else {
    __syncwarp();
  }
  // each store instruction of the warp writes 512 contiguous bytes
  const int64_t base = static_cast<int64_t>(t) * kTile + 32 * kItems * warp;
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int qd = 32 * k + lane;
    uint4 x = xpose[qd + (qd >> 3)];
    if (a.prefix) {
      const uint32_t add = carry + adds[32 * warp + (qd >> 3)];
      x = make_uint4(x.x + add, x.y + add, x.z + add, x.w + add);
    }
    const int64_t e = base + 4 * qd;
    if constexpr (kFloats) {
      float u[4];
      mnw::dither_quad(a.k0, a.k1, static_cast<uint32_t>(e >> 2), u);
      x = make_uint4(
          __float_as_uint(mnw::undo_bin(x.x, u[0], a.x0, a.dx_bin, a.box,
                                        a.periodic)),
          __float_as_uint(mnw::undo_bin(x.y, u[1], a.x0, a.dx_bin, a.box,
                                        a.periodic)),
          __float_as_uint(mnw::undo_bin(x.z, u[2], a.x0, a.dx_bin, a.box,
                                        a.periodic)),
          __float_as_uint(mnw::undo_bin(x.w, u[3], a.x0, a.dx_bin, a.box,
                                        a.periodic)));
    }
    if (e + 4 <= a.n) {
      *reinterpret_cast<uint4*>(a.out + e) = x;
    } else {
      if (e < a.n) a.out[e] = x.x;
      if (e + 1 < a.n) a.out[e + 1] = x.y;
      if (e + 2 < a.n) a.out[e + 2] = x.z;
    }
  }
}

template <bool kFloats>
int blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_chunk_kernel<kFloats>, kThreads, 0);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

}  // namespace

// Blocks of K10 (floats = 0) or K11 that fit one SM (a CUDA error as its
// negative).
extern "C" int mnw_chunked_blocks_per_sm(int floats) {
  return floats ? blocks_per_sm<true>() : blocks_per_sm<false>();
}

// An event that orders the host's reuse of a staging buffer after the copy
// that reads it (never destroyed: one per device and stream), or null.
extern "C" void* mnw_chunked_event() {
  cudaEvent_t e = nullptr;
  if (cudaEventCreateWithFlags(&e, cudaEventDisableTiming) != cudaSuccess) {
    return nullptr;
  }
  return e;
}

// widths: the n_chunks host widths (u8) of the chunks that hold the n output
// elements.  The chunk table -- (word offset << 8) | width per chunk, int64
// -- is built in the pinned host buffer `staging` once the last copy from
// it has run (`event`), copied to `table` on the card (the call's one
// host-to-device copy), and the event recorded after the copy.
// scratch: 8 bytes of ticket counter then one 64-bit status word per tile of
// 8192 elements, cleared here on the stream before the launch (only the
// counter without prefix).  floats selects K11 (out f32) over K10 (out
// u32).  The body needs no alignment beyond its words'.
extern "C" int mnw_chunked_decode(
    const void* body, const void* widths, int64_t n_chunks, void* staging,
    void* table, void* event, int64_t n, int zigzag, int prefix,
    uint32_t first, void* scratch, int floats, uint32_t k0, uint32_t k1,
    float x0, float dx_bin, float box, int periodic, void* out,
    void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (n < 1 || n > n_chunks * kChunk || tiles >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto e = static_cast<cudaEvent_t>(event);
  cudaError_t err = cudaEventSynchronize(e);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w = static_cast<const uint8_t*>(widths);
  auto* host = static_cast<int64_t*>(staging);
  int64_t off = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    host[c] = (off << 8) | w[c];
    off += static_cast<int64_t>(kChunk / 32) * w[c];
  }
  err = cudaMemcpyAsync(table, staging, sizeof(int64_t) * n_chunks,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventRecord(e, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* words = static_cast<uint64_t*>(scratch);
  err = cudaMemsetAsync(words, 0,
                        sizeof(uint64_t) * (1 + (prefix ? tiles : 0)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChunkArgs a{static_cast<const uint32_t*>(body),
                    static_cast<const int64_t*>(table),
                    n,
                    zigzag,
                    prefix,
                    first,
                    reinterpret_cast<unsigned*>(words),
                    words + 1,
                    k0,
                    k1,
                    x0,
                    dx_bin,
                    box,
                    periodic,
                    static_cast<uint32_t*>(out)};
  const auto grid = static_cast<unsigned>(tiles);
  if (floats) {
    decode_chunk_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    decode_chunk_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
