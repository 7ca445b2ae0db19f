// The decode kernels of the Trim planes.
//
// K2 (decode_tiles_kernel<W, true>): fused decode of R independent streams
// -- unpack, Threefry-2x32-13 dither, undo of the bin index, optional
// periodic rewrap -- each row with its own key, x0 and bin width, the
// dither counter restarting at 0 in every row.  Replaces
// minnow_c_tpu/ops/decode_pallas.py:decode_pallas_rows
// (_decode_rows_kernel).  The snapshot reader decodes all blocks of a field
// dimension with it.
//
// K1 is the same kernel at one row: decode of one plane of any length whose
// first element has dither counter ctr0 (the plane's first element / 4).
// Replaces decode_pallas.py:decode_pallas (_decode_body, _unpack_128,
// _threefry13_tile).
//
// K3 (decode_tiles_kernel<W, false>): bare unpack of R streams to u32
// bins.  Replaces decode_pallas.py:unpack_pallas_rows (_unpack_rows_kernel);
// the snapshot reader's ID planes, the Diff v1.0 decode and the chunked
// device path.
//
// Output bits equal the plain torch versions in ops/decode_cuda.py and the
// JAX package's decode (the dither is part of the wire, so the cipher is
// Threefry bit for bit, dither.cuh).
//
// Bound on the card: memory, with the arithmetic close behind.  Per element
// K1 and K2 read width/8 bytes of packed words and write 4 bytes of f32
// (0.24 ms for 64 rows of 2^21 at 16 bits at 3.35 TB/s).  Threefry-2x32-13
// costs about 50 integer operations per counter, shared by four elements,
// and each element adds its extract, the two float builds, the add, the FMA
// and the rewrap: some 25 integer and float operations an element, about as
// long again on the card's integer lanes.  K3 reads width/8 bytes and writes
// 4, with only the extract between (0.21 ms for 64 rows of 2^21 at 9
// bits): its stores are most of its bytes.
//
// Design of K1 / K2 / K3.  With 32 | n every row is (n / 32) * width words
// and starts on a word, so the R rows are one contiguous stream of words and
// one contiguous stream of outputs: the kernel tiles that stream, not the
// rows.  A tile is `tile` elements (a multiple of 128, from the wrapper's
// plan, ops/decode_cuda.decode_plan), i.e. tile / 32 * width words, which
// start on a 16-byte boundary when the stream does.  A persistent grid of a
// few blocks per SM walks the tiles; each block copies the next tile's words
// into shared memory with cp.async (16-byte copies, or 4-byte ones when the
// stream's pointer is not 16-byte aligned and for a ragged tail) while it
// decodes the current one from the other buffer.  A thread decodes one
// quad (four neighbouring elements; for K1 / K2 the four of one Threefry
// counter) at a time, neighbouring threads neighbouring quads, and writes
// it as one 16-byte store, so a warp's store covers 512 contiguous bytes.
// The element step is the kernel's second template parameter: floats
// (K1 / K2: dither, undo, rewrap) or bins (K3: the u32 field as it is).  The
// width is the first (1-24 for floats, 1-32 for bins), so every shift and
// mask is a constant.  A tile's start is 64-bit, so the stream has no cap
// in length; index math inside a tile is 32-bit.  For floats, a tile's
// first row and its offset in that row are found once per tile (one
// thread, one 64-bit division), and a quad past the end of that row finds
// its row by a 32-bit division by the row length through a precomputed
// magic number with one correction step (rows.cuh); bins need no row.
// Every float step names its rounding (__fadd_rn, __fmaf_rn, __fsub_rn) and
// the library builds with -fmad=false -ftz=true; the grain's and the bin's
// floats are built exactly from bits (dither.cuh).

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "dither.cuh"
#include "rows.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct DecodeArgs {
  const uint32_t* words;  // the flat stream of packed words
  int64_t n_words;        // its length
  int64_t total;          // elements in all rows
  uint32_t n;             // elements per row (= total for one row)
  uint32_t n_magic;       // floor(2^32 / n), 0 for one row
  int64_t tiles;          // ceil(total / tile)
  int tile;               // elements per tile, a multiple of 128
  int vec16;              // the stream starts on a 16-byte boundary
  const int64_t* keys;    // per-row keys (low 32 bits), or null: one stream
  int64_t key_row;        // keys' strides in elements: row r's pair is
  int64_t key_col;        // keys[r * key_row], keys[r * key_row + key_col]
  const float* x0;        // (R,) per-row x0 (with keys)
  const float* dx;        // (R,) per-row full ranges (with keys)
  uint32_t k0, k1;        // one stream's key, x0 and full range
  float x0s, dxs;
  uint32_t ctr0;          // dither counter of element 0 of every row
  float box;
  int periodic;
  void* out;              // f32 values (K1 / K2) or u32 bins (K3)
};

// Copies the words of tile t into buf (cp.async; the caller commits).
template <int W>
__device__ __forceinline__ void load_tile(const DecodeArgs& a, int64_t t,
                                          uint32_t* buf) {
  const int wpt = a.tile / 32 * W;
  const int64_t w0 = t * wpt;
  const int64_t left = a.n_words - w0;
  const int count = left < wpt ? static_cast<int>(left) : wpt;
  const uint32_t* src = a.words + w0;
  int done = 0;
  if (a.vec16) {
    done = count & ~3;
    for (int k = threadIdx.x * 4; k < done; k += kThreads * 4) {
      cp_async16(buf + k, src + k);
    }
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) {
    cp_async4(buf + k, src + k);
  }
}

// Writes a quad's four words at o (16-byte aligned) as one 16-byte store,
// or the first `left` of them one by one at the end of a ragged stream.
__device__ __forceinline__ void store_quad(uint32_t* o, const uint32_t (&v)[4],
                                           uint32_t left) {
  if (left >= 4) {
    __stwb(reinterpret_cast<uint4*>(o), make_uint4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (uint32_t l = 0; l < 4; ++l) {
      if (l < left) o[l] = v[l];
    }
  }
}

// A row's dither key, x0 and bin width f32(dx) / 2^W.  The product by 2^-W
// is exact, and a subnormal operand or result flushes to zero
// (-ftz=true), as kernels.bin_width flushes them.
struct RowParams {
  uint32_t k0, k1;
  float x0, dx_bin;
};

template <int W>
__device__ __forceinline__ RowParams row_params(const DecodeArgs& a,
                                                int64_t row) {
  const float scale = __int_as_float((127 - W) << 23);  // 2^-W
  if (!a.keys) return {a.k0, a.k1, a.x0s, __fmul_rn(a.dxs, scale)};
  const int64_t* key = a.keys + row * a.key_row;
  return {static_cast<uint32_t>(key[0]),
          static_cast<uint32_t>(key[a.key_col]), a.x0[row],
          __fmul_rn(a.dx[row], scale)};
}

// The W-bit field of element i of the tile in buf (32-bit bit index; the
// buffer holds a spare word past the tile for the funnel's high word).
template <int W>
__device__ __forceinline__ uint32_t field(const uint32_t* buf, uint32_t i) {
  constexpr uint32_t kMask = W == 32 ? 0xFFFFFFFFu : (1u << (W & 31)) - 1u;
  const uint32_t bit = i * W;
  const uint32_t j = bit >> 5;
  const uint32_t v = __funnelshift_r(buf[j], buf[j + 1], bit & 31);
  return v & kMask;
}

// kFloats: K1 / K2, the decoded f32 values; else K3, the u32 bins.
template <int W, bool kFloats>
__global__ void __launch_bounds__(kThreads, 4)
decode_tiles_kernel(const DecodeArgs a) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int stage = a.tile / 32 * W + 4;  // words a buffer, 16-byte multiple
  __shared__ int64_t row0_s;
  __shared__ uint32_t off0_s;

  int64_t t = blockIdx.x;
  if (t < a.tiles) load_tile<W>(a, t, smem);
  cp_async_commit();
  for (int it = 0; t < a.tiles; ++it, t += gridDim.x) {
    const int64_t next = t + gridDim.x;
    if (next < a.tiles) {
      load_tile<W>(a, next, smem + ((it + 1) & 1) * stage);
    }
    cp_async_commit();
    const int64_t e0 = t * a.tile;
    if (kFloats && threadIdx.x == 0) {
      const int64_t r0 = a.n_magic ? e0 / a.n : 0;
      row0_s = r0;
      off0_s = static_cast<uint32_t>(e0 - r0 * a.n);
    }
    cp_async_wait_prior();
    __syncthreads();
    const uint32_t* buf = smem + (it & 1) * stage;
    const int64_t left = a.total - e0;
    const uint32_t count = left < a.tile ? static_cast<uint32_t>(left)
                                         : static_cast<uint32_t>(a.tile);
    uint32_t* o = static_cast<uint32_t*>(a.out) + e0;
    if constexpr (kFloats) {
      const int64_t row0 = row0_s;
      const uint32_t off0 = off0_s;
      // the tile's first row, and whether the whole tile lies in it (rows
      // of at least a tile: the parameters load once a tile)
      const RowParams first = row_params<W>(a, row0);
      const bool one_row = !a.n_magic || off0 + count <= a.n;
      for (uint32_t i = threadIdx.x * 4; i < count; i += kThreads * 4) {
        uint32_t off = off0 + i;
        RowParams p = first;
        if (!one_row) {
          // the quad's row and its offset in it (rows.cuh)
          p = row_params<W>(a, row0 + mnw::split_row(off, a.n, a.n_magic));
        }
        float u[4];
        mnw::dither_quad(p.k0, p.k1, a.ctr0 + (off >> 2), u);
        uint32_t v[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          v[l] = __float_as_uint(
              mnw::undo_binf(mnw::bin_to_float<W>(field<W>(buf, i + l)),
                             u[l], p.x0, p.dx_bin, a.box, a.periodic));
        }
        store_quad(o + i, v, count - i);
      }
    } else {
      for (uint32_t i = threadIdx.x * 4; i < count; i += kThreads * 4) {
        uint32_t v[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) v[l] = field<W>(buf, i + l);
        store_quad(o + i, v, count - i);
      }
    }
    __syncthreads();
  }
}

using DecodeLaunch = void (*)(const DecodeArgs&, unsigned, int, cudaStream_t);

template <int W, bool kFloats>
void launch_decode(const DecodeArgs& a, unsigned grid, int smem,
                   cudaStream_t s) {
  decode_tiles_kernel<W, kFloats><<<grid, kThreads, smem, s>>>(a);
}

template <bool kFloats, int... Ws>
DecodeLaunch decode_table(int width, std::integer_sequence<int, Ws...>) {
  DecodeLaunch fns[] = {&launch_decode<Ws + 1, kFloats>...};
  return fns[width - 1];
}

}  // namespace

// K1 and K2: width 1-24; for K2 int64 keys (strides key_row, key_col in
// elements), x0 and full ranges dx per row; for K1 null keys, x0 and dx,
// and the one stream's k0, k1, x0s and full range dxs.  grid, tile and
// smem_bytes come from the wrapper's plan.
extern "C" int mnw_decode_tiles(const void* words, int64_t n_words,
                                int64_t total, int64_t n, uint32_t n_magic,
                                int64_t tiles, int tile, int vec16,
                                const void* keys, int64_t key_row,
                                int64_t key_col, const void* x0,
                                const void* dx, uint32_t k0, uint32_t k1,
                                float x0s, float dxs, uint32_t ctr0,
                                float box, int periodic, int width,
                                unsigned grid, int smem_bytes, void* out,
                                void* stream) {
  if (width < 1 || width > 24) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{static_cast<const uint32_t*>(words), n_words, total,
               static_cast<uint32_t>(n), n_magic, tiles, tile, vec16,
               static_cast<const int64_t*>(keys), key_row, key_col,
               static_cast<const float*>(x0), static_cast<const float*>(dx),
               k0, k1, x0s, dxs, ctr0, box, periodic, out};
  decode_table<true>(width, std::make_integer_sequence<int, 24>())(
      a, grid, smem_bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K3: the total elements of the flat stream of rows at width 1-32, each to
// its u32 bin; tiles, tile, vec16, grid and smem_bytes come from the
// wrapper's plan (ops/decode_cuda.decode_plan).
extern "C" int mnw_unpack_rows(const void* words, int64_t n_words,
                               int64_t total, int64_t tiles, int tile,
                               int vec16, int width, unsigned grid,
                               int smem_bytes, void* out, void* stream) {
  if (width < 1 || width > 32) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{static_cast<const uint32_t*>(words), n_words, total, 0u, 0u,
               tiles, tile, vec16, nullptr, 0, 0, nullptr, nullptr, 0u, 0u,
               0.0f, 0.0f, 0u, 0.0f, 0, out};
  decode_table<false>(width, std::make_integer_sequence<int, 32>())(
      a, grid, smem_bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mnw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
