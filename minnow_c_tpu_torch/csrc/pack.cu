// The pack kernels, one tile kernel (pack.cuh) under three element
// policies:
//
// K7: uniform-width bitpack of R rows of n u32 bins each (32 | n), every row
// its own stream.  K4: the same pack of one plane of any length, from u32
// bins or from a pre-scaled f32 plane (delta * 2^width) that it first
// truncates and clamps.  K8: the recip scale mode's whole encode of R rows of
// n raw f32 values (32 | n), each row with its own x0, recip = rn(1 /
// range), box and anchor (its raw element 0): the anchored unwrap,
// ((x - x0) * recip) * 2^width in three named roundings, the clamp, and the
// pack.  K5: K8's encode of one plane of any length with the plane's
// scalars.
//
// K7 replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:
// pack_pallas_rows (_pack_rows_kernel), which the snapshot writer packs
// every field with; K4 replaces encode_pallas.py:pack_pallas (_pack_body,
// _scaled_to_bins); K8 replaces encode_pallas.py:encode_pallas_recip_rows
// (_encode_recip_rows_kernel), the snapshot writer's recip mode; K5 replaces
// encode_pallas.py:encode_pallas_recip (_encode_recip_kernel, _recip_body).
// Layout is util.c's: bit b of element i lands at global bit i*width + b;
// spare bits of the last word are zero.  Output bits equal
// encode_cuda.pack_plain / pack_rows_plain / encode_recip_plain /
// encode_recip_rows_plain and the JAX package's kernels.
//
// With 32 | n every row packs into exactly (n / 32) * width words and
// starts on a word boundary, so a rows pack is the pack of the flattened
// R * n elements: K7 is K4's kernel, and K8 is K5's.
//
// Bound on the card: memory.  Per element it reads 4 bytes and writes
// width/8 bytes (0.72 ms for 192 rows of 2^21 at 16 bits at 3.35 TB/s); the
// recip map adds some 8 float operations an element, far below the f32
// rate.
//
// Design: pack.cuh's tile routine, a persistent grid walking 4096-element
// tiles with the next tile's 16-byte loads in registers, the bins in
// skewed shared memory and 16-byte word stores; the row of an element of
// K8 comes from a per-tile 64-bit division and a 32-bit magic division
// (rows.cuh), its scalars from the read-only cache.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "pack.cuh"

namespace {

using mnw::kPackThreads;
using mnw::PackArgs;

template <int W, bool kFromF32>
__global__ void __launch_bounds__(kPackThreads, 4)
pack_tiles_kernel(const PackArgs a) {
  extern __shared__ uint32_t s[];
  if constexpr (kFromF32) {
    mnw::pack_tiles<W>(a, mnw::ScaledBins<W>{}, s);
  } else {
    mnw::pack_tiles<W>(a, mnw::MaskBins<W>{}, s);
  }
}

template <int W>
__global__ void __launch_bounds__(kPackThreads, 4)
pack_recip_tiles_kernel(const PackArgs a, const mnw::RecipRows rows) {
  extern __shared__ uint32_t s[];
  mnw::pack_tiles<W>(a, mnw::RecipBins<W, false>{rows, a.n}, s);
}

using PackLaunch = void (*)(const PackArgs&, unsigned, int, cudaStream_t);
using RecipLaunch = void (*)(const PackArgs&, const mnw::RecipRows&,
                             unsigned, int, cudaStream_t);

template <int W, bool kFromF32>
void launch_pack(const PackArgs& a, unsigned grid, int smem,
                 cudaStream_t st) {
  pack_tiles_kernel<W, kFromF32><<<grid, kPackThreads, smem, st>>>(a);
}

template <int W>
void launch_recip(const PackArgs& a, const mnw::RecipRows& rows,
                  unsigned grid, int smem, cudaStream_t st) {
  pack_recip_tiles_kernel<W><<<grid, kPackThreads, smem, st>>>(a, rows);
}

template <int... Ws>
PackLaunch pack_table(int width, bool from_f32,
                      std::integer_sequence<int, Ws...>) {
  PackLaunch u32[] = {&launch_pack<Ws + 1, false>...};
  PackLaunch f32[] = {&launch_pack<(Ws < 24 ? Ws + 1 : 24), true>...};
  return from_f32 ? f32[width - 1] : u32[width - 1];
}

template <int... Ws>
RecipLaunch recip_table(int width, std::integer_sequence<int, Ws...>) {
  RecipLaunch fns[] = {&launch_recip<Ws + 1>...};
  return fns[width - 1];
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

// K5 and K8: width 1-24.  K8: rows of row_n elements (32 | row_n) with the
// magic of row_n and (R,) f32 arrays x0, recip, box, anchor.  K5: null
// arrays, row_n and magic 0, and the plane's scalars.  The plan's fields as
// for mnw_pack_tiles.
extern "C" int mnw_pack_recip_tiles(const void* x, int64_t n, int width,
                                    int64_t tiles, int tile, int vec16,
                                    unsigned grid, int smem_bytes,
                                    uint32_t row_n, uint32_t n_magic,
                                    const void* x0, const void* recip,
                                    const void* box, const void* anchor,
                                    float x0s, float recips, float boxs,
                                    float anchors, int periodic, void* out,
                                    int64_t n_words, void* stream) {
  if (width < 1 || width > 24) return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{static_cast<const uint32_t*>(x), n, n_words, tiles, tile,
             vec16, static_cast<uint32_t*>(out)};
  const mnw::RecipRows rows{
      static_cast<const float*>(x0), static_cast<const float*>(recip),
      static_cast<const float*>(box), static_cast<const float*>(anchor),
      {x0s, recips, boxs, anchors}, row_n, n_magic, periodic};
  recip_table(width, std::make_integer_sequence<int, 24>())(
      a, rows, grid, smem_bytes, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
