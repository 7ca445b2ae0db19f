// K12 (encode_recip_fused_kernel): the recip scale mode's one-pass encode of
// B blocks of D rows of n elements, 32 | n; per row the min and max of the
// unwrapped values (K6's code, minmax.cuh), per block the shared range
// max_d(mx - mn) and recip = rn(1 / range) (__frcp_rn: a range of 0 gives
// +inf, as 1.0f / 0 does), then K8's map and pack with x0 = the row's min.
// Returns the words and the rows' min and max.  Replaces
// minnow_c_tpu/ops/encode_pallas.py:encode_recip_fused_blocks
// (_encode_recip_fused_kernel); the JAX package measured it and kept the
// split path (stats, host recip, K8) in production, and so does the port.
// K5 and K8, the recip encodes of one plane and of rows, are pack.cu's.
//
// The map is bins.cuh's RecipMap: ((x - x0) * recip) * 2^w in three named
// roundings (the library builds with -fmad=false, so nothing contracts),
// subnormals flushed, NaN (a constant plane: 0 * inf) to bin 0.  Output bits
// equal encode_cuda.encode_recip_fused_blocks_plain and the JAX package's
// kernel.
//
// Bound on the card: memory.  It reads the input twice (stats, then encode)
// and writes width/8 bytes an element.
//
// Design: one cooperative launch of co-resident blocks that loop over their
// work in three steps separated by grid-wide barriers (a counter in device
// memory that the wrapper zeroes): partial min / max per (row, slice of
// slice_len), one CTA each, by K6's slice routine (minmax.cuh slice_keys:
// 16-byte streaming loads, integer keys, one block reduction a slice);
// per block, one CTA reduces its rows' partials to
// their min / max, the range and the recip, written per row; then K8's tile
// routine (pack.cuh) over the flat stream of rows, with the rows' scalars
// read through L2 (__ldcg), since this launch wrote them.  The width is a
// template parameter (1-24) and the tile is in dynamic shared memory, which
// the occupancy query counts.  K12 reads the input twice by necessity: a
// block's range needs all its rows reduced before its first word, and
// D * n floats (24 MiB for 3 rows of 2^21) do not stay on chip.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "minmax.cuh"
#include "pack.cuh"

namespace {

constexpr int kThreads = mnw::kPackThreads;

// Every block of the grid arrives, then all leave; the n-th barrier of a
// launch waits for the counter to reach n * gridDim.x.  Needs co-resident
// blocks (a cooperative launch).
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(count, 1u);
    while (atomicAdd(count, 0u) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

struct FusedArgs {
  const float* x;
  int64_t blocks, dims, n;
  int slice_len;  // a multiple of 4
  float box;
  const float* anchors;
  int periodic;
  float* pmin;        // (rows * slices,) partials
  float* pmax;
  float* recip;       // (rows,) each row's block recip
  unsigned int* barrier;
  float* out_mn;
  float* out_mx;
  mnw::PackArgs pack;  // the flat stream of rows, its tiles and words
  uint32_t n_magic;    // rows.cuh's magic for n
};

template <int W>
__global__ void __launch_bounds__(kThreads) encode_recip_fused_kernel(
    const FusedArgs a) {
  extern __shared__ uint32_t s[];
  const int64_t rows = a.blocks * a.dims;
  const int64_t slices = (a.n + a.slice_len - 1) / a.slice_len;
  const float half = mnw::half_box(a.box);

  // 1. Partial min / max of every (row, slice): K6's slice routine.
  for (int64_t it = blockIdx.x; it < rows * slices; it += gridDim.x) {
    const int64_t r = it / slices;
    const int64_t sl = it - r * slices;
    const float* row = a.x + r * a.n;
    const mnw::KeyRange k =
        a.periodic ? mnw::slice_keys<kThreads, true>(row, a.n, sl,
                                                     a.slice_len, a.box,
                                                     half, a.anchors[r])
                   : mnw::slice_keys<kThreads, false>(row, a.n, sl,
                                                      a.slice_len, 0.0f,
                                                      0.0f, 0.0f);
    if (threadIdx.x == 0) {
      mnw::key_range_to_floats(k, a.pmin[it], a.pmax[it]);
    }
  }
  grid_barrier(a.barrier, gridDim.x);

  // 2. Per block, one CTA: its rows' min / max over their slices, the
  // shared range max_d(mx - mn) and the recip.
  for (int64_t b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    float range = 0.0f;
    for (int64_t d = 0; d < a.dims; ++d) {
      const int64_t r = b * a.dims + d;
      float mn = __uint_as_float(0x7F800000u);   // +inf
      float mx = __uint_as_float(0xFF800000u);   // -inf
      for (int64_t sl = threadIdx.x; sl < slices; sl += kThreads) {
        mn = mnw::min_op(mn, __ldcg(a.pmin + r * slices + sl));
        mx = mnw::max_op(mx, __ldcg(a.pmax + r * slices + sl));
      }
      mnw::block_minmax<kThreads>(mn, mx);
      if (threadIdx.x == 0) {
        a.out_mn[r] = mn;
        a.out_mx[r] = mx;
        const float rd = __fsub_rn(mx, mn);
        range = d == 0 ? rd : mnw::max_op(range, rd);
      }
    }
    if (threadIdx.x == 0) {
      const float rcp = __frcp_rn(range);
      for (int64_t d = 0; d < a.dims; ++d) a.recip[b * a.dims + d] = rcp;
    }
  }
  grid_barrier(a.barrier, 2 * gridDim.x);

  // 3. The words: K8's tile routine with the rows' min and their block's
  // recip.
  const mnw::RecipRows rr{a.out_mn, a.recip, nullptr,
                          a.periodic ? a.anchors : nullptr,
                          {0.0f, 0.0f, a.box, 0.0f},
                          static_cast<uint32_t>(a.n), a.n_magic, a.periodic};
  mnw::pack_tiles<W>(a.pack, mnw::RecipBins<W, true>{rr, a.pack.n}, s);
}

using FusedKernel = void (*)(const FusedArgs);

template <int... Ws>
FusedKernel fused_table(int width, std::integer_sequence<int, Ws...>) {
  FusedKernel fns[] = {&encode_recip_fused_kernel<Ws + 1>...};
  return fns[width - 1];
}

}  // namespace

// scratch: 2 * blocks * dims * ceil(n / slice_len) + blocks * dims floats;
// barrier: one u32, zero on entry.  tile, vec16 and smem_bytes come from the
// wrapper's pack plan of the blocks * dims * n floats, n_magic from
// cuda_lib.row_magic(n); width 1-24.
extern "C" int mnw_encode_recip_fused(const void* x, int64_t blocks,
                                      int64_t dims, int64_t n, int slice_len,
                                      float box, const void* anchors,
                                      int width, int periodic, int tile,
                                      int vec16, int smem_bytes,
                                      uint32_t n_magic, void* scratch,
                                      void* barrier, void* out, void* out_mn,
                                      void* out_mx, void* stream) {
  if (width < 1 || width > 24 || slice_len < 4 || slice_len % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FusedKernel kernel =
      fused_table(width, std::make_integer_sequence<int, 24>());
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = blocks * dims;
  const int64_t items = rows * ((n + slice_len - 1) / slice_len);
  const int64_t total = rows * n;
  const int64_t tiles = (total + tile - 1) / tile;
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  const int64_t want = items > tiles ? items : tiles;
  if (grid > want) grid = want;
  if (grid < 1) grid = 1;

  auto* pmin = static_cast<float*>(scratch);
  FusedArgs a{static_cast<const float*>(x), blocks, dims, n, slice_len, box,
              static_cast<const float*>(anchors), periodic, pmin,
              pmin + items, pmin + 2 * items,
              static_cast<unsigned int*>(barrier),
              static_cast<float*>(out_mn), static_cast<float*>(out_mx),
              {static_cast<const uint32_t*>(x), total, total / 32 * width,
               tiles, tile, vec16, static_cast<uint32_t*>(out)},
              n_magic};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), args, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
