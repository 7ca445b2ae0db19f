// The recip scale mode's encodes: the whole bin map and the pack in one pass
// over the raw floats.
//
// K5 (encode_recip_kernel): one plane of any length n, with the plane's x0,
// recip = rn(1 / range), box and anchor (its raw element 0) as scalars.
// Replaces minnow_c_tpu/ops/encode_pallas.py:encode_pallas_recip
// (_encode_recip_kernel, _recip_body).
//
// K8 (encode_recip_rows_kernel): K5 over R rows of n elements, 32 | n, each
// row its own stream with its own x0, recip, box and anchor, read from
// device arrays.  Replaces encode_pallas.py:encode_pallas_recip_rows
// (_encode_recip_rows_kernel); the snapshot writer's recip mode packs every
// float field of every block with it.
//
// K12 (encode_recip_fused_kernel): B blocks of D rows of n elements, 32 | n;
// per row the min and max of the unwrapped values (K6's code, minmax.cuh),
// per block the shared range max_d(mx - mn) and recip = rn(1 / range)
// (__frcp_rn: a range of 0 gives +inf, as 1.0f / 0 does), then K8's map and
// pack with x0 = the row's min.  Returns the words and the rows' min and max.
// Replaces encode_pallas.py:encode_recip_fused_blocks
// (_encode_recip_fused_kernel); the JAX package measured it and kept the
// split path (stats, host recip, K8) in production, and so does the port.
//
// The map is bins.cuh's RecipMap: ((x - x0) * recip) * 2^w in three named
// roundings (the library builds with -fmad=false, so nothing contracts),
// subnormals flushed, NaN (a constant plane: 0 * inf) to bin 0.  Output bits
// equal encode_cuda.encode_recip_plain / encode_recip_rows_plain /
// encode_recip_fused_blocks_plain and the JAX package's kernels.
//
// Bound on the card: memory.  K5 and K8 read 4 bytes and write width/8 bytes
// per element; K12 reads the input twice (stats, then encode).
//
// Design: K5 and K8 are K4's design, one thread per output word
// (bins.cuh: pack_word); K8 flattens (row, word) onto a 1-D grid.  K12 is one
// cooperative launch of co-resident blocks that loop over their work in three
// steps separated by grid-wide barriers (a counter in device memory that the
// wrapper zeroes): partial min / max per (row, slice of slice_len), one CTA
// each; per block, one CTA reduces its rows' partials to their min / max,
// the range and the recip; the words, one thread each.  Values
// another block wrote are read through L2 (__ldcg).
// K12 reads the input twice by necessity: a block's range needs all its rows
// reduced before its first word, and D * n floats (24 MiB for 3 rows of
// 2^21) do not stay on chip.  Left for later work: for small widths each
// element is read by two threads, and K8 computes 64-bit row and word
// indices per thread.

#include <cstdint>
#include <cuda_runtime.h>

#include "bins.cuh"
#include "minmax.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void encode_recip_kernel(const float* __restrict__ x, int64_t n,
                                    float x0, float recip, float box,
                                    float anchor, int width, int periodic,
                                    uint32_t* __restrict__ out,
                                    int64_t n_words) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= n_words) return;
  const mnw::RecipMap map(x0, recip, box, anchor, width, periodic);
  out[q] = mnw::pack_word(q, n, width, [&](int64_t i) { return map(x[i]); });
}

__global__ void encode_recip_rows_kernel(
    const float* __restrict__ x, int64_t rows, int64_t n, int width,
    const float* __restrict__ x0, const float* __restrict__ recip,
    const float* __restrict__ box, const float* __restrict__ anchor,
    int periodic, uint32_t* __restrict__ out) {
  const int64_t wpr = n / 32 * width;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= rows * wpr) return;
  const int64_t r = q / wpr;
  const float* row = x + r * n;
  const mnw::RecipMap map(x0[r], recip[r], box[r], anchor[r], width,
                          periodic);
  out[q] = mnw::pack_word(q - r * wpr, n, width,
                          [&](int64_t i) { return map(row[i]); });
}

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

__global__ void __launch_bounds__(kThreads) encode_recip_fused_kernel(
    const float* __restrict__ x, int64_t blocks, int64_t dims, int64_t n,
    int64_t slice_len, float box, const float* __restrict__ anchors,
    int width, int periodic, float* pmin, float* pmax, float* recip,
    unsigned int* barrier, uint32_t* __restrict__ out, float* out_mn,
    float* out_mx) {
  const int64_t rows = blocks * dims;
  const int64_t slices = (n + slice_len - 1) / slice_len;
  const float half = mnw::half_box(box);

  // 1. Partial min / max of every (row, slice).
  for (int64_t it = blockIdx.x; it < rows * slices; it += gridDim.x) {
    const int64_t r = it / slices;
    const int64_t lo = (it - r * slices) * slice_len;
    const int64_t hi = lo + slice_len < n ? lo + slice_len : n;
    const float a = periodic ? anchors[r] : 0.0f;
    float mn, mx;
    mnw::slice_minmax<kThreads>(x + r * n, lo, hi, periodic, box, half, a,
                                mn, mx);
    if (threadIdx.x == 0) {
      pmin[it] = mn;
      pmax[it] = mx;
    }
  }
  grid_barrier(barrier, gridDim.x);

  // 2. Per block, one CTA: its rows' min / max over their slices, the
  // shared range max_d(mx - mn) and the recip.
  for (int64_t b = blockIdx.x; b < blocks; b += gridDim.x) {
    float range = 0.0f;
    for (int64_t d = 0; d < dims; ++d) {
      const int64_t r = b * dims + d;
      float mn = __uint_as_float(0x7F800000u);   // +inf
      float mx = __uint_as_float(0xFF800000u);   // -inf
      for (int64_t s = threadIdx.x; s < slices; s += kThreads) {
        mn = mnw::min_op(mn, __ldcg(pmin + r * slices + s));
        mx = mnw::max_op(mx, __ldcg(pmax + r * slices + s));
      }
      mnw::block_minmax<kThreads>(mn, mx);
      if (threadIdx.x == 0) {
        out_mn[r] = mn;
        out_mx[r] = mx;
        const float rd = __fsub_rn(mx, mn);
        range = d == 0 ? rd : mnw::max_op(range, rd);
      }
    }
    if (threadIdx.x == 0) recip[b] = __frcp_rn(range);
  }
  grid_barrier(barrier, 2 * gridDim.x);

  // 3. The words: K8's map and pack with the row's min and the block's
  // recip.
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t wpr = n / 32 * width;
  for (int64_t q = tid; q < rows * wpr; q += stride) {
    const int64_t r = q / wpr;
    const float* row = x + r * n;
    const mnw::RecipMap map(__ldcg(out_mn + r), __ldcg(recip + r / dims), box,
                            periodic ? anchors[r] : 0.0f, width, periodic);
    out[q] = mnw::pack_word(q - r * wpr, n, width,
                            [&](int64_t i) { return map(row[i]); });
  }
}

}  // namespace

extern "C" int mnw_encode_recip(const void* x, int64_t n, float x0,
                                float recip, float box, float anchor,
                                int width, int periodic, void* out,
                                int64_t n_words, void* stream) {
  const int64_t grid = (n_words + kThreads - 1) / kThreads;
  encode_recip_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, x0, recip, box, anchor, width,
      periodic, static_cast<uint32_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mnw_encode_recip_rows(const void* x, int64_t rows, int64_t n,
                                     int width, const void* x0,
                                     const void* recip, const void* box,
                                     const void* anchor, int periodic,
                                     void* out, void* stream) {
  const int64_t grid = (rows * (n / 32) * width + kThreads - 1) / kThreads;
  encode_recip_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, n, width,
      static_cast<const float*>(x0), static_cast<const float*>(recip),
      static_cast<const float*>(box), static_cast<const float*>(anchor),
      periodic, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// scratch: 2 * blocks * dims * ceil(n / slice_len) + blocks floats;
// barrier: one u32, zero on entry.
extern "C" int mnw_encode_recip_fused(const void* x, int64_t blocks,
                                      int64_t dims, int64_t n,
                                      int64_t slice_len, float box,
                                      const void* anchors, int width,
                                      int periodic, void* scratch,
                                      void* barrier, void* out, void* out_mn,
                                      void* out_mx, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encode_recip_fused_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = blocks * dims;
  const int64_t items = rows * ((n + slice_len - 1) / slice_len);
  const int64_t word_blocks = (rows * (n / 32) * width + kThreads - 1) /
                              kThreads;
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  const int64_t want = items > word_blocks ? items : word_blocks;
  if (grid > want) grid = want;
  if (grid < 1) grid = 1;

  const float* xp = static_cast<const float*>(x);
  const float* ap = static_cast<const float*>(anchors);
  float* pmin = static_cast<float*>(scratch);
  float* pmax = pmin + items;
  float* recip = pmax + items;
  auto* bar = static_cast<unsigned int*>(barrier);
  auto* o = static_cast<uint32_t*>(out);
  auto* mn = static_cast<float*>(out_mn);
  auto* mx = static_cast<float*>(out_mx);
  void* args[] = {&xp,   &blocks, &dims,  &n,     &slice_len, &box,
                  &ap,   &width,  &periodic, &pmin, &pmax,    &recip,
                  &bar,  &o,      &mn,    &mx};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(encode_recip_fused_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
