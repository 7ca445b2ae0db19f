// K6: per-row min and max of R independent f32 streams, each optionally
// unwrapped around its anchor (its element 0) in a periodic box first.
//
// Replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:
// stats_pallas_rows (_stats_rows_kernel), the stats pass of the snapshot
// writer (x0 and range of every block's position, velocity and mass rows).
// The unwrap is kernels.undo_periodic op for op: half = box * 0.5;
// x - a >= half -> x - box; then x - a < -half -> x + box.
// Output bits equal encode_cuda.stats_rows_plain and the JAX package's
// jnp.min / jnp.max on XLA (minmax.cuh): subnormals read as zeros of their
// sign, NaN propagates (as the canonical quiet NaN), and -0.0 counts below
// +0.0 (IEEE minimum / maximum), so the result does not depend on the order
// of the reduction.  The reduction and the unwrap are shared with K12.
//
// Bound on the card: memory.  Each element is read once (4 bytes); the
// output is 8 bytes per row.
//
// Design: a 1-D grid of one block per (row, slice of slice_len elements),
// so any row count fits the grid's x dimension.  A block reduces its slice
// in registers, then across its warps with shuffles and shared memory, and
// writes one partial min and max.  A second launch, one thread per row,
// reduces the row's partials.  No float atomics, so the result is
// deterministic.
// Left for later work: 16-byte loads, and one launch with a last-block
// finish instead of two.

#include <cstdint>
#include <cuda_runtime.h>

#include "minmax.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void stats_rows_partial(const float* __restrict__ x, int64_t n,
                                   int64_t slices, int64_t slice_len,
                                   const float* __restrict__ box,
                                   const float* __restrict__ anchor,
                                   int periodic, float* __restrict__ pmin,
                                   float* __restrict__ pmax) {
  const int64_t blk = blockIdx.x;
  const int64_t r = blk / slices;
  const int64_t lo = (blk - r * slices) * slice_len;
  const int64_t hi = lo + slice_len < n ? lo + slice_len : n;
  float bx = 0.0f, a = 0.0f, half = 0.0f;
  if (periodic) {
    bx = box[r];
    a = anchor[r];
    half = mnw::half_box(bx);
  }
  float mn, mx;
  mnw::slice_minmax<kThreads>(x + r * n, lo, hi, periodic, bx, half, a, mn,
                              mx);
  if (threadIdx.x == 0) {
    pmin[blk] = mn;
    pmax[blk] = mx;
  }
}

__global__ void stats_rows_finish(const float* __restrict__ pmin,
                                  const float* __restrict__ pmax,
                                  int64_t rows, int64_t slices,
                                  float* __restrict__ out_min,
                                  float* __restrict__ out_max) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= rows) return;
  float mn = pmin[r * slices];
  float mx = pmax[r * slices];
  for (int64_t s = 1; s < slices; ++s) {
    mn = mnw::min_op(mn, pmin[r * slices + s]);
    mx = mnw::max_op(mx, pmax[r * slices + s]);
  }
  out_min[r] = mn;
  out_max[r] = mx;
}

}  // namespace

// partials: 2 * rows * slices floats of scratch, slices = ceil(n / slice_len).
extern "C" int mnw_stats_rows(const void* x, int64_t rows, int64_t n,
                              int64_t slice_len, const void* box,
                              const void* anchor, int periodic,
                              void* partials, void* out_min, void* out_max,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t slices = (n + slice_len - 1) / slice_len;
  float* pmin = static_cast<float*>(partials);
  float* pmax = pmin + rows * slices;
  stats_rows_partial<<<static_cast<unsigned>(rows * slices), kThreads, 0,
                       s>>>(
      static_cast<const float*>(x), n, slices, slice_len,
      static_cast<const float*>(box), static_cast<const float*>(anchor),
      periodic, pmin, pmax);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_rows_finish<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(pmin, pmax, rows, slices,
                                        static_cast<float*>(out_min),
                                        static_cast<float*>(out_max));
  return static_cast<int>(cudaGetLastError());
}
