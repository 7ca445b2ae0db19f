// K6: per-row min and max of R independent f32 streams, each optionally
// unwrapped around its anchor (its element 0) in a periodic box first.
//
// Replaces the Pallas kernel minnow_c_tpu/ops/encode_pallas.py:
// stats_pallas_rows (_stats_rows_kernel), the stats pass of the snapshot
// writer (x0 and range of every block's position, velocity and mass rows).
// The unwrap is kernels.undo_periodic op for op: half = box * 0.5;
// x - a >= half -> x - box; then x - a < -half -> x + box.
// Output bits equal encode_cuda.stats_rows_plain and the JAX package's
// jnp.min / jnp.max on XLA: subnormals read as zeros of their sign, NaN
// propagates (as the canonical quiet NaN), and -0.0 counts below +0.0 (IEEE
// minimum / maximum), so the result does not depend on the order of the
// reduction.  The slice routine is shared with K12 (minmax.cuh).
//
// Bound on the card: memory.  Each element is read once (4 bytes); the
// output is 8 bytes per row: 0.48 ms for 192 rows of 2^21 at 3.35 TB/s.
// Reaching it takes some 25 KB in flight per SM (3.35 TB/s x ~1 us / 132
// SMs) and little work per byte.
//
// Design: one launch, a 1-D grid of one block per (row, slice of slice_len
// elements; 2^15 from the wrapper), so any row count fits the grid's x
// dimension and each block reads 128 KB with one block reduction at its
// end.  Each thread keeps four 16-byte streaming loads in flight (16 KB a
// block of 256), from the row's first 16-byte boundary; slice 0 also takes
// the scalars before it and after the last one (minmax.cuh slice_keys).
// Per element the work is the optional unwrap, an order-preserving integer
// key and two integer min / max; the flush and the NaN test are applied
// once to the row's result (minmax.cuh gives the argument).  A block writes
// its slice's two keys and takes a ticket from its row's counter; the block
// that takes a row's last ticket reduces the row's keys and writes its min
// and max.  Integer min / max are exact and order-free, so the result is
// deterministic, with no float atomics.  The counters are cleared by one
// cudaMemsetAsync on the launch's stream before the kernel (the wrapper
// keeps the scratch per device and stream).

#include <cstdint>
#include <cuda_runtime.h>

#include "minmax.cuh"

namespace {

constexpr int kThreads = 256;

struct StatsArgs {
  const float* x;
  int64_t n, slices;      // elements a row; slices a row, ceil(n / slice_len)
  int slice_len;          // a multiple of 4
  const float* box;       // (R,) boxes and anchors, read when periodic
  const float* anchor;
  int periodic;
  unsigned* tickets;      // (R,) zero on entry
  int* keys;              // (R * slices, 2) each slice's min and max key
  float* out_min;
  float* out_max;
};

__global__ void __launch_bounds__(kThreads) stats_rows_kernel(
    const StatsArgs a) {
  const int64_t item = blockIdx.x;
  const int64_t r = item / a.slices;
  const int64_t s = item - r * a.slices;
  const float* row = a.x + r * a.n;
  mnw::KeyRange k;
  if (a.periodic) {
    const float bx = a.box[r];
    k = mnw::slice_keys<kThreads, true>(row, a.n, s, a.slice_len, bx,
                                        mnw::half_box(bx), a.anchor[r]);
  } else {
    k = mnw::slice_keys<kThreads, false>(row, a.n, s, a.slice_len, 0.0f,
                                         0.0f, 0.0f);
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.keys[2 * item] = k.lo;
    a.keys[2 * item + 1] = k.hi;
    __threadfence();  // the keys are visible before the ticket is
    last = atomicAdd(a.tickets + r, 1u) == a.slices - 1;
  }
  __syncthreads();
  if (!last) return;
  // The row's last block: its slices' keys, read through L2.
  __threadfence();
  mnw::KeyRange all = mnw::empty_key_range();
  const int* keys = a.keys + 2 * r * a.slices;
  for (int64_t i = threadIdx.x; i < a.slices; i += kThreads) {
    all.lo = min(all.lo, __ldcg(keys + 2 * i));
    all.hi = max(all.hi, __ldcg(keys + 2 * i + 1));
  }
  all = mnw::block_key_range<kThreads>(all);
  if (threadIdx.x == 0) {
    mnw::key_range_to_floats(all, a.out_min[r], a.out_max[r]);
  }
}

}  // namespace

// scratch: rows u32 ticket counters (cleared here on the stream before the
// launch), then 2 * rows * slices i32 keys, slices = ceil(n / slice_len);
// slice_len a multiple of 4 (ops/encode_cuda.STATS_SLICE).
extern "C" int mnw_stats_rows(const void* x, int64_t rows, int64_t n,
                              int slice_len, const void* box,
                              const void* anchor, int periodic,
                              void* scratch, void* out_min, void* out_max,
                              void* stream) {
  const int64_t slices = (n + slice_len - 1) / slice_len;
  if (rows < 1 || n < 1 || slice_len < 4 || slice_len % 4 ||
      rows * slices >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* tickets = static_cast<unsigned*>(scratch);
  const cudaError_t rc =
      cudaMemsetAsync(tickets, 0, sizeof(unsigned) * rows, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const StatsArgs a{static_cast<const float*>(x),
                    n,
                    slices,
                    slice_len,
                    static_cast<const float*>(box),
                    static_cast<const float*>(anchor),
                    periodic,
                    tickets,
                    reinterpret_cast<int*>(tickets + rows),
                    static_cast<float*>(out_min),
                    static_cast<float*>(out_max)};
  stats_rows_kernel<<<static_cast<unsigned>(rows * slices), kThreads, 0,
                      s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
