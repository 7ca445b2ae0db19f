// The row of an element of a flat stream of rows, shared by the tile kernels
// that walk such a stream (decode.cu: K1 / K2; pack.cuh: K5 / K8 / K12).
//
// A tile finds its first row and its offset in that row once (one 64-bit
// division); an element at in-tile offset i then lies at offset off0 + i of
// that row, below 2^32 for rows of at most 2^31 elements, and the 32-bit
// division of that offset by the row length goes through a magic number:
// q = umulhi(off, floor(2^32 / n)) is the quotient or one less, so one
// correction step finishes (the wrapper computes the magic:
// ops/cuda_lib.row_magic; tests/test_torch_ops.py holds the split against
// off // n and off % n).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mnw {

// off -> (rows past the tile's first row, offset in that row).
__device__ __forceinline__ uint32_t split_row(uint32_t& off, uint32_t n,
                                              uint32_t magic) {
  uint32_t q = __umulhi(off, magic);
  off -= q * n;
  if (off >= n) {
    ++q;
    off -= n;
  }
  return q;
}

}  // namespace mnw
