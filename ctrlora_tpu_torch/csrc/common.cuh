// Shared helpers of the hand-written Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ctrlora {

using bf16 = __nv_bfloat16;

// Copy a [ROWS, COLS] bf16 tile from global memory (row stride `rs`
// elements) to shared memory (row stride COLS), in 16-byte vectors. Rows at
// or past `nrows` and columns at or past `ncols` are written as zeros, so the
// tile is zero-padded for the tensor cores. Requires ncols % 8 == 0, rs % 8
// == 0 and a 16-byte aligned `src` (the wrappers check all three).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs,
                                          int row0, int nrows, int ncols) {
  static_assert(COLS % 8 == 0, "tile width must be a multiple of 8");
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < ncols) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rs + c);
    }
    *reinterpret_cast<uint4*>(dst + r * COLS + c) = val;
  }
}

}  // namespace ctrlora
