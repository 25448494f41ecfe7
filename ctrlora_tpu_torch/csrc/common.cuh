// Shared helpers of the hand-written Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ctrlora {

using bf16 = __nv_bfloat16;

// mma.sync.m16n8k16, bf16 in, fp32 accumulate: c += a * b. Fragment layout
// (g = lane / 4, tig = lane % 4): a[0..3] hold A (row g, cols 2tig..+1),
// (row g+8, same), (row g, cols 2tig+8..+9), (row g+8, same); b0/b1 hold B
// (k rows 2tig..+1 / 2tig+8..+9, col g); c[0..1] is C (row g, cols
// 2tig..+1), c[2..3] row g+8.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ctrlora
