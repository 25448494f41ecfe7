// Fused GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   [a | g] = x W1 + b1;   y = (a * gelu_erf(g)) W2 + b2
//
// Replaces the TPU kernels ctrlora_tpu/ops/geglu_ffn.py `_geglu_kernel`
// (weights resident, C = 320 and 640) and `_geglu_kernel_blocked` (F
// streamed into an fp32 accumulator, C = 1280). One design covers both.
//
// What bounds it on the H100: a plain implementation writes and re-reads the
// [rows, 2F] pre-activation (at the 64x64 sites 8*4096 rows x 2560 bf16 =
// 168 MB per call); this kernel never materialises it. What is left is the
// weights: a block keeps a [BR, C] fp32 output tile in registers (80 per
// thread), so BR*C is capped near 20K and every block streams all of W1 and
// W2 (2.5 MB at C = 320, 39 MB at C = 1280) from L2. Each weight element is
// used BR times per pass, 2*BR flops per byte: the L2 stream bounds the wide
// sites (BR = 16 at C = 1280), the tensor cores the narrow ones.
//
// Design: a block owns BR rows of x (staged once in shared memory) and walks
// F in chunks of FC = 64. Per chunk it computes the a and g tiles [BR, 64]
// (K = C) with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), applies
// a * gelu(g) with CUDA's erff in registers, writes the gated tile to shared
// memory in bf16, and accumulates gated[BR, 64] @ W2[chunk, :] into the
// register-resident output tile. The weights arrive as a stream of bf16
// tiles 320 wide (per chunk: an a- and a g-tile of [64, 320] per 320-wide
// k-step of W1, then one [320, 64] tile of W2 per 320 output columns)
// through a 3-deep cp.async ring, so loads run two tiles ahead of the tensor
// cores. Rows are padded by 8 elements in shared memory so fragment loads
// hit 32 distinct banks.
// BR = 64 at C = 320, 32 at C = 640, 16 at C = 1280. b2 is added once and
// the result stored in bf16. As in the TPU kernel, `a` is rounded to bf16
// before the gate and the gated product is rounded to bf16 before the
// second product; `g` stays fp32 (the blocked TPU variant's choice).
// wgmma, TMA multicast of the weights across a cluster (which would lift the
// L2 bound) and warp specialisation are later work.

#include "common.cuh"

namespace ctrlora {
namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int FC = 64;         // F chunk
constexpr int GS = FC + 8;     // padded row stride of the gated block and W2 tiles
constexpr int kStages = 3;     // cp.async ring depth
// width of a weight tile: W1 tiles are [64 chunk columns, TK of C], W2 tiles
// [TK output channels, 64 of the chunk]. Each ring step costs a block-wide
// barrier, so wide tiles matter: 64-wide ones ran the C = 1280 site 3x slower
constexpr int TK = 320;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

template <int C, int BR>
struct GegluSmem {
  static constexpr int XS = C + 8;  // padded row strides
  static constexpr int US = TK + 8;
  static constexpr int SLOT = (FC * US > TK * GS) ? FC * US : TK * GS;  // elements
  static constexpr size_t x = 0;                                // bf16 [BR][XS]
  static constexpr size_t w = x + 2 * BR * XS;                  // bf16 [kStages][SLOT]
  static constexpr size_t gated = w + 2 * kStages * SLOT;       // bf16 [BR][GS]
  static constexpr size_t bytes = gated + 2 * BR * GS;
};

template <int C, int BR>
__global__ void __launch_bounds__(kThreads, 1)
geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const bf16* __restrict__ b1, const bf16* __restrict__ w2,
             const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int F) {
  constexpr int MU = BR / 16;       // 16-row m-tiles
  constexpr int WPM = kWarps / MU;  // warps per m-tile
  constexpr int NA = (FC / 8) / WPM;  // 8-wide n-tiles per warp of the a/g tiles
  constexpr int ND = (TK / 8) / WPM;  // 8-wide n-tiles per warp of an output slice
  constexpr int NK = C / TK;          // k-tiles of x W1 == output slices of y
  constexpr int TPC = 3 * NK;         // weight tiles per F chunk
  static_assert(C % TK == 0 && TK % 16 == 0 && BR % 16 == 0 && kWarps % MU == 0 &&
                NA >= 1 && ND >= 1, "tiling");
  using L = GegluSmem<C, BR>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + L::x);
  bf16* sW = reinterpret_cast<bf16*>(smem + L::w);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::gated);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int mt = warp / WPM;         // this warp's m-tile
  const int nt0 = (warp % WPM) * NA;  // its first n-tile of the a/g tiles
  const int nd0 = (warp % WPM) * ND;  // and of each output slice
  const int row0 = blockIdx.x * BR;
  const int n_chunks = F / FC;
  const int n_tiles = n_chunks * TPC;

  // tile t of the weight stream -> ring slot t % kStages (always commits, so
  // the group count stays in step with t)
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int chunk = t / TPC;
      const int j = t % TPC;
      const int f0 = chunk * FC;
      bf16* dst = sW + (t % kStages) * L::SLOT;
      if (j < 2 * NK) {  // W1 rows (a: f0.., g: F+f0..), k columns (j/2)*TK..
        const bf16* src = w1 + (long long)((j & 1) * F + f0) * C + (j >> 1) * TK;
        for (int i = tid; i < FC * (TK / 8); i += kThreads) {
          const int r = i / (TK / 8);
          const int c = (i % (TK / 8)) * 8;
          cp_async16(dst + r * L::US + c, src + (long long)r * C + c);
        }
      } else {  // W2^T rows (output channels (j-2NK)*TK..), chunk columns f0..
        const bf16* src = w2 + (long long)((j - 2 * NK) * TK) * F + f0;
        for (int i = tid; i < TK * (FC / 8); i += kThreads) {
          const int r = i / (FC / 8);
          const int c = (i % (FC / 8)) * 8;
          cp_async16(dst + r * GS + c, src + (long long)r * F + c);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  load_tile<BR, L::XS, kThreads>(sX, x, C, row0, rows, C);  // pad columns stay unread

  float acc[NK][ND][4];
#pragma unroll
  for (int s = 0; s < NK; ++s)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[s][n][0] = acc[s][n][1] = acc[s][n][2] = acc[s][n][3] = 0.f;

  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    float ua[NA][4], ug[NA][4];
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      ua[n][0] = ua[n][1] = ua[n][2] = ua[n][3] = 0.f;
      ug[n][0] = ug[n][1] = ug[n][2] = ug[n][3] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j, ++t) {
      cp_async_wait_ring();
      __syncthreads();  // tile t landed for all; slot (t-1) % kStages is free
      issue(t + kStages - 1);
      const bf16* tile = sW + (t % kStages) * L::SLOT;
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        uint32_t a[4];
        load_a(a, sX + mt * 16 * L::XS + (j >> 1) * TK + ks * 16, L::XS, g, tig);
#pragma unroll
        for (int n = 0; n < NA; ++n) {
          const bf16* br = tile + ((nt0 + n) * 8 + g) * L::US + ks * 16 + tig * 2;
          if (j & 1)
            mma_bf16_16816(ug[n], a, ld32(br), ld32(br + 8));
          else
            mma_bf16_16816(ua[n], a, ld32(br), ld32(br + 8));
        }
      }
    }

    // gate in registers -> gated bf16 block in shared memory (published by
    // the __syncthreads at the top of the next tile step)
    const int f0 = chunk * FC;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int col = (nt0 + n) * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float av = ua[n][half * 2 + e] + __bfloat162float(b1[f0 + col + e]);
          const float gg = ug[n][half * 2 + e] + __bfloat162float(b1[F + f0 + col + e]);
          const float gelu = 0.5f * gg * (1.f + erff(gg * 0.70710678118654752f));
          gv[e] = __bfloat162float(__float2bfloat16(av)) *
                  __bfloat162float(__float2bfloat16(gelu));
        }
        *reinterpret_cast<__nv_bfloat162*>(sG + (mt * 16 + g + half * 8) * GS + col) =
            __floats2bfloat162_rn(gv[0], gv[1]);
      }
    }

#pragma unroll
    for (int s = 0; s < NK; ++s, ++t) {
      cp_async_wait_ring();
      __syncthreads();
      issue(t + kStages - 1);
      const bf16* tile = sW + (t % kStages) * L::SLOT;
#pragma unroll
      for (int ks = 0; ks < FC / 16; ++ks) {
        uint32_t a[4];
        load_a(a, sG + mt * 16 * GS + ks * 16, GS, g, tig);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const bf16* br = tile + ((nd0 + n) * 8 + g) * GS + ks * 16 + tig * 2;
          mma_bf16_16816(acc[s][n], a, ld32(br), ld32(br + 8));
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < NK; ++s) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = s * TK + (nd0 + n) * 8 + tig * 2;
      const float bias0 = __bfloat162float(b2[col]);
      const float bias1 = __bfloat162float(b2[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 16 + g + half * 8;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * C + col) =
              __floats2bfloat162_rn(acc[s][n][half * 2] + bias0,
                                    acc[s][n][half * 2 + 1] + bias1);
      }
    }
  }
}

template <int C, int BR>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, int F, cudaStream_t stream) {
  using L = GegluSmem<C, BR>;
  auto kern = geglu_kernel<C, BR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  kern<<<(rows + BR - 1) / BR, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), rows, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlora

extern "C" int ctrlora_geglu_ffn(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int rows,
                                 int C, int F, void* stream) {
  using namespace ctrlora;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (F % FC != 0) {
    err = cudaErrorInvalidValue;
  } else if (C == 320) {
    err = launch<320, 64>(x, w1, b1, w2, b2, out, rows, F, s);
  } else if (C == 640) {
    err = launch<640, 32>(x, w1, b1, w2, b2, out, rows, F, s);
  } else if (C == 1280) {
    err = launch<1280, 16>(x, w1, b1, w2, b2, out, rows, F, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
