// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces the TPU kernels ctrlora_tpu/ops/flash_attention.py
// `_fwd_kernel_packed_qkv` (the packed q|k|v self-attention of the UNet and
// ControlNet) and `_fwd_kernel` (the BHSD single-head attention of the VAE).
// One source serves both: the launcher takes (batch, sequence, head) strides
// for q, k, v and out, so the packed view (row stride 3*H*D, k at +H*D, v at
// +2*H*D) and the [B, H, S, D] view need no copies.
//
// What bounds it on the H100: at the UNet's 64x64 sites (S=4096, D=40) the
// two products are 4*S*S*D flops per head against S*D*8 bytes of q|k|v|out,
// far above the card's ~295 flop/byte ridge, so the tensor cores bound it;
// the [S, S] logits are the traffic a plain implementation adds (a 4096^2
// fp32 block per head). These kernels never write them: each block holds
// its query rows and walks the keys in tiles with an online softmax, so
// device memory sees q, k, v once per block and the output once.
//
// Two kernels share the launcher, chosen by head dim:
//
// * D <= 160 (the UNet/ControlNet sites, D = 40/80/160): FlashAttention-2's
//   shape on mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A block of four
//   warps owns 64 query rows; each warp keeps its 16 rows' q fragments,
//   logits, probabilities and output accumulator in registers, so the only
//   shared-memory traffic is the 64-key K/V tile the four warps share (K
//   row-major, V transposed, rows padded by 8 elements so fragment loads hit
//   32 distinct banks). The probabilities go from the logits' accumulator
//   layout straight into the A fragments of the PV product. D = 40 is
//   zero-padded to 48 (a multiple of the 16-wide k-step); 80 and 160 tile
//   directly. At D = 40 the exp2 of every logit (8.6e9 per 64x64-site call)
//   is a bound of its own, next to the tensor cores.
// * D = 512 (the VAE's single-head attention): too wide for a register
//   accumulator (64 rows x 512 x 4 B = 128 KB), so its accumulator lives in
//   shared memory: BQ = 32 rows x 512 fp32 = 64 KB beside the q, k, v tiles,
//   166 KB in all, within the 227 KB a block can use; both products run
//   through WMMA 16x16x16 fragments, the softmax row by row.
//
// Both use the exact running-max online softmax (the JAX package's `safemax`
// variant), not its clamped exp2: the result does not depend on the size of
// the logits. The row sum is taken over the bf16-rounded probabilities that
// enter the PV product, as the TPU kernel's ones-augmented V does. Both emit
// the fp32 natural-log logsumexp [B, H, Sq] that the training backward will
// read. Loads are 16-byte vectors (the wrappers check the alignment).
// wgmma, TMA, cp.async pipelining and warp specialisation are later work.

#include <mma.h>

#include "common.cuh"

namespace ctrlora {
namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int BQ, int BK>
struct FlashSmem {
  static constexpr size_t q = 0;                          // bf16 [BQ][DP]
  static constexpr size_t k = q + 2 * BQ * DP;            // bf16 [BK][DP]
  static constexpr size_t v = k + 2 * BK * DP;            // bf16 [BK][DP]
  static constexpr size_t s = v + 2 * BK * DP;            // f32  [BQ][BK]
  static constexpr size_t p = s + 4 * BQ * BK;            // bf16 [BQ][BK]
  static constexpr size_t o = p + 2 * BQ * BK;            // f32  [BQ][DP]
  static constexpr size_t m = o + 4 * BQ * DP;            // f32  [BQ] row max (log2 units)
  static constexpr size_t l = m + 4 * BQ;                 // f32  [BQ] row sum
  static constexpr size_t a = l + 4 * BQ;                 // f32  [BQ] rescale
  static constexpr size_t bytes = a + 4 * BQ;
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 long long qb, long long qs, long long qh,
                 long long kb, long long ks, long long kh,
                 long long vb, long long vs, long long vh,
                 long long ob, long long os, long long oh, float scale_log2) {
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "WMMA tiles");
  static_assert(kThreads % BQ == 0 && BK % (kThreads / BQ) == 0, "softmax split");
  using L = FlashSmem<DP, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sA = reinterpret_cast<float*>(smem + L::a);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const bf16* qbase = q + b * qb + h * qh;
  const bf16* kbase = k + b * kb + h * kh;
  const bf16* vbase = v + b * vb + h * vh;

  load_tile<BQ, DP, kThreads>(sQ, qbase, qs, q0, Sq, D);
  for (int i = tid; i < BQ * DP; i += kThreads) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  constexpr int TPR = kThreads / BQ;  // threads per softmax row
  constexpr int CPT = BK / TPR;       // columns per thread
  const int row = tid / TPR;
  const int part = tid % TPR;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // previous tile's readers of sK/sV/sP are done
    load_tile<BK, DP, kThreads>(sK, kbase, ks, k0, Sk, D);
    load_tile<BK, DP, kThreads>(sV, vbase, vs, k0, Sk, D);
    __syncthreads();

    // S = Q K^T, fp32
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += kWarps) {
      const int tr = t / (BK / 16);
      const int tc = t % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + tr * 16 * DP + kk, DP);
        wmma::load_matrix_sync(fb, sK + tc * 16 * DP + kk, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + tr * 16 * BK + tc * 16, acc, BK, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax over this key tile: TPR adjacent lanes share a row
    {
      float* srow = sS + row * BK + part * CPT;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bool valid = k0 + part * CPT + j < Sk;
        const float sv = valid ? srow[j] * scale_log2 : -INFINITY;
        srow[j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a valid key
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bf16 pb = __float2bfloat16(exp2f(srow[j] - m_new));
        sP[row * BK + part * CPT + j] = pb;
        sum += __bfloat162float(pb);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * DP; i += kThreads) sO[i] *= sA[i / DP];
    __syncthreads();

    // O += P V
    for (int t = warp; t < (BQ / 16) * (DP / 16); t += kWarps) {
      const int tr = t / (DP / 16);
      const int tc = t % (DP / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + tr * 16 * DP + tc * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + tr * 16 * BK + kk, BK);
        wmma::load_matrix_sync(fb, sV + kk * DP + tc * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + tr * 16 * DP + tc * 16, acc, DP, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* obase = out + b * ob + h * oh;
  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    if (q0 + r < Sq && c < D)
      obase[(long long)(q0 + r) * os + c] = __float2bfloat16(sO[i] / sL[r]);
  }
  for (int r = tid; r < BQ; r += kThreads) {
    if (q0 + r < Sq)
      lse[(long long)bh * Sq + q0 + r] = (sM[r] + log2f(sL[r])) / kLog2e;
  }
}

template <int DP, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int H, int Sq, int Sk, int D, const long long* st,
                   float scale_log2, cudaStream_t stream) {
  using L = FlashSmem<DP, BQ, BK>;
  auto kern = flash_fwd_kernel<DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Register-resident kernel for head dims up to 160 (the UNet/ControlNet
// sites): FlashAttention-2's shape on mma.sync. Each warp owns 16 query rows
// and keeps their q fragments, logits, probabilities and output accumulator
// in registers; the block's four warps share each 64-key K/V tile in shared
// memory (K row-major, V transposed, rows padded by 8 elements so the
// fragment loads hit 32 distinct banks).
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     long long qb, long long qs, long long qh,
                     long long kb, long long ks, long long kh,
                     long long vb, long long vs, long long vh,
                     long long ob, long long os, long long oh, float scale_log2) {
  constexpr int BQ = 16 * kWarps;  // 64 query rows per block
  constexpr int BK = 64;           // keys per tile
  constexpr int KS = DP / 16;      // k-steps of the QK product
  constexpr int ND = DP / 8;       // n-tiles of the PV product
  constexpr int KST = DP + 8;      // padded row strides (bank-conflict free)
  constexpr int VST = BK + 8;
  static_assert(DP % 16 == 0, "head dim pads to a multiple of 16");
  __shared__ __align__(16) bf16 sK[BK * KST];
  __shared__ __align__(16) bf16 sVt[DP * VST];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  const int row0 = blockIdx.x * BQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const bf16* qbase = q + b * qb + h * qh;
  const bf16* kbase = k + b * kb + h * kh;
  const bf16* vbase = v + b * vb + h * vh;

  // q fragments (A operand, row-major 16x16 per k-step), zero past Sq / D
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = kk * 16 + tig * 2;
    const int c1 = c0 + 8;
    auto ld = [&](int r, int c) -> uint32_t {
      return (r < Sq && c < D)
                 ? *reinterpret_cast<const uint32_t*>(qbase + (long long)r * qs + c)
                 : 0u;
    };
    qf[kk][0] = ld(row0, c0);
    qf[kk][1] = ld(row1, c0);
    qf[kk][2] = ld(row0, c1);
    qf[kk][3] = ld(row1, c1);
  }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    constexpr int CH = DP / 8;
    for (int i = tid; i < BK * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk && c < D) {
        kv = *reinterpret_cast<const uint4*>(kbase + (long long)(k0 + r) * ks + c);
        vv = *reinterpret_cast<const uint4*>(vbase + (long long)(k0 + r) * vs + c);
      }
      *reinterpret_cast<uint4*>(sK + r * KST + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VST + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* kr = sK + (j * 8 + g) * KST + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16_16816(sc[j], qf[kk], b0, b1);
      }
    }

    // online softmax (exp2 domain); a row's 64 values live in a lane quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + j * 8 + tig * 2 + e < Sk;
        sc[j][e] = valid ? sc[j][e] * scale_log2 : -INFINITY;
        sc[j][2 + e] = valid ? sc[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);  // finite: every tile has a valid key
    const float mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0);  // 0 on the first tile
    const float al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P in bf16, laid out directly as the A fragments of the PV product;
    // the row sums are taken over the rounded values the product uses
    uint32_t pa[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 p01 =
          __floats2bfloat162_rn(exp2f(sc[j][0] - mn0), exp2f(sc[j][1] - mn0));
      const __nv_bfloat162 p23 =
          __floats2bfloat162_rn(exp2f(sc[j][2] - mn1), exp2f(sc[j][3] - mn1));
      sum0 += __low2float(p01) + __high2float(p01);
      sum1 += __low2float(p23) + __high2float(p23);
      pa[j / 2][(j % 2) * 2 + 0] = as_u32(p01);
      pa[j / 2][(j % 2) * 2 + 1] = as_u32(p23);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= al0;
      o[dn][1] *= al0;
      o[dn][2] *= al1;
      o[dn][3] *= al1;
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* vr = sVt + (dn * 8 + g) * VST + kc * 16 + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma_bf16_16816(o[dn], pa[kc], b0, b1);
      }
    }
  }

  bf16* obase = out + b * ob + h * oh;
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const int c = dn * 8 + tig * 2;
    if (c < D) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row0 * os + c) =
            __floats2bfloat162_rn(o[dn][0] * inv0, o[dn][1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row1 * os + c) =
            __floats2bfloat162_rn(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
  if (tig == 0) {
    if (row0 < Sq) lse[(long long)bh * Sq + row0] = (m0 + log2f(l0)) / kLog2e;
    if (row1 < Sq) lse[(long long)bh * Sq + row1] = (m1 + log2f(l1)) / kLog2e;
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int H, int Sq, int Sk, int D, const long long* st,
                       float scale_log2, cudaStream_t stream) {
  dim3 grid((Sq + 16 * kWarps - 1) / (16 * kWarps), B * H);
  flash_fwd_mma_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlora

extern "C" int ctrlora_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int B, int H, int Sq, int Sk, int D,
                                 long long qb, long long qs, long long qh,
                                 long long kb, long long ks, long long kh,
                                 long long vb, long long vs, long long vh,
                                 long long ob, long long os, long long oh,
                                 float scale, void* stream) {
  using namespace ctrlora;
  const long long st[12] = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D % 8 != 0 || D <= 0) {
    err = cudaErrorInvalidValue;
  } else if (D <= 48) {
    err = launch_mma<48>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 64) {
    err = launch_mma<64>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 80) {
    err = launch_mma<80>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 128) {
    err = launch_mma<128>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 160) {
    err = launch_mma<160>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 512) {
    err = launch<512, 32, 32>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
