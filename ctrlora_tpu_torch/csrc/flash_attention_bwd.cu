// Flash-attention backward for Hopper (sm_90a): bf16 operands, fp32
// accumulators, no atomics.
//
// Replaces the TPU kernels ctrlora_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (driven by `_flash_backward`).
// FlashAttention-2's split, as the TPU design has it: the dK/dV kernel owns
// a block of keys and walks every query tile; the dQ kernel owns a block of
// queries and walks every key tile. Each output is written once by the block
// that owns it, so neither kernel needs atomics and both are deterministic.
// P is recomputed from the forward's natural-log logsumexp (times log2 e,
// exp2 domain, as the forward and the JAX package do); Delta = rowsum(dO*O)
// comes in precomputed in fp32.
//
//   dV = P^T dO        dK = scale * dS^T Q        dQ = scale * dS K
//   P  = exp2(scale*log2e * Q K^T - lse*log2e)    dS = P * (dO V^T - Delta)
//
// P and dS are rounded to bf16 before the products that consume them (the
// tensor cores take bf16), which bounds the agreement with an fp32 version to
// bf16 rounding summed over the key (or query) axis.
//
// What bounds it on the H100: five S x S x D products per head (QK^T and
// dO V^T twice, one per kernel, plus dV, dK, dQ) against a few S x D
// operands, far above the ~295 flop/byte ridge at S = 4096, so the tensor
// cores and the exp2 of every recomputed probability bound it; a plain
// version writes the [S, S] probabilities and dS to device memory, which
// these kernels never do.
//
// Design: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), four warps, each warp
// owning 16 rows of the block's 64. The owned tile (K and V, or Q and dO)
// and each streamed tile sit in shared memory with rows padded by 8
// elements, so fragment loads hit 32 distinct banks; the streamed operands
// a product contracts over their row index (Q and dO for dV/dK, K for dQ)
// are also stored transposed. The logits and dP of a warp's 16 rows stay in
// registers and go from the accumulator layout straight into the A
// fragments of the next product, as in the forward. The fp32 accumulators
// (dK and dV: D/2 floats each per thread) limit the streamed tile: 64 rows
// up to D = 80, 32 rows at D = 128 and 160, so the D = 160 kernel stays in
// the register budget. Operands are addressed by (batch, sequence, head)
// strides, so one pair of kernels serves the BHSD, BSHD and fused-qkv
// layouts, and the gradients of the fused layout are written straight into
// the [B, S, 3*H*D] gradient. wgmma, TMA and pipelined loads are later work.

#include "common.cuh"

namespace ctrlora {
namespace {

constexpr int kThreads = 128;       // four warps
constexpr int kRows = 16 * kThreads / 32;  // rows a block owns: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // batch, sequence, head (elements)
};

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B*H, Sq] natural log
  const float* delta;  // [B*H, Sq]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Sq, Sk, D;
  float scale, scale_log2;
};

// Stage rows [row0, row0 + ROWS) of one head of a [n, D] operand (row stride
// `rs`) in shared memory as [ROWS][DP + 8], and, when `t` is given, also
// transposed as [DP][ROWS + 8]. Zero past n and D. 16-byte loads (the
// wrapper checks pointers and strides).
template <int ROWS, int DP>
__device__ __forceinline__ void stage(bf16* rm, bf16* t, const bf16* src, long long rs,
                                      int row0, int n, int D) {
  constexpr int CH = DP / 8;
  constexpr int DST = DP + 8;
  constexpr int TST = ROWS + 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(rm + r * DST + c) = val;
    if (t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) t[(c + j) * TST + r] = e[j];
    }
  }
}

template <int DP, int T>
struct DkvSmem {
  static constexpr size_t bytes =
      2 * (2 * kRows * (DP + 8) + 2 * T * (DP + 8) + 2 * DP * (T + 8)) + 2 * 4 * T;
};

template <int DP, int T>
struct DqSmem {
  static constexpr size_t bytes = 2 * (2 * kRows * (DP + 8) + 2 * T * (DP + 8) + DP * (T + 8));
};

// dK, dV for 64 keys of one (batch, head); walks every query tile of T rows.
template <int DP, int T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int DST = DP + 8;
  constexpr int TST = T + 8;
  constexpr int KS = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;   // n-tiles over the head dim
  constexpr int NT = T / 8;    // n-tiles over a query tile
  constexpr int KC = T / 16;   // k-steps over a query tile
  static_assert(DP % 16 == 0 && T % 16 == 0, "mma tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [kRows][DST]
  bf16* sV = sK + kRows * DST;               // [kRows][DST]
  bf16* sQ = sV + kRows * DST;               // [T][DST]
  bf16* sO = sQ + T * DST;                   // [T][DST] dO
  bf16* sQt = sO + T * DST;                  // [DP][TST]
  bf16* sOt = sQt + DP * TST;                // [DP][TST] dO transposed
  float* sL = reinterpret_cast<float*>(sOt + DP * TST);  // [T] lse * log2 e
  float* sD = sL + T;                                    // [T] Delta

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const bf16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vb = p.v + b * p.sv.b + h * p.sv.h;
  const bf16* ob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float* delta = p.delta + (long long)bh * p.Sq;

  stage<kRows, DP>(sK, nullptr, kb, p.sk.s, k0, p.Sk, p.D);
  stage<kRows, DP>(sV, nullptr, vb, p.sv.s, k0, p.Sk, p.D);
  const bf16* kw = sK + warp * 16 * DST;  // this warp's 16 keys
  const bf16* vw = sV + warp * 16 * DST;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += T) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, DP>(sQ, sQt, qb, p.sq.s, q0, p.Sq, p.D);
    stage<T, DP>(sO, sOt, ob, p.sdo.s, q0, p.Sq, p.D);
    for (int i = tid; i < T; i += kThreads) {
      const bool ok = q0 + i < p.Sq;
      sL[i] = ok ? lse[q0 + i] * kLog2e : INFINITY;  // P = 0 past Sq
      sD[i] = ok ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x T queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, kw + kk * 16, DST, g, tig);
      load_a(av, vw + kk * 16, DST, g, tig);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* qr = sQ + (j * 8 + g) * DST + kk * 16 + tig * 2;
        mma_bf16_16816(s[j], ak, ld32(qr), ld32(qr + 8));
        const bf16* orow = sO + (j * 8 + g) * DST + kk * 16 + tig * 2;
        mma_bf16_16816(dp[j], av, ld32(orow), ld32(orow + 8));
      }
    }

    // P^T and dS^T in bf16, laid out as the A fragments of the next products
    uint32_t pa[KC][4], da[KC][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + tig * 2;  // query columns c, c + 1
      const float l0 = sL[c], l1 = sL[c + 1], d0 = sD[c], d1 = sD[c + 1];
      const float p00 = exp2f(s[j][0] * p.scale_log2 - l0);  // key g
      const float p01 = exp2f(s[j][1] * p.scale_log2 - l1);
      const float p10 = exp2f(s[j][2] * p.scale_log2 - l0);  // key g + 8
      const float p11 = exp2f(s[j][3] * p.scale_log2 - l1);
      pa[j / 2][(j % 2) * 2 + 0] = as_u32(__floats2bfloat162_rn(p00, p01));
      pa[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(p10, p11));
      da[j / 2][(j % 2) * 2 + 0] =
          as_u32(__floats2bfloat162_rn(p00 * (dp[j][0] - d0), p01 * (dp[j][1] - d1)));
      da[j / 2][(j % 2) * 2 + 1] =
          as_u32(__floats2bfloat162_rn(p10 * (dp[j][2] - d0), p11 * (dp[j][3] - d1)));
    }

    // dV += P^T dO, dK += dS^T Q (contracting over the tile's queries)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* ot = sOt + (dn * 8 + g) * TST + kc * 16 + tig * 2;
        mma_bf16_16816(dv[dn], pa[kc], ld32(ot), ld32(ot + 8));
        const bf16* qt = sQt + (dn * 8 + g) * TST + kc * 16 + tig * 2;
        mma_bf16_16816(dk[dn], da[kc], ld32(qt), ld32(qt + 8));
      }
    }
  }

  bf16* dkb = p.dk + b * p.sdk.b + h * p.sdk.h;
  bf16* dvb = p.dv + b * p.sdv.b + h * p.sdv.h;
  const int r0 = k0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const int c = dn * 8 + tig * 2;
    if (c >= p.D) continue;
    if (r0 < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r0 * p.sdk.s + c) =
          __floats2bfloat162_rn(dk[dn][0] * p.scale, dk[dn][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r0 * p.sdv.s + c) =
          __floats2bfloat162_rn(dv[dn][0], dv[dn][1]);
    }
    if (r1 < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)r1 * p.sdk.s + c) =
          __floats2bfloat162_rn(dk[dn][2] * p.scale, dk[dn][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)r1 * p.sdv.s + c) =
          __floats2bfloat162_rn(dv[dn][2], dv[dn][3]);
    }
  }
}

// dQ for 64 queries of one (batch, head); walks every key tile of T rows.
template <int DP, int T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int DST = DP + 8;
  constexpr int TST = T + 8;
  constexpr int KS = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int NT = T / 8;
  constexpr int KC = T / 16;
  static_assert(DP % 16 == 0 && T % 16 == 0, "mma tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kRows][DST]
  bf16* sO = sQ + kRows * DST;               // [kRows][DST] dO
  bf16* sK = sO + kRows * DST;               // [T][DST]
  bf16* sV = sK + T * DST;                   // [T][DST]
  bf16* sKt = sV + T * DST;                  // [DP][TST]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const bf16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vb = p.v + b * p.sv.b + h * p.sv.h;
  const bf16* ob = p.dout + b * p.sdo.b + h * p.sdo.h;

  stage<kRows, DP>(sQ, nullptr, qb, p.sq.s, q0, p.Sq, p.D);
  stage<kRows, DP>(sO, nullptr, ob, p.sdo.s, q0, p.Sq, p.D);
  const bf16* qw = sQ + warp * 16 * DST;  // this warp's 16 queries
  const bf16* ow = sO + warp * 16 * DST;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float* delta = p.delta + (long long)bh * p.Sq;
  const float l0 = r0 < p.Sq ? lse[r0] * kLog2e : INFINITY;  // P = 0 past Sq
  const float l1 = r1 < p.Sq ? lse[r1] * kLog2e : INFINITY;
  const float d0 = r0 < p.Sq ? delta[r0] : 0.f;
  const float d1 = r1 < p.Sq ? delta[r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += T) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, DP>(sK, sKt, kb, p.sk.s, k0, p.Sk, p.D);
    stage<T, DP>(sV, nullptr, vb, p.sv.s, k0, p.Sk, p.D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x T keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, qw + kk * 16, DST, g, tig);
      load_a(ao, ow + kk * 16, DST, g, tig);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* kr = sK + (j * 8 + g) * DST + kk * 16 + tig * 2;
        mma_bf16_16816(s[j], aq, ld32(kr), ld32(kr + 8));
        const bf16* vr = sV + (j * 8 + g) * DST + kk * 16 + tig * 2;
        mma_bf16_16816(dp[j], ao, ld32(vr), ld32(vr + 8));
      }
    }

    // dS in bf16 as A fragments; keys past Sk get P = 0
    uint32_t da[KC][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = k0 + j * 8 + tig * 2;  // key columns c, c + 1
      const bool v0 = c < p.Sk, v1 = c + 1 < p.Sk;
      const float p00 = v0 ? exp2f(s[j][0] * p.scale_log2 - l0) : 0.f;  // query g
      const float p01 = v1 ? exp2f(s[j][1] * p.scale_log2 - l0) : 0.f;
      const float p10 = v0 ? exp2f(s[j][2] * p.scale_log2 - l1) : 0.f;  // query g + 8
      const float p11 = v1 ? exp2f(s[j][3] * p.scale_log2 - l1) : 0.f;
      da[j / 2][(j % 2) * 2 + 0] =
          as_u32(__floats2bfloat162_rn(p00 * (dp[j][0] - d0), p01 * (dp[j][1] - d0)));
      da[j / 2][(j % 2) * 2 + 1] =
          as_u32(__floats2bfloat162_rn(p10 * (dp[j][2] - d1), p11 * (dp[j][3] - d1)));
    }

    // dQ += dS K (contracting over the tile's keys)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* kt = sKt + (dn * 8 + g) * TST + kc * 16 + tig * 2;
        mma_bf16_16816(acc[dn], da[kc], ld32(kt), ld32(kt + 8));
      }
    }
  }

  bf16* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const int c = dn * 8 + tig * 2;
    if (c >= p.D) continue;
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r0 * p.sdq.s + c) =
          __floats2bfloat162_rn(acc[dn][0] * p.scale, acc[dn][1] * p.scale);
    if (r1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)r1 * p.sdq.s + c) =
          __floats2bfloat162_rn(acc[dn][2] * p.scale, acc[dn][3] * p.scale);
  }
}

template <int DP, int T>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = DkvSmem<DP, T>::bytes;
  auto kern = flash_bwd_dkv_kernel<DP, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sk + kRows - 1) / kRows, B * p.H);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, int T>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = DqSmem<DP, T>::bytes;
  auto kern = flash_bwd_dq_kernel<DP, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kRows - 1) / kRows, B * p.H);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Head dims pad to a multiple of 16 (D = 40 -> 48); the streamed tile
// shrinks to 32 rows above D = 80 (register budget of the accumulators).
template <bool DKV>
cudaError_t dispatch(const BwdParams& p, int B, cudaStream_t s) {
  const int D = p.D;
  if (D % 8 != 0 || D <= 0) return cudaErrorInvalidValue;
  if (D <= 48) return DKV ? launch_dkv<48, 64>(p, B, s) : launch_dq<48, 64>(p, B, s);
  if (D <= 64) return DKV ? launch_dkv<64, 64>(p, B, s) : launch_dq<64, 64>(p, B, s);
  if (D <= 80) return DKV ? launch_dkv<80, 64>(p, B, s) : launch_dq<80, 64>(p, B, s);
  if (D <= 128) return DKV ? launch_dkv<128, 32>(p, B, s) : launch_dq<128, 32>(p, B, s);
  if (D <= 160) return DKV ? launch_dkv<160, 32>(p, B, s) : launch_dq<160, 32>(p, B, s);
  return cudaErrorInvalidValue;
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, int H, int Sq, int Sk, int D,
                      const long long* st, float scale) {
  BwdParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.sq = {st[0], st[1], st[2]};
  p.sk = {st[3], st[4], st[5]};
  p.sv = {st[6], st[7], st[8]};
  p.sdo = {st[9], st[10], st[11]};
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace
}  // namespace ctrlora

// st: (batch, sequence, head) strides of q, k, v, dout, dq
extern "C" int ctrlora_flash_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int H, int Sq, int Sk, int D,
                                    const long long* st, float scale, void* stream) {
  using namespace ctrlora;
  BwdParams p = make_params(q, k, v, dout, lse, delta, H, Sq, Sk, D, st, scale);
  p.dq = static_cast<bf16*>(dq);
  p.sdq = {st[12], st[13], st[14]};
  return static_cast<int>(dispatch<false>(p, B, static_cast<cudaStream_t>(stream)));
}

// st: (batch, sequence, head) strides of q, k, v, dout, dk, dv
extern "C" int ctrlora_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int Sq, int Sk,
                                     int D, const long long* st, float scale, void* stream) {
  using namespace ctrlora;
  BwdParams p = make_params(q, k, v, dout, lse, delta, H, Sq, Sk, D, st, scale);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sdk = {st[12], st[13], st[14]};
  p.sdv = {st[15], st[16], st[17]};
  return static_cast<int>(dispatch<true>(p, B, static_cast<cudaStream_t>(stream)));
}
