// Flash-attention backward for Hopper (sm_90a): wgmma on TMA-loaded tiles,
// bf16 operands, fp32 accumulators, no atomics.
//
// Replaces the TPU kernels ctrlora_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` :622 and `_bwd_dkv_kernel` :651 (driven by
// `_flash_backward` :690), with their FlashAttention-2 split: the dK/dV
// kernel owns a block of keys and walks every query tile, the dQ kernel owns
// a block of queries and walks every key tile. Each output is written once
// by the block that owns it, so neither kernel needs atomics and both give
// the same bits from run to run. P is recomputed from the forward's
// natural-log logsumexp (times log2 e, exp2 domain, as the forward and the
// JAX package do); Delta = rowsum(dO*O) comes in precomputed in fp32.
//
//   dV = P^T dO        dK = scale * dS^T Q        dQ = scale * dS K
//   P  = exp2(scale*log2e * Q K^T - lse*log2e)    dS = P * (dO V^T - Delta)
//
// P and dS are rounded to bf16 before the products that consume them (the
// tensor cores take bf16), which bounds the agreement with an fp32 version to
// bf16 rounding summed over the key (or query) axis. dQ and dK are scaled
// once, at the end.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the split does
// seven S x S x D products per head (QK^T and dO V^T once in each kernel,
// plus dV, dK and dQ) against a few S x D operands: 6 and 8 * B*H*S^2*D
// flops, 0.130 and 0.174 ms at [4, 8, 4096, 40], far above the memory time.
// The exp2 of every recomputed probability (2 * B*H*S^2 per call pair, 1.07e9
// at that shape each kernel) is a ceiling of its own on the MUFU pipe, as in
// the forward.
//
// Design (one kernel template, `flash_bwd<D, DKV>`, for both): a block has
// two consumer warpgroups and one producer warpgroup that hands its registers
// to them (setmaxnreg). The producer's one thread loads the block's own rows
// (K and V for dK/dV; Q and dO for dQ) once, then keeps a ring of streamed
// tiles (Q and dO with their lse and Delta rows; K and V) in flight with TMA
// on full/empty mbarriers. Per streamed tile a consumer warpgroup runs
//   X1 Y1^T and X2 Y2^T by wgmma, both operands K-major in shared memory
//     (dK/dV: S^T = K Q^T and dP^T = V dO^T; dQ: S = Q K^T and dP = dO V^T),
//   P and dS in registers (fp32, in place of the two accumulators),
//   accP += P Y2 and accS += dS Y1 by wgmma with A from registers (the
//     accumulator layout of S rounded to bf16, as the forward feeds P) and B
//     read MN-major from the same TMA tile through the descriptor's
//     transpose bit (dV += P^T dO, dK += dS^T Q; dQ += dS K): no operand is
//     ever transposed by hand.
// S and dP live in two register buffers: tile j+1's first products are
// issued before tile j's exp2s run, so a warpgroup keeps a product queued
// on the tensor cores while its MUFU and FMA work runs; across the two
// warpgroups the scheduler interleaves them. (With one buffer the two
// warpgroups fell into step on the shared stage and the products, the
// exp2s and the loads added up: PERF.md has the ablation.)
//
// Tiles are boxes of 64 columns with the 128B swizzle. The owned rows arrive
// in 64-column boxes whose columns past D read as zeros; the streamed tiles
// in D / 64 full boxes and a tail box of D % 64 columns, which TMA writes
// into 128-byte rows and which leaves the rest alone: the tail boxes are
// zeroed once per block (a 64-column box filled past D doubles the streamed
// bytes, as the forward found). The contraction over D pads only to 48 /
// 80 / 160; the N = D products use m64n40 / n80 / n160 wgmma directly.
//
// Head dims 40, 80 and 160 (the finetune step's three sites). The register
// budget is what shapes them: a consumer thread holds dK and dV for its
// warpgroup's 64 rows as D/2 + D/2 fp32 accumulators, beside two buffers of
// S^T and dP^T (T/2 each) and their bf16 fragments. Up to D = 80 each
// warpgroup owns 64 keys (128 a block) and both products; at D = 160 that
// is 160 registers of accumulators alone, so the two warpgroups share one
// block of 64 keys and split the work: one recomputes S^T and accumulates
// dV, the other computes S^T and dP^T and accumulates dK (measured against
// the unsplit kernel, which spills: PERF.md). The streamed tile T is 64
// rows where the buffers fit beside the accumulators, else 32 (BwdCfg
// below). Sequences must tile: Sq and Sk multiples of 128.

#include "common.cuh"
#include "hopper.cuh"

namespace ctrlora {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int W = 64;  // box width: 128-byte rows, 128B swizzle

struct Strides {
  long long b, s, h;  // batch, sequence, head (elements)
};

// The tiling of one kernel (DKV: dK/dV, else dQ) at head dim D; the Python
// mirror is ops/flash_attention.py `flash_bwd_plan`, and
// ctrlora_flash_bwd_config reports these numbers for it to be checked.
template <int D, bool DKV>
struct BwdCfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // the contraction over D
  static constexpr int NB = (D + W - 1) / W;     // 64-column boxes of a tile
  static constexpr int NFULL = D / W, TAIL = D % W;
  static constexpr bool SPLIT = DKV && D > 128;  // dV and dK on separate warpgroups
  static constexpr int ROWS = SPLIT ? 64 : 128;  // rows a block owns
  // rows of a streamed tile: what two buffers of S and dP leave room for
  // beside the accumulators (dK/dV hold two: 64 rows only at D = 40)
  static constexpr int T = (DKV ? D <= 40 : D <= 80) ? 64 : 32;
  // dQ's owned rows (Q, dO) as the A operand of the first products from
  // registers (the DP/16 k-steps' fragments, loaded once), halving their
  // shared-memory reads; dK/dV has no registers to spare for it
  static constexpr bool A_REGS = !DKV && DP / 16 <= 3;
  static_assert(128 % (2 * T) == 0, "an even number of streamed tiles");
  static constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128, REGS = 240;
  static constexpr int BOX_R = ROWS * W * 2;  // bytes of one box of owned rows
  static constexpr int BOX_T = T * W * 2;     // ... of one streamed box
  static constexpr int RES_BYTES = 2 * NB * BOX_R;   // X1 then X2
  static constexpr int TILE_BYTES = 2 * NB * BOX_T;  // one stage: Y1 then Y2
  static constexpr int FIT = (200 * 1024 - RES_BYTES) / TILE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int VEC_OFF = RES_BYTES + STAGES * TILE_BYTES;
  static constexpr int VEC_BYTES = DKV ? 2 * T * 4 : 0;  // a tile's lse and Delta
  static constexpr int BAR_OFF = VEC_OFF + STAGES * VEC_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert(CONSUMERS * REGS + 128 * 24 <= THREADS * LAUNCH_REGS, "register file");
  // a consumer waits for tile j+1 before it frees tile j-1's stage
  static_assert(D % 8 == 0 && STAGES >= 3 && BYTES <= 232448, "tile shape");
};

struct BwdArgs {
  const float* lse;    // [B*H, Sq] natural log
  const float* delta;  // [B*H, Sq]
  bf16* out_s;         // dK or dQ: the dS product, scaled
  bf16* out_p;         // dV: the P product (dK/dV only)
  Strides sos, sop;
  int H, Sq, Sk;
  float scale, scale_log2;
};

// The producer's loop: the block's X1 and X2 rows once (NB boxes each, zero
// past D), then Y1 and Y2 of every streamed tile into the ring, with the
// tile's lse and Delta rows where DKV.
template <int D, bool DKV>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* bars, const CUtensorMap* tx1,
                                        const CUtensorMap* tx2, const CUtensorMap* ty1,
                                        const CUtensorMap* ty1t, const CUtensorMap* ty2,
                                        const CUtensorMap* ty2t, const float* lse,
                                        const float* delta, int h, int b, int r0, int nt) {
  using C = BwdCfg<D, DKV>;
  constexpr int T = C::T, ST = C::STAGES, NB = C::NB;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  mbar_expect_tx(bars, C::RES_BYTES);
  for (int i = 0; i < NB; ++i) {
    tma_load_4d(smem + i * C::BOX_R, tx1, bars, i * W, h, r0, b);
    tma_load_4d(smem + (NB + i) * C::BOX_R, tx2, bars, i * W, h, r0, b);
  }
  for (int j = 0; j < nt; ++j) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * T * D * 2 + C::VEC_BYTES);
    unsigned char* y = smem + C::RES_BYTES + s * C::TILE_BYTES;
    for (int i = 0; i < C::NFULL; ++i) {
      tma_load_4d(y + i * C::BOX_T, ty1, &full[s], i * W, h, j * T, b);
      tma_load_4d(y + (NB + i) * C::BOX_T, ty2, &full[s], i * W, h, j * T, b);
    }
    if (C::TAIL) {
      tma_load_4d(y + C::NFULL * C::BOX_T, ty1t, &full[s], C::NFULL * W, h, j * T, b);
      tma_load_4d(y + (NB + C::NFULL) * C::BOX_T, ty2t, &full[s], C::NFULL * W, h, j * T, b);
    }
    if (DKV) {
      float* vec = reinterpret_cast<float*>(smem + C::VEC_OFF + s * C::VEC_BYTES);
      bulk_load(vec, lse + j * T, T * 4, &full[s]);
      bulk_load(vec + T, delta + j * T, T * 4, &full[s]);
    }
  }
}

// Store a warpgroup's 64 x D accumulator (times `mul`) at rows row0 ..
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* base, long long rs,
                                           int row0, float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, w = (threadIdx.x / 32) % 4;
  bf16* r[2] = {base + (long long)(row0 + 16 * w + g) * rs,
                base + (long long)(row0 + 16 * w + g + 8) * rs};
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<__nv_bfloat162*>(r[e] + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e] * mul, acc[4 * i + 2 * e + 1] * mul);
}

// The A fragments (the m16n8k16 layout in each warp's 16 rows) of the
// DP/16 k-steps of a warpgroup's 64 owned rows, from the 128B-swizzled
// boxes at x (rows row_off ..): chunk c of row r sits at chunk c ^ (r % 8).
template <int KS>
__device__ __forceinline__ void load_frags(uint32_t (&f)[KS][4], const unsigned char* x,
                                           int box_bytes, int row_off) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, w = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row_off + 16 * w + g + (q & 1) * 8;
      const int col = kk * 16 + 2 * t + (q & 2) * 4;
      const int c = col % W;
      f[kk][q] = *reinterpret_cast<const uint32_t*>(
          x + (col / W) * box_bytes + row * W * 2 + (((c / 8) ^ (row % 8)) * 16) + (c % 8) * 2);
    }
}

// The first two products of a streamed tile (stage address y): s = X1 Y1^T
// and, where dS is needed, dp = X2 Y2^T, over the DP columns of D; X1 and
// X2 from shared memory at x1, x2, or from the fragments a1, a2 (A_REGS).
template <int D, bool DKV, bool S_PROD>
__device__ __forceinline__ void issue_first(float (&s)[BwdCfg<D, DKV>::T / 2],
                                            float (&dp)[S_PROD ? BwdCfg<D, DKV>::T / 2 : 1],
                                            uint32_t x1, uint32_t x2,
                                            const uint32_t (&a1)[BwdCfg<D, DKV>::DP / 16][4],
                                            const uint32_t (&a2)[BwdCfg<D, DKV>::DP / 16][4],
                                            uint32_t y) {
  using C = BwdCfg<D, DKV>;
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint32_t off_r = (kk * 16 / W) * C::BOX_R + (kk * 16 % W) * 2;
    const uint32_t off_t = (kk * 16 / W) * C::BOX_T + (kk * 16 % W) * 2;
    const uint64_t b1 = gmma_desc(y + off_t, 16), b2 = gmma_desc(y + C::NB * C::BOX_T + off_t, 16);
    if constexpr (C::A_REGS) {
      Gmma<C::T>::rs_k(s, a1[kk], b1, kk > 0);
      if constexpr (S_PROD) Gmma<C::T>::rs_k(dp, a2[kk], b2, kk > 0);
    } else {
      Gmma<C::T>::ss(s, gmma_desc(x1 + off_r, 16), b1, kk > 0);
      if constexpr (S_PROD) Gmma<C::T>::ss(dp, gmma_desc(x2 + off_r, 16), b2, kk > 0);
    }
  }
}

// P = exp2(s * scale log2 e - lse log2 e) and, where S_PROD, dS = P (dp -
// Delta), rounded to bf16 as the A fragments (pf, df) of the T/16 k-steps of
// the last products. DKV: lse and Delta by query column, from the stage's
// rows `vec`; dQ: by query row, lr and dr. s and dp are only read: a plain
// instruction that wrote a wgmma's accumulator registers would make ptxas
// serialise every wgmma of the kernel.
template <int T, bool DKV, bool P_PROD, bool S_PROD>
__device__ __forceinline__ void p_ds_frags(const float (&s)[T / 2],
                                           const float (&dp)[S_PROD ? T / 2 : 1],
                                           const float* vec, const float (&lr)[2],
                                           const float (&dr)[2], float sl2,
                                           uint32_t (&pf)[T / 16][4], uint32_t (&df)[T / 16][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < T / 8; ++i) {  // 8-column group i: k-step i / 2, half i % 2
    float l[2], dl[2];  // by column parity (DKV: query columns 8i + 2t, +1)
    if constexpr (DKV) {
      const float2 lv = *reinterpret_cast<const float2*>(vec + 8 * i + 2 * t);
      l[0] = lv.x * kLog2e;
      l[1] = lv.y * kLog2e;
      if constexpr (S_PROD) {
        const float2 dv = *reinterpret_cast<const float2*>(vec + T + 8 * i + 2 * t);
        dl[0] = dv.x;
        dl[1] = dv.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g and g + 8: elements 4i + 2r, +1
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * r + c;
        const float le = DKV ? l[c] : lr[r];  // dQ: by row
        p[c] = fast_exp2(fmaf(s[e], sl2, -le));
        if constexpr (S_PROD) ds[c] = p[c] * (dp[e] - (DKV ? dl[c] : dr[r]));
      }
      if constexpr (P_PROD) pf[i / 2][2 * (i % 2) + r] = as_u32(__floats2bfloat162_rn(p[0], p[1]));
      if constexpr (S_PROD) df[i / 2][2 * (i % 2) + r] = as_u32(__floats2bfloat162_rn(ds[0], ds[1]));
    }
  }
}

// One consumer warpgroup over rows row_off .. +63 of the block's (block
// rows from r0): P_PROD accumulates accP += P Y2 (dV), S_PROD accS += dS Y1
// (dK or dQ); dS needs the second product X2 Y2^T.
//
// Two buffers of s and dp: iteration j issues tile j+1's first products,
// runs tile j's exp2s while they are in flight, then issues tile j's last
// products. The tensor pipe always has a product queued, and a warpgroup
// waits only for its own previous tile.
template <int D, bool DKV, bool P_PROD, bool S_PROD>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* bars, const BwdArgs& a,
                                        const float* lse, const float* delta, int b, int h,
                                        int r0, int row_off, int nt) {
  using C = BwdCfg<D, DKV>;
  constexpr int T = C::T, ST = C::STAGES, NB = C::NB;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, w = (threadIdx.x / 32) % 4;
  const uint32_t base = smem_u32(smem);
  const uint32_t x1 = base + row_off * W * 2;
  const uint32_t x2 = x1 + NB * C::BOX_R;
  const uint32_t ybase = base + C::RES_BYTES;
  const float sl2 = a.scale_log2;

  float s[2][T / 2], dp[2][S_PROD ? T / 2 : 1];
  float acc_p[P_PROD ? D / 2 : 1], acc_s[S_PROD ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (P_PROD ? D / 2 : 1); ++i) acc_p[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (S_PROD ? D / 2 : 1); ++i) acc_s[i] = 0.f;
  uint32_t pf[T / 16][4], df[T / 16][4];

  // dQ: lse * log2 e and Delta of this thread's two query rows
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + row_off + 16 * w + g + 8 * e;
      lr[e] = lse[row] * kLog2e;
      dr[e] = delta[row];
    }
  }

  mbar_wait(bars, 0);
  uint32_t a1[C::DP / 16][4], a2[C::DP / 16][4];
  if constexpr (C::A_REGS) {
    load_frags(a1, smem, C::BOX_R, row_off);
    if constexpr (S_PROD) load_frags(a2, smem + NB * C::BOX_R, C::BOX_R, row_off);
  }
  // a batch's operands are fenced before its wgmma.fence and after its
  // commit, so that no copy the compiler makes of them lands inside it
  auto fence_first = [&](int u) {
    fence_regs(s[u]);
    if constexpr (S_PROD) fence_regs(dp[u]);
    if constexpr (C::A_REGS) {
      fence_regs(a1);
      if constexpr (S_PROD) fence_regs(a2);
    }
  };
  auto fence_last = [&]() {
    if constexpr (P_PROD) {
      fence_regs(acc_p);
      fence_regs(pf);
    }
    if constexpr (S_PROD) {
      fence_regs(acc_s);
      fence_regs(df);
    }
  };
  mbar_wait(&full[0], 0);
  fence_last();  // the accumulators' zeros are written before any wgmma is issued
  fence_first(0);
  gmma_fence();
  issue_first<D, DKV, S_PROD>(s[0], dp[0], x1, x2, a1, a2, ybase);
  gmma_commit();
  fence_first(0);
  gmma_commit();  // an empty group in place of tile -1's last products
  // nt >= 2 and even (the sequences tile by 128 = 2T or 4T): no path skips
  // the loop, so no copy of the accumulators lands inside the prologue's batch
  int j0 = 0;
#pragma unroll 1
  do {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u;
      if (j + 1 < nt) {
        const int sn = (j + 1) % ST;
        mbar_wait(&full[sn], ((j + 1) / ST) & 1);
        fence_first(u ^ 1);
        gmma_fence();
        issue_first<D, DKV, S_PROD>(s[u ^ 1], dp[u ^ 1], x1, x2, a1, a2,
                                    ybase + sn * C::TILE_BYTES);
      }
      gmma_commit();
      fence_first(u ^ 1);
      // tile j's first products and tile j-1's last products are done: tile
      // j-1's stage and the fragments are free
      gmma_wait<1>();
      fence_first(u);
      fence_last();
      if (j > 0) mbar_arrive(&empty[(j - 1) % ST]);
      const int st = j % ST;
      p_ds_frags<T, DKV, P_PROD, S_PROD>(
          s[u], dp[u], reinterpret_cast<const float*>(smem + C::VEC_OFF + st * C::VEC_BYTES), lr,
          dr, sl2, pf, df);
      const uint32_t y = ybase + st * C::TILE_BYTES;
      fence_last();
      gmma_fence();
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        if constexpr (P_PROD)
          Gmma<D>::rs(acc_p, pf[kk], gmma_desc(y + NB * C::BOX_T + kk * 16 * W * 2, C::BOX_T));
        if constexpr (S_PROD)
          Gmma<D>::rs(acc_s, df[kk], gmma_desc(y + kk * 16 * W * 2, C::BOX_T));
      }
      gmma_commit();
      fence_last();
    }
    j0 += 2;
  } while (j0 < nt);
  gmma_wait<0>();
  fence_last();

  const int row0 = r0 + row_off;
  if constexpr (P_PROD)
    store_rows<D>(acc_p, a.out_p + b * a.sop.b + h * a.sop.h, a.sop.s, row0, 1.f);
  if constexpr (S_PROD)
    store_rows<D>(acc_s, a.out_s + b * a.sos.b + h * a.sos.h, a.sos.s, row0, a.scale);
}

template <int D, bool DKV>
__global__ void __launch_bounds__(BwdCfg<D, DKV>::THREADS, 1)
flash_bwd(const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap tx2,
          const __grid_constant__ CUtensorMap ty1, const __grid_constant__ CUtensorMap ty1t,
          const __grid_constant__ CUtensorMap ty2, const __grid_constant__ CUtensorMap ty2t,
          const BwdArgs a) {
  using C = BwdCfg<D, DKV>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  // the warpgroup index, warp-uniform as ptxas sees it (a shuffle from lane
  // 0): a role branch on it is not divergent, so ptxas keeps its wgmmas
  // pipelined (C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int r0 = blockIdx.x * C::ROWS;
  const int nt = (DKV ? a.Sq : a.Sk) / C::T;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  // The streamed tail boxes start as zeros: TMA writes only their D % 64
  // columns, so the products over 48 columns at D = 40 meet zeros past D.
  if (C::TAIL && threadIdx.x < C::CONSUMERS) {
    constexpr int CHUNKS = C::BOX_T / 16;
    for (int i = threadIdx.x; i < ST * 2 * CHUNKS; i += C::CONSUMERS) {
      const int stage = i / (2 * CHUNKS), y = (i / CHUNKS) % 2;
      unsigned char* box = smem + C::RES_BYTES + stage * C::TILE_BYTES +
                           (y * C::NB + C::NFULL) * C::BOX_T;
      reinterpret_cast<uint4*>(box)[i % CHUNKS] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {  // the owned rows, then full[] and empty[] of the ring
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + ST + s], C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {  // the producer warpgroup hands registers over
    regs_dec<24>();
    if (threadIdx.x == C::CONSUMERS)
      produce<D, DKV>(smem, bars, &tx1, &tx2, &ty1, &ty1t, &ty2, &ty2t, lse, delta, h, b, r0, nt);
    return;
  }
  regs_inc<C::REGS>();
  if (!DKV) {
    consume<D, false, false, true>(smem, bars, a, lse, delta, b, h, r0, 64 * wg, nt);
  } else if (C::SPLIT) {  // both warpgroups on the same 64 keys
    if (wg == 0)
      consume<D, true, true, false>(smem, bars, a, lse, delta, b, h, r0, 0, nt);
    else
      consume<D, true, false, true>(smem, bars, a, lse, delta, b, h, r0, 0, nt);
  } else {
    consume<D, true, true, true>(smem, bars, a, lse, delta, b, h, r0, 64 * wg, nt);
  }
}

// the operands of one launch: X1, X2 the owned rows' tensors, Y1, Y2 the
// streamed ones, with their (batch, sequence, head) strides
struct Operand {
  const void* ptr;
  Strides st;
};

template <int D, bool DKV>
cudaError_t launch(const Operand (&x)[2], const Operand (&y)[2], const BwdArgs& a, int B,
                   cudaStream_t stream) {
  using C = BwdCfg<D, DKV>;
  const int n_own = DKV ? a.Sk : a.Sq, n_stream = DKV ? a.Sq : a.Sk;
  if (n_own % C::ROWS || n_stream % (2 * C::T) || n_own <= 0 || n_stream <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap tx[2], ty[2], tyt[2];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    const Strides& sx = x[i].st;
    const Strides& sy = y[i].st;
    err = encode_bshd_map(&tx[i], x[i].ptr, B, n_own, a.H, D, sx.b, sx.s, sx.h, W, C::ROWS);
    if (err == cudaSuccess)
      err = encode_bshd_map(&ty[i], y[i].ptr, B, n_stream, a.H, D, sy.b, sy.s, sy.h, W, C::T);
    if (err == cudaSuccess)
      err = encode_bshd_map(&tyt[i], y[i].ptr, B, n_stream, a.H, D, sy.b, sy.s, sy.h,
                            C::TAIL ? C::TAIL : W, C::T);
  }
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd<D, DKV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_own / C::ROWS, B * a.H), C::THREADS, C::BYTES, stream>>>(
      tx[0], tx[1], ty[0], tyt[0], ty[1], tyt[1], a);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch(int D, const Operand (&x)[2], const Operand (&y)[2], const BwdArgs& a, int B,
                     cudaStream_t s) {
  if (D == 40) return launch<40, DKV>(x, y, a, B, s);
  if (D == 80) return launch<80, DKV>(x, y, a, B, s);
  if (D == 160) return launch<160, DKV>(x, y, a, B, s);
  return cudaErrorInvalidValue;
}

template <int D, bool DKV>
void config(int* out) {
  using C = BwdCfg<D, DKV>;
  out[0] = C::ROWS;
  out[1] = C::T;
  out[2] = C::STAGES;
  out[3] = C::BYTES;
  out[4] = C::SPLIT;
}

BwdArgs make_args(const void* lse, const void* delta, int H, int Sq, int Sk, float scale) {
  BwdArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace
}  // namespace ctrlora

// st: (batch, sequence, head) strides of q, k, v, dout, dq
extern "C" int ctrlora_flash_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int H, int Sq, int Sk, int D,
                                    const long long* st, float scale, void* stream) {
  using namespace ctrlora;
  BwdArgs a = make_args(lse, delta, H, Sq, Sk, scale);
  a.out_s = static_cast<bf16*>(dq);
  a.sos = {st[12], st[13], st[14]};
  const Operand x[2] = {{q, {st[0], st[1], st[2]}}, {dout, {st[9], st[10], st[11]}}};
  const Operand y[2] = {{k, {st[3], st[4], st[5]}}, {v, {st[6], st[7], st[8]}}};
  return static_cast<int>(dispatch<false>(D, x, y, a, B, static_cast<cudaStream_t>(stream)));
}

// st: (batch, sequence, head) strides of q, k, v, dout, dk, dv
extern "C" int ctrlora_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int Sq, int Sk,
                                     int D, const long long* st, float scale, void* stream) {
  using namespace ctrlora;
  BwdArgs a = make_args(lse, delta, H, Sq, Sk, scale);
  a.out_s = static_cast<bf16*>(dk);
  a.out_p = static_cast<bf16*>(dv);
  a.sos = {st[12], st[13], st[14]};
  a.sop = {st[15], st[16], st[17]};
  const Operand x[2] = {{k, {st[3], st[4], st[5]}}, {v, {st[6], st[7], st[8]}}};
  const Operand y[2] = {{q, {st[0], st[1], st[2]}}, {dout, {st[9], st[10], st[11]}}};
  return static_cast<int>(dispatch<true>(D, x, y, a, B, static_cast<cudaStream_t>(stream)));
}

// the tiling of one kernel at head dim D: rows a block owns, rows of a
// streamed tile, ring stages, dynamic shared-memory bytes, and whether dK
// and dV are split over the warpgroups (dkv != 0: the dK/dV kernel)
extern "C" int ctrlora_flash_bwd_config(int D, int dkv, int* out) {
  using namespace ctrlora;
  if (D == 40) dkv ? config<40, true>(out) : config<40, false>(out);
  else if (D == 80) dkv ? config<80, true>(out) : config<80, false>(out);
  else if (D == 160) dkv ? config<160, true>(out) : config<160, false>(out);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
