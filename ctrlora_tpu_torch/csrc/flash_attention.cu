// Flash-attention forward for Hopper (sm_90a): wgmma on TMA-loaded tiles,
// bf16 in and out, fp32 softmax.
//
// Replaces the TPU kernels ctrlora_tpu/ops/flash_attention.py
// `_fwd_kernel_packed_qkv` :304 (the packed q|k|v self-attention of the UNet
// and ControlNet), `_fwd_kernel_packed` :138 (separate [B, S, H, D] q, k, v:
// the LoRA control branch) and `_fwd_kernel` :58 (the VAE's [B, H, S, D]
// single-head attention). One C entry serves all three: it takes (batch,
// sequence, head) strides for q, k, v and out and encodes a 4-D TMA tensor
// map {D, H, S, B} over each strided view, so the packed view (row stride
// 3*H*D, k at +H*D, v at +2*H*D) and the [B, H, S, D] view need no copies.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the two products,
// 4*B*H*Sq*Sk*D flops, against q, k, v and out read or written once.
// * [8, 4096, 3*8*40] (the 64x64 UNet sites): 171.8 GFLOP, 0.174 ms at the
//   tensor-core peak; 85 MB, 0.025 ms at the memory rate. The exp2 of every
//   logit is a ceiling of its own: 8*8*4096^2 = 1.07e9 per call, at ~3.7e12
//   MUFU ex2/s (16 a clock on each of 132 SMs) about 0.29 ms, above the
//   tensor-core bound. Evaluating a share of them by polynomial on the FMA
//   pipes (FlashAttention-3's trick) is not done.
// * [4, 1, 4096, 512] (the VAE at 512^2): 137.4 GFLOP, 0.139 ms.
//
// Two kernels, chosen by head dim. Both have consumer warpgroups and a
// producer warpgroup that hands its registers to them (setmaxnreg). The
// producer's one thread streams K/V tiles into a ring of shared-memory
// stages with TMA; each stage's `full` mbarrier completes on the bytes that
// arrived, and its `empty` mbarrier on all consumer threads being done with
// it. So loads run under the products, and the
// consumers spend no registers or instructions on them. S = Q K^T is a
// wgmma with both operands K-major in shared memory. O += P V is a wgmma
// with P in registers (the S accumulator rounded to bf16, the RS form) and V
// read MN-major through the descriptor's transpose bit: V is never
// transposed by hand. Tiles are boxes of 64 columns with the 128B swizzle.
//
// * D <= 160 (`flash_fwd_wgmma`, D = 40/80/160 at the UNet/ControlNet sites,
//   8/16/32 at ControlNet-XS's 0.2x control stream; 64 and 128 also build).
//   Each consumer warpgroup owns 64 query rows and
//   keeps their logits, probabilities and output accumulator in registers:
//   three consumers at 160 registers a thread where that fits (D <= 64: BQ
//   = 192, so each K/V tile serves more rows), else two at 240 (BQ = 128).
//   BK = 128 keys a tile (64 at D = 160: shared memory), 2-4 stages. Within
//   a warpgroup the exp2s of tile j run while tile j-1's PV product is in
//   flight; across warpgroups the scheduler interleaves one's softmax with
//   another's products. Making the warpgroups take turns on the tensor cores
//   (FlashAttention-3's ping-pong, by named barriers) was tried and cost
//   20% at D = 40: the small-N products then queue behind each other.
//   D = 40 is the awkward width: its 80-byte rows fit no swizzle atom and
//   the k-step is 16. Q arrives in a 64-column box whose columns past D read
//   as zeros (the tensor map's innermost size is D, not the row pitch, so
//   the next head's values never enter); K and V arrive in boxes only D % 64
//   columns wide, which TMA writes into the 128-byte rows and which leave the
//   rest of each row alone: the pad columns are zeroed once per block (a
//   64-column box filled past D took the loads twice as long). The QK
//   product runs over 48 columns (Q's zeros cancel the pad). The PV
//   product's N is D + 8: column D of V holds ones, written once per block,
//   so column D of O is the row sum of the bf16 P; the CUDA cores do no row
//   sums.
//   D = 8/16/32 (rows of 16, 32 and 64 bytes, no full box) take the same
//   path: K and V arrive in one tail box of D columns, Q in a 64-column box
//   of zeros past D, and the QK product runs over D rounded up to the
//   16-wide k-step (16 at D = 8) against zeros; no k-step or box reaches past
//   D into the next head's q/k/v columns of the fused projection, because
//   every tensor map's innermost size is D.
// * D = 512 (`flash_fwd_wide`, the VAE). A 64 x 512 fp32 accumulator does
//   not fit one warpgroup's registers, so the output is split by D: both
//   consumer warpgroups own the block's 64 query rows and one 256-wide half
//   of O each (128 registers a thread). Each computes the partial S over its
//   half of D; the two 64 x 32 partials are summed through shared memory
//   (a + b in one, b + a in the other: the same bits), both run the same
//   softmax and each runs P V over its V half. Q stays resident (64 KB), K/V
//   tiles of 32 keys in 2 stages (128 KB), the S exchange double-buffered
//   (32 KB): 224 KB, one block an SM.
//
// Where the D = 40 kernel stands: `python3 -m ctrlora_tpu_torch.tools.
// ablate_flash` times it with its loads, products or softmax cut out; each
// part alone takes a large share of the whole, and they overlap only in
// part (PERF.md has the numbers).
//
// The old kernels (mma.sync fragments loaded synchronously through
// registers with a hand transpose of V; WMMA with a shared-memory fp32
// accumulator at D = 512) are gone; PERF.md keeps their times.
//
// Numerics, as the plain versions hold them: the exact running-max online
// softmax (the JAX package's `safemax` variant), P rounded to bf16 before the
// PV product, the row sum taken over the rounded P, and the fp32 natural-log
// logsumexp [B, H, Sq] that the backward kernels read. Shapes the kernels do
// not take (Sq or Sk not a multiple of the tile, other head dims) are
// refused with cudaErrorInvalidValue; the wrapper checks them first.

#include "common.cuh"
#include "hopper.cuh"

namespace ctrlora {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int W = 64;                           // box width: 128-byte rows, 128B swizzle
constexpr int kBarExchange = 1;  // the named barrier of the D = 512 S exchange

// Thread 0 initialises the barriers: q_full, then full[] and empty[] of
// the ST stages (empty[] completes on the `consumers` threads' arrivals).
template <int ST>
__device__ __forceinline__ void init_barriers(uint64_t* bars, int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + ST + s], consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer's loop: Q once (NQ boxes of W columns, zero past D), then
// the K and V tiles of every key block into the ring of ST stages, whose K
// and V parts are NK and NV boxes wide. Columns [0, D) arrive as D / W full
// boxes (maps tk, tv) and a tail box of D % W columns (maps tkt, tvt), which
// leaves the rest of the tail box as it was.
template <int NQ, int NK, int NV, int BQ, int BK, int ST, int D>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* bars, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tkt,
                                        const CUtensorMap* tv, const CUtensorMap* tvt, int h,
                                        int b, int q0, int nt) {
  constexpr int BOX_Q = BQ * W * 2, BOX_KV = BK * W * 2;
  constexpr int STAGE = (NK + NV) * BOX_KV, NFULL = D / W, TAIL = D % W;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  mbar_expect_tx(bars, NQ * BOX_Q);
  for (int i = 0; i < NQ; ++i) tma_load_4d(smem + i * BOX_Q, tq, bars, i * W, h, q0, b);
  for (int j = 0; j < nt; ++j) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * BK * D * 2);
    unsigned char* kbuf = smem + NQ * BOX_Q + s * STAGE;
    unsigned char* vbuf = kbuf + NK * BOX_KV;
    for (int i = 0; i < NFULL; ++i) {
      tma_load_4d(kbuf + i * BOX_KV, tk, &full[s], i * W, h, j * BK, b);
      tma_load_4d(vbuf + i * BOX_KV, tv, &full[s], i * W, h, j * BK, b);
    }
    if (TAIL) {
      tma_load_4d(kbuf + NFULL * BOX_KV, tkt, &full[s], NFULL * W, h, j * BK, b);
      tma_load_4d(vbuf + NFULL * BOX_KV, tvt, &full[s], NFULL * W, h, j * BK, b);
    }
  }
}

// Online softmax over one tile of a warpgroup's 64 rows, in two halves so
// that the first can run while the previous tile's PV product is in flight.
// s: the logits in the accumulator layout (BK/2 values: rows g and g+8 of
// this warp's 16, 2*BK/8 columns each); m: the running max per row (log2
// units). softmax_exp replaces s by exp2(s*scale - m_new) and returns the
// rescale factors exp2(m_old - m_new); softmax_pack rounds them to bf16 as
// the RS A fragments of the BK/16 k-steps and rescales the output
// accumulator, and with CORE_SUM adds the rounded values to this thread's
// partial row sums l (rescaled too).
template <int BK>
__device__ __forceinline__ void softmax_exp(float (&s)[BK / 2], float (&m)[2], float (&alpha)[2],
                                            float scale_log2) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {  // four chains a row, not one
    mx[0][i % 4] = fmaxf(mx[0][i % 4], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1][i % 4] = fmaxf(mx[1][i % 4], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[r], v * scale_log2);  // finite: every key is valid
    alpha[r] = fast_exp2(m[r] - mn);                 // 0 on the first tile
    m[r] = mn;
    neg[r] = -mn;
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], scale_log2, neg[e / 2]));
  }
}

template <int BK, bool CORE_SUM, int NO>
__device__ __forceinline__ void softmax_pack(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4],
                                             float (&o)[NO], float (&l)[2],
                                             const float (&alpha)[2]) {
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
        p[kk][2 * half + r] = as_u32(pr);
        if (CORE_SUM) sum[r] += __low2float(pr) + __high2float(pr);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
  if (CORE_SUM) {
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  }
}

// Normalise by the row sums l and store a warpgroup's 64 x 2*NO output
// columns starting at column c0 (columns at or past D are dropped), and
// the rows' lse.
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO], const float (&l)[2],
                                           const float (&m)[2], bf16* obase, long long os,
                                           float* lse_row, int row0, int c0, int D, int Sq,
                                           bool write_lse) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w = (threadIdx.x / 32) % 4;
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int rows[2] = {row0 + 16 * w + g, row0 + 16 * w + g + 8};
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    const int c = c0 + 8 * i + 2 * t;
    if (c < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Sq)
          *reinterpret_cast<__nv_bfloat162*>(obase + (long long)rows[r] * os + c) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  if (write_lse && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < Sq) lse_row[rows[r]] = (m[r] + log2f(l[r])) / kLog2e;
  }
}

// ---------------------------------------------------------------------------
// D <= 160: D = 8, 16, 32, 40, 64, 80, 128, 160
// ---------------------------------------------------------------------------

template <int D>
struct FwdCfg {
  // QK over DP = D rounded up to 16 columns (the k-step); PV over NPV = D + 8
  // columns, the first pad column of V holding ones, so that O's column D
  // is the row sum of the bf16 P
  static constexpr int DP = (D + 15) / 16 * 16, NPV = D + 8;
  // NC consumer warpgroups of 64 query rows and one producer warpgroup,
  // which keeps 24 registers a thread and hands the rest over: three
  // consumers at 160 registers where S, P and O fit them (D <= 64), else
  // two at 240. 128 keys a tile, 64 at D = 160 (shared memory).
  static constexpr int NC = D <= 64 ? 3 : 2, REGS = NC == 3 ? 160 : 240;
  static constexpr int CONSUMERS = NC * 128, THREADS = CONSUMERS + 128;
  static constexpr int BQ = 64 * NC, BK = D <= 128 ? 128 : 64;
  static constexpr int NQK = (DP + W - 1) / W, NV = (NPV + W - 1) / W;
  static constexpr int BOX_Q = BQ * W * 2;   // bytes of one Q box
  static constexpr int BOX_KV = BK * W * 2;  // ... of one K or V box
  static constexpr int Q_BYTES = NQK * BOX_Q;
  static constexpr int K_BYTES = NQK * BOX_KV;
  static constexpr int STAGE_BYTES = (NQK + NV) * BOX_KV;  // K then V
  static constexpr int FIT = (200 * 1024 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  // the ones column in the V tile: its box and 16-byte chunk
  static constexpr int ONES_BOX = D / W, ONES_CHUNK = (D % W) / 8;
  static_assert(D % 8 == 0 && STAGES >= 2, "tile shape");
  // setmaxnreg only moves registers the block got at launch (THREADS times
  // the per-thread count the launch bounds allow): more would wait forever
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert(CONSUMERS * REGS + 128 * 24 <= THREADS * LAUNCH_REGS, "register file");
};

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tkt, const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tvt, bf16* __restrict__ out,
                float* __restrict__ lse, int H, int Sq, int Sk, long long ob, long long os,
                long long oh, float scale_log2) {
  using C = FwdCfg<D>;
  constexpr int BK = C::BK, ST = C::STAGES, DP = C::DP, NPV = C::NPV, NC = C::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;  // the last block's rows past Sq read zeros, store nothing
  const int nt = Sk / BK;

  // The boxes TMA fills only in part (K's and V's tail, V's ones box) start
  // as zeros, with ones in V's column D: TMA never writes either again, so
  // the QK product meets zeros past D and column D of O is the row sum.
  if (threadIdx.x < C::CONSUMERS) {
    constexpr int CHUNKS = C::BOX_KV / 16, FIRST = D / W;
    for (int i = threadIdx.x; i < ST * (C::NQK + C::NV) * CHUNKS; i += C::CONSUMERS) {
      const int box = (i / CHUNKS) % (C::NQK + C::NV), c = i % CHUNKS;
      const bool v_box = box >= C::NQK;
      if ((v_box ? box - C::NQK : box) < FIRST) continue;
      const int row = c / 8, logical = (c % 8) ^ (row & 7);
      const bool ones = v_box && box - C::NQK == C::ONES_BOX && logical == C::ONES_CHUNK;
      reinterpret_cast<uint4*>(smem + C::Q_BYTES)[i] = make_uint4(ones ? 0x3F80u : 0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  init_barriers<ST>(bars, C::CONSUMERS);
  if (warp >= 4 * NC) {  // the producer warpgroup hands registers over
    regs_dec<24>();
    if (threadIdx.x == C::CONSUMERS)
      produce<C::NQK, C::NQK, C::NV, C::BQ, BK, ST, D>(smem, bars, &tq, &tk, &tkt, &tv, &tvt, h,
                                                        b, q0, nt);
    return;
  }
  regs_inc<C::REGS>();

  // consumer warpgroup cw owns query rows q0 + 64*cw .. +63
  const int cw = warp / 4;
  const uint32_t base = smem_u32(smem);
  const uint32_t q_rows = base + cw * 64 * W * 2;
  const uint32_t kv_base = base + C::Q_BYTES;
  float o[NPV / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t p[BK / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2], alpha[2];

  mbar_wait(bars, 0);
  // iteration j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}; the exp2s of
  // S_j run while the PV product is still in flight
  for (int j = 0; j <= nt; ++j) {
    gmma_fence();
    if (j < nt) {
      const int st = j % ST;
      mbar_wait(&full[st], (j / ST) & 1);
      const uint32_t kb = kv_base + st * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk * 16 / W) * C::BOX_Q + (kk * 16 % W) * 2;
        const uint32_t koff = (kk * 16 / W) * C::BOX_KV + (kk * 16 % W) * 2;
        Gmma<BK>::ss(s, gmma_desc(q_rows + off, 16), gmma_desc(kb + koff, 16), kk > 0);
      }
    }
    gmma_commit();
    if (j > 0) {
      const uint32_t vb = kv_base + ((j - 1) % ST) * C::STAGE_BYTES + C::K_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Gmma<NPV>::rs(o, p[kk], gmma_desc(vb + kk * 16 * W * 2, C::BOX_KV));
    }
    gmma_commit();
    if (j < nt) {
      gmma_wait<1>();  // S_j is ready
      fence_regs(s);
      softmax_exp<BK>(s, m, alpha, scale_log2);
    }
    gmma_wait<0>();
    fence_regs(o);
    if (j > 0) mbar_arrive(&empty[(j - 1) % ST]);
    if (j == nt) break;
    softmax_pack<BK, false>(s, p, o, l, alpha);
  }

  // column D of O is the row sum; the quad's first thread holds it
  const int lane0 = (threadIdx.x % 32) & ~3;
  l[0] = __shfl_sync(0xffffffffu, o[4 * (D / 8)], lane0);
  l[1] = __shfl_sync(0xffffffffu, o[4 * (D / 8) + 2], lane0);
  store_rows(o, l, m, out + b * ob + h * oh, os, lse + (long long)bh * Sq, q0 + 64 * cw, 0, D,
             Sq, true);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int H, int Sq, int Sk, const long long* st, float scale_log2,
                         cudaStream_t stream) {
  using C = FwdCfg<D>;
  constexpr int TAIL = D % W;
  if (Sk % C::BK != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tkt, tv, tvt;
  cudaError_t err = encode_bshd_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2], W, C::BQ);
  // the full-box maps where D >= W, the tail-box maps where D % W != 0
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    const void* base = i ? v : k;
    const long long* sv = st + 3 + 3 * i;
    CUtensorMap* full = i ? &tv : &tk;
    CUtensorMap* tail = i ? &tvt : &tkt;
    err = encode_bshd_map(full, base, B, Sk, H, D, sv[0], sv[1], sv[2], W, C::BK);
    if (err == cudaSuccess)
      err = encode_bshd_map(tail, base, B, Sk, H, D, sv[0], sv[1], sv[2], TAIL ? TAIL : W, C::BK);
  }
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_wgmma<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Sq + C::BQ - 1) / C::BQ, B * H), C::THREADS, C::BYTES, stream>>>(
      tq, tk, tkt, tv, tvt, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Sk, st[9],
      st[10], st[11], scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D = 512
// ---------------------------------------------------------------------------

struct WideCfg {
  static constexpr int D = 512, BQ = 64, BK = 32, NB = D / W, ST = 2;
  static constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
  static constexpr int HALF_BOXES = NB / 2;  // one warpgroup's 256 columns
  static constexpr int BOX_Q = BQ * W * 2;   // 8 KB
  static constexpr int BOX_KV = BK * W * 2;  // 4 KB
  static constexpr int Q_BYTES = NB * BOX_Q;
  static constexpr int KV_BYTES = NB * BOX_KV;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int X_OFF = Q_BYTES + ST * STAGE_BYTES;
  static constexpr int X_FLOATS = (BK / 2) * 128;  // one warpgroup's partial S
  static constexpr int BAR_OFF = X_OFF + 2 * 2 * X_FLOATS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * ST) + 1024;
  static_assert(BYTES <= 232448, "shared memory");
};

__global__ void __launch_bounds__(WideCfg::THREADS, 1)
flash_fwd_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
               float* __restrict__ lse, int H, int Sq, int Sk, long long ob, long long os,
               long long oh, float scale_log2) {
  using C = WideCfg;
  constexpr int BK = C::BK, ST = C::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(smem + C::X_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + ST;
  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int nt = Sk / BK;

  init_barriers<ST>(bars, C::CONSUMERS);
  if (warp >= 8) {  // the producer warpgroup hands registers over
    regs_dec<40>();
    if (threadIdx.x == C::CONSUMERS)
      produce<C::NB, C::NB, C::NB, C::BQ, BK, ST, C::D>(smem, bars, &tq, &tk, &tk, &tv, &tv, h, b,
                                                         q0, nt);
    return;
  }
  regs_inc<232>();  // 128 x 40 + 256 x 232 <= 384 x 168, the launch allocation

  // consumer warpgroup cw owns output columns 256*cw .. +255 of all 64 rows
  const int cw = warp / 4;
  const int ct = threadIdx.x % 128;
  const uint32_t base = smem_u32(smem);
  const uint32_t q_half = base + cw * C::HALF_BOXES * C::BOX_Q;
  const uint32_t kv_base = base + C::Q_BYTES;
  float o[128], s[BK / 2];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t p[BK / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bars, 0);
  for (int j = 0; j <= nt; ++j) {
    gmma_fence();
    if (j < nt) {
      const int st = j % ST;
      mbar_wait(&full[st], (j / ST) & 1);
      const uint32_t kb = kv_base + st * C::STAGE_BYTES + cw * C::HALF_BOXES * C::BOX_KV;
#pragma unroll
      for (int kk = 0; kk < 256 / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // within the 64-wide box
        Gmma<BK>::ss(s, gmma_desc(q_half + (kk / 4) * C::BOX_Q + off, 16),
                     gmma_desc(kb + (kk / 4) * C::BOX_KV + off, 16), kk > 0);
      }
    }
    if (j > 0) {
      const uint32_t vb = kv_base + ((j - 1) % ST) * C::STAGE_BYTES + C::KV_BYTES +
                          cw * C::HALF_BOXES * C::BOX_KV;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Gmma<256>::rs(o, p[kk], gmma_desc(vb + kk * 16 * W * 2, C::BOX_KV));
    }
    gmma_commit();
    gmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    if (j > 0) mbar_arrive(&empty[(j - 1) % ST]);
    if (j == nt) break;
    // the full S: this half's partial plus the other warpgroup's
    float* mine = xbuf + ((j & 1) * 2 + cw) * C::X_FLOATS;
    const float* theirs = xbuf + ((j & 1) * 2 + 1 - cw) * C::X_FLOATS;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mine[i * 128 + ct] = s[i];
    named_sync(kBarExchange, C::CONSUMERS);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] += theirs[i * 128 + ct];
    float alpha[2];
    softmax_exp<BK>(s, m, alpha, scale_log2);
    softmax_pack<BK, true>(s, p, o, l, alpha);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows(o, l, m, out + b * ob + h * oh, os, lse + (long long)bh * Sq, q0, 256 * cw,
             C::D, Sq, cw == 0);
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                        int H, int Sq, int Sk, const long long* st, float scale_log2,
                        cudaStream_t stream) {
  using C = WideCfg;
  if (Sq % C::BQ != 0 || Sk % C::BK != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bshd_map(&tq, q, B, Sq, H, C::D, st[0], st[1], st[2], W, C::BQ);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tk, k, B, Sk, H, C::D, st[3], st[4], st[5], W, C::BK);
  if (err == cudaSuccess)
    err = encode_bshd_map(&tv, v, B, Sk, H, C::D, st[6], st[7], st[8], W, C::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
  if (err != cudaSuccess) return err;
  flash_fwd_wide<<<dim3(Sq / C::BQ, B * H), C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Sk, st[9], st[10],
      st[11], scale_log2);
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
  if (D == 8) {
    err = launch_wgmma<8>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 16) {
    err = launch_wgmma<16>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 32) {
    err = launch_wgmma<32>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 40) {
    err = launch_wgmma<40>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 64) {
    err = launch_wgmma<64>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 80) {
    err = launch_wgmma<80>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 128) {
    err = launch_wgmma<128>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 160) {
    err = launch_wgmma<160>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else if (D == 512) {
    err = launch_wide(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
