// Head-pair flash-attention forward for Hopper (sm_90a), bf16 in and out:
// kernel B6 of the port, wgmma on TMA-loaded tiles.
//
// Replaces the TPU kernel ctrlora_tpu/ops/flash_attention.py
// `_fwd_kernel_hpack2` :224 and computes what it computes, not how: for the
// heads (2p, 2p+1) of a pair, the logits s2 = (q * scale * log2(e), rounded
// to bf16) . k^T in fp32; p = exp2(min(s2, 110)) with no running max and no
// rescale (the skip-max softmax with its overflow clamp: p <= 2^110 fits
// bf16, and l over 4096 keys stays below 2^122 in fp32); P rounded to bf16
// for the PV product, fp32 accumulation, the row sum l taken over the
// rounded P; out = PV / max(l, 1e-30) and the natural-log
// lse = log2(l) / log2(e), fp32 [B, H, Sq].
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at [8, 4096, 8,
// 40] the two products are 171.8 GFLOP, 0.174 ms at the tensor-core peak;
// the exp2 of every logit (1.07e9 a call, 16 a clock on each SM's MUFU
// pipe) about 0.29 ms, a ceiling above it. At ControlNet-XS's control
// stream (D = 8/16/32 at 64^2/32^2/16^2, [8, 4096, 8, 8] and smaller) the
// products shrink with D (34.4 GFLOP at D = 8, 0.035 ms) while the exp2s
// do not: MUFU and the key stream bound it there.
//
// The TPU kernel built block-diagonal K and V operands so that one product
// filled 80 of the MXU's 128 lanes instead of 40. On tensor cores those
// operands would only double the MMA work on zeros, so they are not built.
// Here the pair shares the TMA ring: each stage holds the key tile of BOTH
// heads (their K and V rows, four boxes), and the three consumer warpgroups
// split between the heads: warpgroup c of block x owns the 64-row query
// tile t = 3x + c of the pair's 2 * Sq / 64 (head t % 2, rows 64 (t / 2)),
// so one stage serves all three and one load of a key row's K (or V) reads
// the pair's adjacent 2 * D columns, 160 bytes at D = 40.
//
// The second head of a pair starts D columns (80 bytes at D = 40) into the
// pair's row, off the 128-byte swizzle atom, where no wgmma descriptor can
// start. So each head arrives in a box of its own D columns of the 4-D map
// {D, H, S, B}, written by TMA into 128-byte rows whose columns past D it
// never touches: those are zeroed once per block, and the QK product over
// 48 columns at D = 40 meets zeros there (q is zero past D too). (A 64-column
// box at column h * D would read the partner's columns as well: 1.6 times
// the bytes from L2, and PR 4 found a box filled past D twice as slow.)
//
// Design. A block is three consumer warpgroups and a producer warpgroup
// that hands its registers to them (setmaxnreg: 160 a consumer thread;
// four consumers would have ~112 and spill). The producer's one thread
// streams the stages through a ring of STAGES slots on full/empty
// mbarriers. A consumer warpgroup owns 64 query rows of one head and keeps
// their q as the register A operand of S = Q K^T (the RS
// form, K K-major from shared memory): q is pre-scaled by scale * log2(e)
// and rounded to bf16 once, in registers, as it is loaded. The skip-max
// softmax removes work, not only the max: no row-max reduction across the
// quad, no s - m FFMA, no rescale of O and l. A thread reads the S
// accumulator (never writes it: ptxas would serialise every wgmma, notes
// C7514/C7515) and packs P = exp2(min(S, 110)) straight into the bf16 A
// fragments of O += P V (V MN-major through the descriptor's transpose bit).
// The row sum of the rounded P comes from the tensor cores too: l += P 1,
// an m64n8 product against a 16-row tile of ones (every k-step reads the
// same tile), so every column of l holds the row's sum and the CUDA cores
// add nothing. P has two register buffers: tile j's exp2s run while tile
// j-1's PV product is in flight. Each batch's operands are fenced before
// its wgmma.fence and after its commit, and the role branch is on a
// warp-uniform index (a divergent one made ptxas serialise, C7520).
//
// Small head dims (D = 8/16/32) keep the same layout: each head's box of D
// columns lands in 128-byte rows (16, 32 or 64 bytes of data each), the QK
// contraction runs over DP = 16, 16 and 32 columns (k-steps 1, 1 and 2), and
// the PV product is m64n8, m64n16 or m64n32 beside the m64n8 row sum. A box
// of D columns under the 32B or 64B swizzle would cut the ring's shared
// memory, not its traffic from L2 (TMA reads D columns either way).
//
// The launcher takes (batch, sequence, head) strides of q, k, v and out, so
// the split views of a fused projection need no copy; Sq and Sk must be
// multiples of 128; H even; D = 8, 16, 32, 40 or 64.

#include "common.cuh"
#include "hopper.cuh"

namespace ctrlora {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int W = 64;  // box row: 128 bytes, 128B swizzle

// The tiling at head dim D; the Python mirror is ops/flash_attention.py
// `hpack2_plan`, and ctrlora_flash_hpack2_config reports these numbers for
// it to be checked.
template <int D>
struct Hp2Cfg {
  static constexpr int NC = 3;                 // consumer warpgroups
  static constexpr int CONSUMERS = NC * 128;   // threads
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
  static constexpr int REGS = 160;             // a consumer thread's registers
  static constexpr int BQ = 64;                // query rows of a warpgroup
  static constexpr int BK = 64;                // keys a tile
  static constexpr int DP = (D + 15) / 16 * 16;  // the QK contraction
  static constexpr int BOX = BK * W * 2;       // bytes of one head's K (or V) tile
  static constexpr int STAGE = 4 * BOX;        // K0, K1, V0, V1
  static constexpr int ONES = 16 * W * 2;      // 16 rows of ones
  static constexpr int FIT = (200 * 1024 - ONES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int ONES_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = ONES_OFF + ONES;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;  // + alignment slack
  static_assert((D == 8 || D == 16 || D == 32 || D == 40 || D == 64) && STAGES >= 3 &&
                    BYTES <= 232448,
                "tile shape");
  // setmaxnreg only moves registers the block got at launch
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static_assert(CONSUMERS * REGS + 128 * 24 <= THREADS * LAUNCH_REGS, "register file");
};

// pack p = exp2(min(s, 110)) as bf16 pairs into the A fragments of the
// BK/16 k-steps (s: the m64nBK accumulator, read only)
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 4 * (2 * kk + half) + 2 * r;
        p[kk][2 * half + r] = as_u32(__floats2bfloat162_rn(fast_exp2(fminf(s[e], 110.f)),
                                                           fast_exp2(fminf(s[e + 1], 110.f))));
      }
}

template <int D>
__global__ void __launch_bounds__(Hp2Cfg<D>::THREADS, 1)
flash_hpack2(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const bf16* __restrict__ q, bf16* __restrict__ out, float* __restrict__ lse, int H,
             int Sq, int Sk, long long qb, long long qs, long long qh, long long ob,
             long long os, long long oh, float scale_log2) {
  using C = Hp2Cfg<D>;
  constexpr int BK = C::BK, ST = C::STAGES, KS = C::DP / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + ST;
  const int pairs = H / 2;
  const int b = blockIdx.y / pairs, h0 = 2 * (blockIdx.y % pairs);
  const int nt = Sk / BK;
  // the warpgroup index, warp-uniform as ptxas sees it (a shuffle from lane
  // 0): a role branch on it is not divergent
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  // The ring starts as zeros (TMA never writes a box's columns past D
  // where D < 64), the ones tile as bf16 1.0
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < (C::ONES_OFF + C::ONES) / 16; i += C::THREADS)
      z[i] = i < C::ONES_OFF / 16 ? make_uint4(0u, 0u, 0u, 0u)
                                  : make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (cw == C::NC) {  // the producer warpgroup hands registers over
    regs_dec<24>();
    if (threadIdx.x == C::CONSUMERS) {
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 4 * BK * D * 2);
        unsigned char* st = smem + s * C::STAGE;
        for (int hh = 0; hh < 2; ++hh) {
          tma_load_4d(st + hh * C::BOX, &tk, &full[s], 0, h0 + hh, j * BK, b);
          tma_load_4d(st + (2 + hh) * C::BOX, &tv, &full[s], 0, h0 + hh, j * BK, b);
        }
      }
    }
    return;
  }

  regs_inc<C::REGS>();
  // consumer warpgroup cw: query tile t, head h0 + t % 2, rows q0 .. q0 + 63
  // (the last block's spare warpgroups run the loop on tile 0 and store
  // nothing: every consumer arrives on the ring's empty barriers)
  const int t_all = blockIdx.x * C::NC + cw;
  const bool owns = t_all < 2 * (Sq / C::BQ);
  const int tile = owns ? t_all : 0;
  const int hh = tile % 2, h = h0 + hh;
  const int q0 = (tile / 2) * C::BQ;
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  const int rows[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};

  // q's A fragments, pre-scaled and rounded to bf16, zero past D
  uint32_t qf[KS][4];
  {
    const bf16* qbase = q + b * qb + h * qh;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kk * 16 + 2 * t + (e & 2) * 4;
        uint32_t v = 0u;
        if (c < D) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              qbase + (long long)rows[e & 1] * qs + c));
          v = as_u32(__floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2));
        }
        qf[kk][e] = v;
      }
  }

  const uint32_t base = smem_u32(smem);
  const uint32_t kbox = base + hh * C::BOX, vbox = base + (2 + hh) * C::BOX;
  const uint64_t ones = gmma_desc(base + C::ONES_OFF, C::BOX);
  float o[D / 2], l[4], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.f;
  uint32_t p[2][BK / 16][4];
  fence_regs(o);
  fence_regs(l);
  fence_regs(qf);

  // O += P_j V_j and l += P_j 1 for the tile in stage st, from buffer pb
  auto issue_pv = [&](const uint32_t (&pb)[BK / 16][4], int st) {
    const uint32_t vb = vbox + st * C::STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Gmma<D>::rs(o, pb[kk], gmma_desc(vb + kk * 16 * W * 2, C::BOX));
      Gmma<8>::rs(l, pb[kk], ones);
    }
  };

  // iteration j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}, then packs
  // P_j while the PV product is in flight; nt is even (Sk tiles by 128)
#pragma unroll 1
  for (int j0 = 0; j0 < nt; j0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u, st = j % ST;
      mbar_wait(&full[st], (j / ST) & 1);
      fence_regs(s);
      fence_regs(qf);
      fence_regs(o);
      fence_regs(l);
      fence_regs(p[u ^ 1]);
      gmma_fence();
      const uint32_t kb = kbox + st * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        Gmma<BK>::rs_k(s, qf[kk], gmma_desc(kb + kk * 32, 16), kk > 0);
      gmma_commit();
      fence_regs(s);
      if (j > 0) issue_pv(p[u ^ 1], (j - 1) % ST);
      gmma_commit();
      fence_regs(o);
      fence_regs(l);
      fence_regs(p[u ^ 1]);
      gmma_wait<1>();  // S_j is ready; tile j-2's products are done
      fence_regs(s);
      fence_regs(p[u]);
      if (j >= 2) mbar_arrive(&empty[(j - 2) % ST]);
      pack_p<BK>(s, p[u]);
    }
  }
  fence_regs(o);
  fence_regs(l);
  fence_regs(p[1]);
  gmma_fence();
  issue_pv(p[1], (nt - 1) % ST);
  gmma_commit();
  gmma_wait<0>();
  fence_regs(o);
  fence_regs(l);

  if (!owns) return;
  // every column of l is the row sum of the rounded P
  const float lr[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[2], 1e-30f)};
  bf16* obase = out + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)rows[r] * os + 8 * i + 2 * t) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] / lr[r], o[4 * i + 2 * r + 1] / lr[r]);
  if (t == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[rows[r]] = log2f(lr[r]) * (1.f / kLog2e);
  }
}

template <int D>
cudaError_t launch_hpack2(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int H, int Sq, int Sk, const long long* st, float scale_log2,
                          cudaStream_t stream) {
  using C = Hp2Cfg<D>;
  if (H % 2 || Sq % (2 * C::BQ) || Sk % (2 * C::BK) || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  cudaError_t err = encode_bshd_map(&tk, k, B, Sk, H, D, st[3], st[4], st[5], D, C::BK);
  if (err == cudaSuccess) err = encode_bshd_map(&tv, v, B, Sk, H, D, st[6], st[7], st[8], D, C::BK);
  if (err != cudaSuccess) return err;
  auto kern = flash_hpack2<D>;
  static bool attr_set = false;  // the attribute holds for the process
  if (!attr_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles = 2 * (Sq / C::BQ);  // 64-row query tiles of a pair
  kern<<<dim3((tiles + C::NC - 1) / C::NC, B * (H / 2)), C::THREADS, C::BYTES, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(out), static_cast<float*>(lse), H,
      Sq, Sk, st[0], st[1], st[2], st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

template <int D>
void hpack2_config(int* out) {
  using C = Hp2Cfg<D>;
  out[0] = C::NC;
  out[1] = C::BQ;
  out[2] = C::BK;
  out[3] = C::STAGES;
  out[4] = C::BYTES;
}

}  // namespace
}  // namespace ctrlora

// q, k, v, out: [B, H, S, D] views given by (batch, sequence, head) strides
// (elements); lse fp32 [B, H, Sq] contiguous. H even, D = 8, 16, 32, 40 or
// 64, Sq and Sk multiples of 128.
extern "C" int ctrlora_flash_hpack2(const void* q, const void* k, const void* v, void* out,
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
  switch (D) {
    case 8: return static_cast<int>(launch_hpack2<8>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s));
    case 16: return static_cast<int>(launch_hpack2<16>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s));
    case 32: return static_cast<int>(launch_hpack2<32>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s));
    case 40: return static_cast<int>(launch_hpack2<40>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s));
    case 64: return static_cast<int>(launch_hpack2<64>(q, k, v, out, lse, B, H, Sq, Sk, st, sl2, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the tiling at head dim D: consumer warpgroups, query rows of a
// warpgroup, keys a tile, ring stages, dynamic shared-memory bytes
extern "C" int ctrlora_flash_hpack2_config(int D, int* out) {
  using namespace ctrlora;
  switch (D) {
    case 8: hpack2_config<8>(out); return 0;
    case 16: hpack2_config<16>(out); return 0;
    case 32: hpack2_config<32>(out); return 0;
    case 40: hpack2_config<40>(out); return 0;
    case 64: hpack2_config<64>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
