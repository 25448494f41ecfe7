// Head-pair flash-attention forward for Hopper (sm_90a), bf16 in and out:
// kernel B6 of the port.
//
// Replaces the TPU kernel ctrlora_tpu/ops/flash_attention.py
// `_fwd_kernel_hpack2` and computes what it computes, not how: for the heads
// (2p, 2p+1) of a pair, the logits s2 = (q * scale * log2(e), rounded to
// bf16) . k^T in fp32; p = exp2(min(s2, 110)) with no running max and no
// rescale (the skip-max softmax with its overflow clamp); P rounded to bf16
// for the PV product, fp32 accumulation, the row sum l taken over the rounded
// P (the TPU kernel's ones columns); out = PV / max(l, 1e-30) and the
// natural-log lse = log2(l) / log2(e), fp32 [B, H, Sq].
//
// The TPU kernel built block-diagonal K and V operands so that one product
// filled 80 of the MXU's 128 lanes instead of 40. On tensor cores those
// operands would only double the MMA work on zeros, so they are not built:
// here the pairing means that one block owns a 64-row query tile of BOTH
// heads and reads each key row of the pair as one 160-byte run of the
// [B, S, H*D] (or fused [B, S, 3*H*D]) rows, where a one-head kernel reads
// 80-byte runs. Otherwise it is kernel B's mma.sync design
// (csrc/flash_attention.cu): eight warps, four to a head, each keeping its
// 16 query rows' q fragments, logits, probabilities and output accumulator
// in registers (<= 128 registers, two blocks to an SM); the 64-key K/V tile
// of both heads in shared memory (K row-major, V transposed, rows padded by
// 8 elements), loaded with consecutive threads on consecutive key rows so
// the transposed stores do not collide in one bank; P goes from the logits'
// accumulator layout straight into the A fragments of the PV product. D = 40
// is zero-padded to 48. Without the running max there is no rescale of the
// accumulators and the row sums reduce across the lane quad once, at the
// end. (On an H100 80GB HBM3 at 700 W, [8,4096,8,40]: both heads' rows in
// every warp took 3.0 ms, the row-major tile load 2.5 ms, this 1.89 ms;
// kernel B 1.75 ms.)
//
// What bounds it on the H100: as kernel B at D = 40, the tensor cores and the
// exp2 of every logit. The launcher takes (batch, sequence, head) strides of
// q, k, v and out, so the split views of a fused projection need no copy.

#include "common.cuh"

namespace ctrlora {
namespace {

constexpr int kThreads = 256;  // eight warps: four to each head of the pair
constexpr int kRowWarps = 4;    // warps along the query rows
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_hpack2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Sk, int D,
                    long long qb, long long qs, long long qh,
                    long long kb, long long ks, long long kh,
                    long long vb, long long vs, long long vh,
                    long long ob, long long os, long long oh, float scale_log2) {
  constexpr int BQ = 16 * kRowWarps;  // 64 query rows per block
  constexpr int BK = 64;           // keys per tile
  constexpr int KS = DP / 16;      // k-steps of the QK product
  constexpr int ND = DP / 8;       // n-tiles of the PV product
  constexpr int KST = DP + 8;      // padded row strides (bank-conflict free)
  constexpr int VST = BK + 8;
  constexpr int CH = DP / 8;       // 16-byte chunks per head row
  static_assert(DP % 16 == 0, "head dim pads to a multiple of 16");
  __shared__ __align__(16) bf16 sK[2][BK * KST];
  __shared__ __align__(16) bf16 sVt[2][DP * VST];

  const int pairs = H / 2;
  const int b = blockIdx.y / pairs;
  const int h0 = 2 * (blockIdx.y % pairs);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  const int hh = warp / kRowWarps;  // this warp's head of the pair
  const int row0 = blockIdx.x * BQ + (warp % kRowWarps) * 16 + g;
  const int row1 = row0 + 8;
  const bf16* qbase = q + b * qb + h0 * qh;
  const bf16* kbase = k + b * kb + h0 * kh;
  const bf16* vbase = v + b * vb + h0 * vh;

  // q fragments of this warp's head, pre-scaled by scale*log2(e) and
  // rounded to bf16 (the TPU kernel's scaled q operand); zero past Sq / D
  const bf16* qh_base = qbase + hh * qh;
  auto ld = [&](int r, int c) -> uint32_t {
    if (r >= Sq || c >= D) return 0u;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qh_base + (long long)r * qs + c));
    return as_u32(__floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2));
  };
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = kk * 16 + tig * 2;
    const int c1 = c0 + 8;
    qf[kk][0] = ld(row0, c0);
    qf[kk][1] = ld(row1, c0);
    qf[kk][2] = ld(row0, c1);
    qf[kk][3] = ld(row1, c1);
  }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    // both heads' rows of the tile; consecutive threads take consecutive
    // key rows of one 16-byte chunk, so the transposed V stores of a warp
    // fall in distinct banks (row-fastest: the chunks of one row would all
    // map to one bank, VST * 8 elements apart)
    for (int i = tid; i < BK * 2 * CH; i += kThreads) {
      const int r = i % BK;
      const int lh = i / (BK * CH);
      const int c = (i / BK) % CH * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk && c < D) {
        kv = *reinterpret_cast<const uint4*>(kbase + lh * kh + (long long)(k0 + r) * ks + c);
        vv = *reinterpret_cast<const uint4*>(vbase + lh * vh + (long long)(k0 + r) * vs + c);
      }
      *reinterpret_cast<uint4*>(sK[lh] + r * KST + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[lh][(c + e) * VST + r] = ve[e];
    }
    __syncthreads();

    {
      // S2 = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        const bf16* kr = sK[hh] + (j * 8 + g) * KST + tig * 2;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
          mma_bf16_16816(sc[j], qf[kk], b0, b1);
        }
      }
      // P = exp2(min(S2, 110)) in bf16, straight into the PV A fragments;
      // the row sums are taken over the rounded values the product uses
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k0 + j * 8 + tig * 2 + (e % 2) < Sk;
          pv[e] = valid ? exp2f(fminf(sc[j][e], 110.f)) : 0.f;
        }
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(pv[0], pv[1]);
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(pv[2], pv[3]);
        l0 += __low2float(p01) + __high2float(p01);
        l1 += __low2float(p23) + __high2float(p23);
        pa[j / 2][(j % 2) * 2 + 0] = as_u32(p01);
        pa[j / 2][(j % 2) * 2 + 1] = as_u32(p23);
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          const bf16* vr = sVt[hh] + (dn * 8 + g) * VST + kc * 16 + tig * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
          mma_bf16_16816(o[dn], pa[kc], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const int h = h0 + hh;
  bf16* obase = out + b * ob + h * oh;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const int c = dn * 8 + tig * 2;
    if (c < D) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row0 * os + c) =
            __floats2bfloat162_rn(o[dn][0] / l0, o[dn][1] / l0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row1 * os + c) =
            __floats2bfloat162_rn(o[dn][2] / l1, o[dn][3] / l1);
    }
  }
  if (tig == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq;
    if (row0 < Sq) lrow[row0] = log2f(l0) * (1.f / kLog2e);
    if (row1 < Sq) lrow[row1] = log2f(l1) * (1.f / kLog2e);
  }
}

template <int DP>
cudaError_t launch_hpack2(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int H, int Sq, int Sk, int D, const long long* st,
                          float scale_log2, cudaStream_t stream) {
  dim3 grid((Sq + 16 * kRowWarps - 1) / (16 * kRowWarps), B * (H / 2));
  flash_hpack2_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlora

// q, k, v, out: [B, H, S, D] views given by (batch, sequence, head) strides
// (elements); lse fp32 [B, H, Sq] contiguous. H even, D % 8 == 0, D <= 64.
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
  cudaError_t err;
  if (H % 2 != 0 || D % 8 != 0 || D <= 0) {
    err = cudaErrorInvalidValue;
  } else if (D <= 32) {
    err = launch_hpack2<32>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 48) {
    err = launch_hpack2<48>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else if (D <= 64) {
    err = launch_hpack2<64>(q, k, v, out, lse, B, H, Sq, Sk, D, st, sl2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
