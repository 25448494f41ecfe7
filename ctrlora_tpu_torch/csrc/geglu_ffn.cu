// Fused GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   [a | g] = x W1 + b1;   h = a * gelu_erf(g);   y = h W2 + b2
//
// Replaces the TPU kernels ctrlora_tpu/ops/geglu_ffn.py `_geglu_kernel` :59
// (weights resident in VMEM, C = 320 and 640) and `_geglu_kernel_blocked`
// :120 (F streamed into an fp32 accumulator, C = 1280). Weights come in
// nn.Linear's layout, w1 [2F, C] and w2 [C, F], so x, W1, h and W2 are all
// K-major as stored and no operand is transposed.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s, 50 MB L2): the
// two products, 6 * rows * C * F flops, 80.5 GFLOP at each of the 64^2,
// 32^2 and 16^2 sites (0.081 ms at the tensor-core peak), against ~45 MB of
// x, y and weights (0.013 ms). So the tensor cores bound the function; what
// keeps these kernels from them is, at C = 640 and 1280, the operand stream
// from L2 into shared memory (a 128 x 256 tile reads 87 flops' worth a
// byte), and at C = 320 the gate: 42M erf-GELUs a call against a K = 320
// product, and the gate's instruction stream on eight consumer warps is
// longer than the products it follows (tools/ablate_geglu.py times the
// parts; PERF.md has the numbers).
//
// Two launches, each a persistent warp-specialised wgmma GEMM: a producer
// warpgroup whose one thread streams 64-column TMA boxes (128B swizzle)
// into a ring of shared-memory stages (`full` / `empty` mbarriers) and gives
// its registers to two consumer warpgroups (setmaxnreg), which own 64 rows
// each of a 128-row tile and share its weight tile. A block walks the tiles
// `blockIdx.x, + gridDim.x, ...`, so the producer loads the next tile while
// the consumers run the last one's epilogue.
// * `geglu_up<BN>`: the tile is 128 rows x BN columns of F. Its weight tile
//   is two boxes stacked in shared memory, the BN W1 rows of a and the BN
//   rows of g (F + n0 ..), so one wgmma m64n(2 BN)k16 gives a and g of the
//   same columns in the same thread's registers. The epilogue adds b1 and
//   gates in registers, writes the bf16 tile of h into a staging slot with
//   stmatrix (128B-swizzled) and one thread stores it with TMA, which the
//   next tile's epilogue waits for. The [rows, 2F] pre-activation never
//   reaches memory, as in the TPU kernels; the gated half does, in bf16
//   (84 MB at the 64^2 site, written and read once; at 16^2 and 8^2 it stays
//   in L2). BN = 128 (N = 256, 128 accumulator registers a thread) where that
//   fills the waves, BN = 64 at the 8^2 site (320 tiles, not 160, on 132 SMs).
// * `geglu_down<BN>`: y = h W2^T + b2 in 128 x BN tiles, BN = 160 at the
//   SD1.5 widths (160 divides each), 64 at C = 64 and 128 at C = 128 and 256
//   (ControlNet-XS's control stream, which 160 does not divide; the plan
//   picks the first of 160, 128, 64 that divides C). Where the tiles would
//   not fill the SMs (the 8^2 site: 32
//   tiles, K = F = 5120) the K range splits: each split writes its fp32
//   partial tile to a workspace, and the last of a tile's splits to arrive
//   (a self-resetting counter per tile) sums the partials in split order
//   (the same bits whichever arrives last), adds b2 and stores y.
// A single fused kernel is not the way on this card: a [128, C] fp32 output
// tile is 320 KB of registers at C = 640 (an SM has 256 KB); the earlier
// mma.sync kernel kept [16..64, C] tiles and so streamed every weight
// through L2 once per 16..64 rows. Here a weight element serves 128 rows and an x element a
// 256-wide (a | g) tile. Keeping x's 128 x 320 tile resident at C = 320
// (only W1 streaming, the two warpgroups taking turns on column tiles) cut
// the loads but not the time: the gate bounds that site.
//
// The tiling (BN, the split, the grids) comes from the caller:
// ops/geglu_ffn.py `geglu_plan`, which the CPU tests check. Unit u of the up
// launch is tile (u / n_tiles, u % n_tiles); of the down launch, split u %
// split of tile u / split. Rows past `rows` read as zeros (TMA) and store
// nothing. The split counters are shared by launches on one device: two
// concurrent split launches (two streams) would need their own.
//
// Numerics (the plain version's rounding points, and the TPU resident
// kernel's): both products accumulate in fp32; a + b1 and g + b1 are
// rounded to bf16 before the gate (the [rows, 2F] pre-activation in bf16;
// the TPU's blocked kernel, C = 1280, kept g in fp32, which put single
// outputs at C = 64 outside the kernel check's tolerance); gelu's value is
// rounded to bf16; the product is rounded to bf16 (h); b2 is added in fp32
// and y rounded once.
// erf is the TPU kernel's polynomial (no branch, unlike erff), and the bf16
// roundings inside the gate are done on the integer bits: both shorten the
// gate's instruction stream.
//
// Host time: tensor maps are cached under everything they encode (pointer,
// shape, stride, box), so the weights' maps are encoded once; nothing
// synchronises, and h and the split workspace come from the caller.

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace ctrlora {
namespace {

constexpr int W = 64;                     // box width: 64 bf16 = 128-byte rows
constexpr int BM = 128;                   // rows of a tile: two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int BOX_A = BM * W * 2;         // one 128 x 64 box of x or h: 16 KB
constexpr int RING_BYTES = 200 * 1024;
constexpr int kBarReduce = 1;             // named barrier of the split-K handshake
constexpr int kBarStaging = 2;            // + warpgroup: its staging slot's barrier
constexpr int BOX_OUT = 64 * W * 2;       // one 64-row box of h in a staging slot: 8 KB

// ring of STAGE-byte stages, EXTRA bytes of staging, the barriers and the
// split-K flag
template <int STAGE_BYTES, int EXTRA = 0>
struct Ring {
  static constexpr int STAGE = STAGE_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int STAGING_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = STAGING_OFF + EXTRA;
  static constexpr int FLAG_OFF = BAR_OFF + 16 * STAGES;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0 && STAGES >= 2 && BYTES <= 232448, "ring");
};

// staging: each consumer warpgroup's 64 rows x BN columns of h, BN / 64 boxes
template <int BN>
struct UpCfg : Ring<BOX_A + 2 * BN * W * 2, 2 * (BN / 64) * BOX_OUT> {
  static constexpr int N = 2 * BN;  // a then g
  static constexpr int BOX_W = BN * W * 2;
  static constexpr int SLOT = (BN / 64) * BOX_OUT;
};

template <int BN_>
struct DownCfg : Ring<BOX_A + BN_ * W * 2> {
  static constexpr int BN = BN_;
};

template <int ST>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// One tile's K loop on the consumer side: nk boxes from the ring (`it`
// counts boxes across tiles), four k16 wgmmas of this warpgroup's 64 rows
// (at `a` in stage 0) by the N-row weight tile (at `b`) per box. A stage is
// released as soon as the wgmmas that read it are done; one group stays in
// flight while the next box's wait and issue run.
template <int N, int ST, int STAGE>
__device__ __forceinline__ void mainloop(float (&d)[N / 2], uint32_t a, uint32_t b,
                                         uint64_t* full, uint64_t* empty, int nk, int& it) {
  for (int kb = 0; kb < nk; ++kb, ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    fence_regs(d);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      Gmma<N>::ss(d, gmma_desc(a + s * STAGE + kk * 32, 16), gmma_desc(b + s * STAGE + kk * 32, 16),
                  kb > 0 || kk > 0);
    gmma_commit();
    if (kb > 0) {
      gmma_wait<1>();
      mbar_arrive(&empty[(it - 1) % ST]);
    }
  }
  gmma_wait<0>();
  fence_regs(d);
  mbar_arrive(&empty[(it - 1) % ST]);
}

// a finite float rounded to bf16 (nearest, ties to even) and kept in fp32:
// cvt.rn.bf16.f32 and back, in three integer operations
__device__ __forceinline__ float round_bf16(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// erf by Abramowitz & Stegun 7.1.26, the TPU kernel's `_erf` (max abs error
// 1.5e-7, far below the bf16 rounding of gelu that follows): branch-free,
// where erff takes one of two ranges per lane and a warp often both
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float p = t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                                   -0.284496736f), 0.254829592f);
  return copysignf(1.f - p * __expf(-ax * ax), x);
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// h = a * gelu(g), [a | g] = x W1 + b1
// ---------------------------------------------------------------------------

// Gate one warpgroup's 64 rows x BN columns (from n0) of h, from an
// m64n(2 BN) accumulator of a then g (columns 8j + 2t.. of a in d[4j..], of
// g in d[4(j + BN/8)..]; t = lane % 4, rows 16w + lane / 4 and 8 below),
// into `slot`: BN / 64 boxes of 64 rows x 128 bytes, 128B-swizzled as the
// TMA store reads them. stmatrix writes four 8 x 8 blocks a warp: lane 8q +
// r addresses row r (+ 8 for odd q) of the warp's 16, column block j + q / 2.
template <int BN>
__device__ __forceinline__ void gate_to_slot(const float (&d)[BN], const bf16* __restrict__ b1,
                                             int F, int n0, uint32_t slot) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < BN / 8; j += 2) {
    uint32_t p[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = n0 + 8 * (j + jj) + 2 * (lane % 4);
      const float2 ba = load_bf16x2(b1 + col), bg = load_bf16x2(b1 + F + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float av = d[4 * (j + jj) + 2 * r + e] + (e ? ba.y : ba.x);
          const float gv =
              round_bf16(d[4 * (j + jj + BN / 8) + 2 * r + e] + (e ? bg.y : bg.x));
          v[e] = round_bf16(av) * round_bf16(0.5f * gv * (1.f + erf_as(gv * 0.70710678118654752f)));
        }
        p[2 * jj + r] = as_u32(__floats2bfloat162_rn(v[0], v[1]));
      }
    }
    const int cb = j + (lane >> 4);  // this lane's 8-column block
    stmatrix_x4(slot + cb / 8 * BOX_OUT + row * 128 + (((cb % 8) ^ (row & 7)) << 4), p[0], p[1],
                p[2], p[3]);
  }
}

// A warpgroup's staging slot: taken once the TMA store that last read it
// has done so, handed to the TMA (async proxy) once written.
__device__ __forceinline__ void slot_take(int cw) {
  if (threadIdx.x % 128 == 0) tma_store_wait_read();
  named_sync(kBarStaging + cw, 128);
}
__device__ __forceinline__ void slot_give(int cw) {
  fence_proxy_async();
  named_sync(kBarStaging + cw, 128);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
geglu_up(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
         const __grid_constant__ CUtensorMap th, const bf16* __restrict__ b1, int rows, int C,
         int F) {
  using G = UpCfg<BN>;
  constexpr int ST = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + ST;
  const int n_tiles = F / BN, units = (rows + BM - 1) / BM * n_tiles, nk = C / W;

  init_ring<ST>(full, empty);
  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup hands registers over
    regs_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = u / n_tiles * BM, n0 = u % n_tiles * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], G::STAGE);
          unsigned char* st = smem + s * G::STAGE;
          tma_load_2d(st, &tx, &full[s], kb * W, m0);
          tma_load_2d(st + BOX_A, &tw1, &full[s], kb * W, n0);
          tma_load_2d(st + BOX_A + G::BOX_W, &tw1, &full[s], kb * W, F + n0);
        }
      }
    }
    return;
  }
  regs_inc<232>();  // 128 x 40 + 256 x 232 <= 384 x 168, the launch allocation

  const int cw = threadIdx.x / 128;
  const uint32_t base = smem_u32(smem);
  unsigned char* slot = smem + G::STAGING_OFF + cw * G::SLOT;
  float d[BN];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = u / n_tiles * BM, n0 = u % n_tiles * BN;
    mainloop<G::N, ST, G::STAGE>(d, base + cw * 64 * W * 2, base + BOX_A, full, empty, nk, it);
    slot_take(cw);
    gate_to_slot<BN>(d, b1, F, n0, smem_u32(slot));
    slot_give(cw);
    if (threadIdx.x % 128 == 0) {
      for (int b = 0; b < BN / 64; ++b)
        tma_store_2d(&th, slot + b * BOX_OUT, n0 + 64 * b, m0 + 64 * cw);
      tma_store_commit();
    }
  }
  if (threadIdx.x % 128 == 0) tma_store_wait_read();
}

// ---------------------------------------------------------------------------
// y = h W2^T + b2, the K range optionally split
// ---------------------------------------------------------------------------

template <int BN_>
__global__ void __launch_bounds__(THREADS, 1)
geglu_down(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw2,
           const bf16* __restrict__ b2, bf16* __restrict__ y, float* __restrict__ ws,
           int* __restrict__ counters, int rows, int C, int F, int split) {
  using G = DownCfg<BN_>;
  constexpr int ST = G::STAGES, BN = G::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* empty = full + ST;
  volatile int* last = reinterpret_cast<volatile int*>(smem + G::FLAG_OFF);
  const int n_tiles = C / BN, units = (rows + BM - 1) / BM * n_tiles * split;
  const int nk = F / W / split;

  init_ring<ST>(full, empty);
  if (threadIdx.x >= CONSUMERS) {
    regs_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = u / split, k0 = u % split * nk;
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % ST;
          mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], G::STAGE);
          unsigned char* st = smem + s * G::STAGE;
          tma_load_2d(st, &th, &full[s], (k0 + kb) * W, m0);
          tma_load_2d(st + BOX_A, &tw2, &full[s], (k0 + kb) * W, n0);
        }
      }
    }
    return;
  }
  regs_inc<232>();

  const int cw = threadIdx.x / 128, w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  float d[BN / 2];  // m64nBN: columns 8j + 2t.. in d[4j..]
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / split, ks = u % split;
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    mainloop<BN, ST, G::STAGE>(d, base + cw * 64 * W * 2, base + BOX_A, full, empty, nk, it);
    const int r0 = m0 + 64 * cw + 16 * w + lane / 4, c0 = n0 + 2 * (lane % 4);
    if (split > 1) {
      float* part = ws + (long long)ks * rows * C;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r0 + 8 * r < rows)
            *reinterpret_cast<float2*>(part + (long long)(r0 + 8 * r) * C + c0 + 8 * j) =
                make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
      __threadfence();
      named_sync(kBarReduce, CONSUMERS);
      if (threadIdx.x == 0) *last = atomicAdd(&counters[tile], 1) == split - 1;
      named_sync(kBarReduce, CONSUMERS);
      if (!*last) continue;
      // the last split of this tile: every partial, in split order
      __threadfence();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r0 + 8 * r < rows) {
            const float* p = ws + (long long)(r0 + 8 * r) * C + c0 + 8 * j;
            float2 acc = __ldcg(reinterpret_cast<const float2*>(p));
            for (int s = 1; s < split; ++s) {
              const float2 q = __ldcg(reinterpret_cast<const float2*>(p + (long long)s * rows * C));
              acc.x += q.x;
              acc.y += q.y;
            }
            d[4 * j + 2 * r] = acc.x;
            d[4 * j + 2 * r + 1] = acc.y;
          }
      if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next launch
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bias = load_bf16x2(b2 + c0 + 8 * j);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r0 + 8 * r < rows)
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)(r0 + 8 * r) * C + c0 + 8 * j) =
              __floats2bfloat162_rn(d[4 * j + 2 * r] + bias.x, d[4 * j + 2 * r + 1] + bias.y);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// A 2-D map ([rows, cols], row stride ld, 64 x box_rows boxes) from a small
// direct-mapped cache keyed on all of those: a map is a pure function of
// them, so a hit is the map the encoder would give.
cudaError_t cached_map(CUtensorMap* out, const void* base, int rows, int cols, long long ld,
                       int box_rows) {
  struct Slot {
    CUtensorMap map;
    const void* base;
    int rows, cols, box_rows;
    long long ld;
    bool valid;
  };
  constexpr int kSlots = 256;
  static Slot slots[kSlots];
  static std::mutex mu;
  const uint64_t key = reinterpret_cast<uint64_t>(base) ^ (uint64_t)rows * 0x9E3779B97F4A7C15ull ^
                       (uint64_t)cols * 0xC2B2AE3D27D4EB4Full ^ (uint64_t)box_rows;
  Slot& slot = slots[(key ^ (key >> 29)) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (slot.valid && slot.base == base && slot.rows == rows && slot.cols == cols &&
      slot.ld == ld && slot.box_rows == box_rows) {
    *out = slot.map;
    return cudaSuccess;
  }
  const cudaError_t err = encode_2d_map(out, base, rows, cols, ld, box_rows);
  if (err == cudaSuccess) {
    slot.map = *out;
    slot.base = base;
    slot.rows = rows;
    slot.cols = cols;
    slot.ld = ld;
    slot.box_rows = box_rows;
    slot.valid = true;
  }
  return err;
}

template <int BN>
cudaError_t launch_up(const void* x, const void* w1, const void* b1, void* h, int rows, int C,
                      int F, int grid, cudaStream_t stream) {
  using G = UpCfg<BN>;
  if (F % BN != 0) return cudaErrorInvalidValue;
  CUtensorMap tx, tw1, th;
  cudaError_t err = cached_map(&tx, x, rows, C, C, BM);
  if (err == cudaSuccess) err = cached_map(&tw1, w1, 2 * F, C, C, BN);
  if (err == cudaSuccess) err = cached_map(&th, h, rows, F, F, 64);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geglu_up<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::BYTES);
  if (err != cudaSuccess) return err;
  geglu_up<BN><<<grid, THREADS, G::BYTES, stream>>>(tx, tw1, th, static_cast<const bf16*>(b1),
                                                    rows, C, F);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_down(const void* h, const void* w2, const void* b2, void* y, void* ws,
                        void* counters, int rows, int C, int F, int split, int grid,
                        cudaStream_t stream) {
  using G = DownCfg<BN>;
  if (C % BN != 0) return cudaErrorInvalidValue;
  CUtensorMap th, tw2;
  cudaError_t err = cached_map(&th, h, rows, F, F, BM);
  if (err == cudaSuccess) err = cached_map(&tw2, w2, C, F, F, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geglu_down<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::BYTES);
  if (err != cudaSuccess) return err;
  geglu_down<BN><<<grid, THREADS, G::BYTES, stream>>>(
      th, tw2, static_cast<const bf16*>(b2), static_cast<bf16*>(y), static_cast<float*>(ws),
      static_cast<int*>(counters), rows, C, F, split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlora

// h [rows, F] = a * gelu(g) of x [rows, C], w1 [2F, C], b1 [2F]; bn: F
// columns of a tile (128 or 64); grid: persistent blocks
extern "C" int ctrlora_geglu_up(const void* x, const void* w1, const void* b1, void* h, int rows,
                                int C, int F, int bn, int grid, void* stream) {
  using namespace ctrlora;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows <= 0 || grid <= 0 || C % W != 0) {
    err = cudaErrorInvalidValue;
  } else if (bn == 128) {
    err = launch_up<128>(x, w1, b1, h, rows, C, F, grid, s);
  } else if (bn == 64) {
    err = launch_up<64>(x, w1, b1, h, rows, C, F, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// y [rows, C] = h W2^T + b2 with w2 [C, F]; split: K splits (a divisor of
// F / 64), ws: fp32 [split, rows, C] and counters: int32 [tiles], zero, when
// split > 1; bn: output columns of a tile (160, 128 or 64, dividing C)
extern "C" int ctrlora_geglu_down(const void* h, const void* w2, const void* b2, void* y,
                                  void* ws, void* counters, int rows, int C, int F, int split,
                                  int grid, int bn, void* stream) {
  using namespace ctrlora;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || grid <= 0 || F % W != 0 || split < 1 || (F / W) % split != 0 ||
      (split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bn == 160) {
    err = launch_down<160>(h, w2, b2, y, ws, counters, rows, C, F, split, grid, s);
  } else if (bn == 128) {
    err = launch_down<128>(h, w2, b2, y, ws, counters, rows, C, F, split, grid, s);
  } else if (bn == 64) {
    err = launch_down<64>(h, w2, b2, y, ws, counters, rows, C, F, split, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
