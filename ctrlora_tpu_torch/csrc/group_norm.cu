// GroupNorm (+ add_row fold, + SiLU) over channels-last [B, HW, C] data for
// Hopper (sm_90a), one launch per call: kernel A of the port.
//
// Replaces the TPU kernel pair ctrlora_tpu/ops/group_norm.py `_stats_kernel`
// :30 + `_apply_kernel` :47 (launched from `fused_group_norm` :154) and
// computes what they compute: fp32 per-channel sums and sums of squares;
// with a row [1, C] or [B, C], the moments of x + row from those of x
// (sum' = sum + HW row, sumsq' = sumsq + 2 row sum + HW row^2), so x + row
// is never built; per group mean = E[x], var = E[x^2] - mean^2; then
// y = x a + b (a = scale rsqrt(var + eps), b = bias - mean a + row a), the
// optional SiLU, stored in x's dtype (bf16 or fp32).
//
// What bounds it on the H100: a few flops per element, so device memory: x
// read once and y written once (0.0125 ms at [8, 64*64, 320] bf16 at 3.35
// TB/s). The TPU kernels carried the channel sums across sequential grid
// steps; Hopper blocks run in no order, and the first port of this kernel
// took three launches (partial sums to a scratch, a per-group epilogue, the
// apply) and read x twice.
//
// Design: one launch. A thread-block cluster of K <= 8 blocks owns one
// (sample, slab), a slab being the fewest whole groups whose channels make
// a run of >= 128 contiguous bytes of each row (the whole row where it is
// narrower), and each block of the cluster owns a contiguous 1/K of the
// sample's rows. A block streams its rows of the slab into shared memory
// with 16-byte cp.async copies (so a slab and a row must be whole
// multiples of 16 bytes) (a few chunks of ~16 KB in flight, no
// registers held), and each thread sums one fixed 16-byte column of the
// slab over its rows in fp32. The block reduces its threads' sums per
// channel in a fixed order, and the cluster exchanges the per-channel sums
// through distributed shared memory: every block reads all K blocks' sums
// in rank order, so all fold the same numbers in the same order and no
// atomics are needed (two launches give the same bits). Each block then
// folds the row in, computes the group statistics and the per-channel
// affine, and applies it:
// * staged path: where the block's rows of the slab fit its shared memory,
//   they stay resident, and x is read from device memory once;
// * re-read path (the same kernel): otherwise the block streams its rows a
//   second time through a ring of chunk buffers for the apply (the VAE's
//   512^2 sites; a UNet-sized sample would still be in the 50 MB L2).
// Cluster size and slab are chosen so the grid covers the SMs at the
// sampling batch (8) and the finetune batch (4) alike: the smallest K whose
// grid reaches 15/16 of the SMs and whose rows fit shared memory. (At
// [8, 64*64, 320] the card holds 30 of the 32 clusters of 4 at once, 160 KB
// a block; re-reading the rows from L2 in one wave instead was no faster.)
// The plan is `gn_plan` below; its Python mirror is ops/group_norm.py
// `group_norm_plan`, and ctrlora_group_norm_config reports it (with
// cudaOccupancyMaxActiveClusters of the launch) for the two to be checked.
//
// Kernel A2, the second C entry (ctrlora_group_norm_onepass), replaces the
// TPU kernel ctrlora_tpu/ops/group_norm.py `_onepass_kernel` :55 (launched
// from `fused_group_norm` :195), which holds a whole sample (<= 3 MiB) in
// VMEM and reads x once. A sample does not fit one block's 227 KB, but it
// fits a cluster's distributed shared memory, so A2 is this kernel's staged
// path under its own plan, `gn_onepass_plan`: always staged (x read once at
// every shape A2 takes; no staged plan, no launch), clusters of up to 16
// blocks (a non-portable size), and the cluster size chosen so the whole
// grid is resident in one wave, where kernel A's plan may take two (at
// [8, 64*64, 320]: 32 clusters of 7 blocks, two a SM, against A's 32
// clusters of 4 of which the card holds 30). Its Python mirror is
// `group_norm_onepass_plan`; ctrlora_group_norm_onepass_config reports it.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ctrlora {
namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;           // bytes of one copy and one thread column
constexpr int kChunkBytes = 16384;  // a chunk of rows in flight
constexpr int kRing = 4;            // re-read path: chunk buffers
constexpr int kAhead = 3;           // chunks in flight ahead of the one summed
constexpr int kMaxCluster = 8;          // kernel A
constexpr int kMaxClusterOnepass = 16;  // kernel A2 (a non-portable cluster size)
constexpr int kSmemLimit = 232448;  // a block's shared memory
constexpr long long kOnepassMaxBytes = 3 << 20;  // A2: a sample's bytes at most
constexpr int kSmSmem = 233472;     // an SM's shared memory
constexpr int kBlockReserve = 1024;  // of it, held by the system for each block

struct GnPlan {
  int cluster;     // K blocks a (sample, slab)
  int slab;        // channels of a slab (whole groups)
  int slabs;       // slabs of a row
  int staged;      // 1: the block's rows stay in shared memory
  int smem;        // dynamic shared-memory bytes
  int chunk_rows;  // rows of a chunk
  int rows;        // rows a block owns (the last may own fewer)
  int groups;      // groups of a slab
};

inline int round16(long long v) { return static_cast<int>((v + 15) / 16 * 16); }

// the per-block bookkeeping after the rows: per-thread partial sums, the
// block's channel sums (read by the cluster), the folded sums, the affine,
// and the group statistics (fp32)
inline int fixed_bytes(int slab, int gps, int vec) {
  return round16(4LL * (2 * kThreads * vec + 6 * slab + 2 * gps));
}

// the fewest whole groups (a divisor of G) whose channels make a run of
// >= 128 contiguous bytes of a row, or all G
inline int slab_groups(int C, int G, int itemsize) {
  for (int d = 1; d <= G; ++d)
    if (G % d == 0 && d * (C / G) * itemsize >= 128) return d;
  return G;
}

// kernel A's plan; returns false where the shape cannot take the kernel
inline bool gn_plan(int B, int HW, int C, int G, int itemsize, int sms, GnPlan* p) {
  if (B <= 0 || HW <= 0 || G <= 0 || C % G != 0 || (itemsize != 2 && itemsize != 4)) return false;
  const int cpg = C / G, gps = slab_groups(C, G, itemsize);
  const int slab = gps * cpg, sb = slab * itemsize, rb = C * itemsize;
  if (sb % kVec != 0 || rb % kVec != 0) return false;
  p->slab = slab;
  p->slabs = G / gps;
  p->groups = gps;
  const int fixed = fixed_bytes(slab, gps, kVec / itemsize);
  const int target = sms - sms / 16;
  const long long units = (long long)B * p->slabs;  // clusters of the grid
  // staged: the smallest cluster whose grid reaches 15/16 of the SMs (or 8
  // blocks) and whose rows fit shared memory
  p->chunk_rows = kChunkBytes / sb > 0 ? kChunkBytes / sb : 1;
  for (int k = 1; k <= kMaxCluster; k *= 2) {
    const int rows = (HW + k - 1) / k;
    const long long bytes = (long long)fixed + round16((long long)rows * sb);
    if ((units * k >= target || k == kMaxCluster) && bytes <= kSmemLimit) {
      p->cluster = k;
      p->rows = rows;
      p->staged = 1;
      p->smem = static_cast<int>(bytes);
      return true;
    }
  }
  // re-read: the smallest cluster whose grid reaches 15/16 of the SMs, with
  // a ring of chunks in shared memory
  p->staged = 0;
  const int ring = fixed + round16((long long)kRing * p->chunk_rows * sb);
  for (int k = 1; k <= kMaxCluster; k *= 2)
    if (units * k >= target) {
      p->cluster = k;
      p->rows = (HW + k - 1) / k;
      p->smem = ring;
      return true;
    }
  // the grid cannot fill the card (the VAE's 512^2 sites): 8 blocks a
  // cluster, each with twice the bytes in flight
  p->chunk_rows = 2 * kChunkBytes / sb > 0 ? 2 * kChunkBytes / sb : 1;
  p->cluster = kMaxCluster;
  p->rows = (HW + kMaxCluster - 1) / kMaxCluster;
  p->smem = fixed + round16((long long)kRing * p->chunk_rows * sb);
  return true;
}

// Kernel A2's plan at one cluster size k and a slab of gps groups: always
// staged (each block keeps its rows of the slab in shared memory, so x is
// read once); false where the rows do not fit or the slab cannot be copied
// in 16-byte columns by one block's threads
inline bool onepass_plan_k(int B, int HW, int C, int G, int itemsize, int k, int gps,
                           GnPlan* p) {
  if (B <= 0 || HW <= 0 || G <= 0 || C % G != 0 || (itemsize != 2 && itemsize != 4) ||
      gps <= 0 || G % gps != 0 || k < 1 || k > kMaxClusterOnepass)
    return false;
  const int slab = gps * (C / G), sb = slab * itemsize;
  if (sb % kVec != 0 || (C * itemsize) % kVec != 0 || sb / kVec > kThreads) return false;
  const int rows = (HW + k - 1) / k;
  const long long bytes =
      (long long)fixed_bytes(slab, gps, kVec / itemsize) + round16((long long)rows * sb);
  if (bytes > kSmemLimit) return false;
  p->cluster = k;
  p->slab = slab;
  p->slabs = G / gps;
  p->groups = gps;
  p->staged = 1;
  p->smem = static_cast<int>(bytes);
  p->rows = rows;
  p->chunk_rows = kChunkBytes / sb > 0 ? kChunkBytes / sb : 1;
  return true;
}

// Kernel A2's plan: A's slab, and the cluster size that makes the grid run
// in one wave, as many blocks as that allows (the finest split of the
// work). Blocks per SM m = 2 where the rows fit half an SM's shared memory,
// else m = 1; the grid must fit m blocks a SM, and 7/8 of that for clusters
// of 3 or more blocks, which the card's GPCs cannot pack without gaps
// (cudaOccupancyMaxActiveClusters on the H100 SXM: 32 clusters of 7 blocks
// at two a SM, 30 of 4 and 39 of 3 at one a SM). The largest k of
// 1..16 that meets both; where none does, the smallest that stages. A
// sample over 3 MiB (the TPU kernel's resident limit) has no plan.
inline bool gn_onepass_plan(int B, int HW, int C, int G, int itemsize, int sms, GnPlan* p) {
  if (G <= 0 || C % G != 0 || (itemsize != 2 && itemsize != 4) ||
      (long long)HW * C * itemsize > kOnepassMaxBytes)
    return false;
  const int gps = slab_groups(C, G, itemsize);
  for (int m = 2; m >= 1; --m) {
    const int per_block = kSmSmem / m - kBlockReserve;  // <= kSmemLimit
    bool found = false;
    for (int k = 1; k <= kMaxClusterOnepass; ++k) {
      GnPlan q;
      if (!onepass_plan_k(B, HW, C, G, itemsize, k, gps, &q) || q.smem > per_block) continue;
      const long long cap = k <= 2 ? (long long)m * sms : (long long)m * sms * 7 / 8;
      if ((long long)B * q.slabs * k <= cap) {
        *p = q;
        found = true;
      }
    }
    if (found) return true;
  }
  for (int k = 1; k <= kMaxClusterOnepass; ++k)
    if (onepass_plan_k(B, HW, C, G, itemsize, k, gps, p)) return true;
  return false;
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// SiLU v * sigmoid(v). bf16 output: sigmoid(v) = (1 + tanh(v / 2)) / 2,
// one MUFU op (tanh.approx, ~2^-11 relative, below bf16's 2^-8); fp32: the
// exp and a fast divide (two MUFU ops, a few ulps)
template <typename T>
__device__ __forceinline__ float silu(float v);
template <>
__device__ __forceinline__ float silu<bf16>(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
  return 0.5f * v * (1.f + t);
}
template <>
__device__ __forceinline__ float silu<float>(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// 16 bytes from global to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct GnArgs {
  const void* x;
  const float* scale;
  const float* bias;
  const void* row;  // nullptr, or [1 or B, C] in bf16 (row_f32 == 0) or fp32
  void* y;
  int HW, C, G, row_f32;
  long long row_stride;  // 0 or C
  float eps;
  int silu;
  GnPlan p;
};

// One pass over the block's rows of the slab in chunks: chunk i lands in
// shared memory (its own place where STAGED, else ring buffer i % kRing)
// kAhead chunks ahead of the one `visit(buf, rows)` reads.
template <typename T, bool STAGED, typename Visit>
__device__ __forceinline__ void stream_rows(unsigned char* data, const T* src, int nrows, int C,
                                            int sb, int cr, Visit visit) {
  const int ncol = sb / kVec;
  const int nch = (nrows + cr - 1) / cr;
  auto buf = [&](int i) { return data + (long long)(STAGED ? i : i % kRing) * cr * sb; };
  auto issue = [&](int i) {
    if (i < nch) {
      const int rows = min(cr, nrows - i * cr);
      unsigned char* dst = buf(i);
      const T* s0 = src + (long long)i * cr * C;
      for (int pc = threadIdx.x; pc < rows * ncol; pc += kThreads) {
        const int r = pc / ncol, c = pc % ncol;
        cp_async16(dst + r * sb + c * kVec,
                   reinterpret_cast<const unsigned char*>(s0 + (long long)r * C) + c * kVec);
      }
    }
    cp_commit();  // an empty group past the end keeps the counts in step
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);
  for (int i = 0; i < nch; ++i) {
    __syncthreads();  // chunk i-1 is read: its ring buffer may be refilled
    issue(i + kAhead);
    cp_wait<kAhead>();
    __syncthreads();
    visit(buf(i), min(cr, nrows - i * cr), i * cr);
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads) gn_cluster(const GnArgs a) {
  constexpr int V = kVec / (int)sizeof(T);
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = a.p.cluster, slab = a.p.slab, gps = a.p.groups;
  const int sb = slab * (int)sizeof(T), ncol = sb / kVec;
  const int rank = blockIdx.x, si = blockIdx.y, b = blockIdx.z;
  const int c0 = si * slab;
  const int r0 = rank * a.p.rows;
  const int nrows = max(0, min(a.HW, r0 + a.p.rows) - r0);
  // the rows (staged) or the ring, then the bookkeeping: gn_plan's layout
  const int data_bytes = ((STAGED ? a.p.rows : kRing * a.p.chunk_rows) * sb + 15) / 16 * 16;
  unsigned char* data = smem;
  float* part = reinterpret_cast<float*>(smem + data_bytes);
  float* xsum = part + 2 * kThreads * V;  // [2][slab]: this block's sums, read by the cluster
  float* fold = xsum + 2 * slab;          // [2][slab]: the cluster's sums, row folded in
  float* aff = fold + 2 * slab;           // [2][slab]: a, b
  float* gst = aff + 2 * slab;            // [2][gps]: mean, rsqrt(var + eps)

  const T* src = static_cast<const T*>(a.x) + ((long long)b * a.HW + r0) * a.C + c0;
  T* dst = static_cast<T*>(a.y) + ((long long)b * a.HW + r0) * a.C + c0;
  const int col = threadIdx.x % ncol, rstep = kThreads / ncol;
  const bool active = threadIdx.x < rstep * ncol;
  const int roff = threadIdx.x / ncol;

  // pass 1: per-thread fp32 sums of one column over the block's rows
  float s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0.f;
  const int cr = a.p.chunk_rows;
  stream_rows<T, STAGED>(data, src, nrows, a.C, sb, cr, [&](const unsigned char* buf, int rows,
                                                                int) {
    if (!active) return;
#pragma unroll 4
    for (int r = roff; r < rows; r += rstep) {
      const P pk = *reinterpret_cast<const P*>(buf + r * sb + col * kVec);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f<T>(pk.v[e]);
        s[e] += f;
        q[e] += f * f;
      }
    }
  });
#pragma unroll
  for (int e = 0; e < V; ++e) {
    part[threadIdx.x * V + e] = s[e];
    part[(kThreads + threadIdx.x) * V + e] = q[e];
  }
  __syncthreads();
  // the block's channel sums in a fixed order
  for (int ch = threadIdx.x; ch < slab; ch += kThreads) {
    const int j = ch / V, e = ch % V;
    float cs = 0.f, cq = 0.f;
    for (int rr = 0; rr < rstep; ++rr) {
      cs += part[(rr * ncol + j) * V + e];
      cq += part[(kThreads + rr * ncol + j) * V + e];
    }
    xsum[ch] = cs;
    xsum[slab + ch] = cq;
  }
  // a cluster of one block needs only its own barrier
  auto cluster_sync = [&] {
    if (K > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  cluster_sync();  // every block's sums are written

  // the cluster's sums in rank order, the row folded in per channel
  for (int ch = threadIdx.x; ch < slab; ch += kThreads) {
    float cs = 0.f, cq = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* peer = K > 1 ? cluster.map_shared_rank(xsum, k) : xsum;
      cs += peer[ch];
      cq += peer[slab + ch];
    }
    float rv = 0.f;
    if (a.row != nullptr) {
      const long long ri = b * a.row_stride + c0 + ch;
      rv = a.row_f32 ? static_cast<const float*>(a.row)[ri]
                     : __bfloat162float(static_cast<const bf16*>(a.row)[ri]);
      cq = cq + 2.f * rv * cs + (float)a.HW * rv * rv;
      cs = cs + (float)a.HW * rv;
    }
    fold[ch] = cs;
    fold[slab + ch] = cq;
    aff[slab + ch] = rv;  // kept for the affine
  }
  cluster_sync();  // no block reads a peer's sums after this: it may exit
  // the group statistics: one warp a group, its lanes over the group's
  // channels, then a butterfly of shuffles (the same order every run)
  const int cpg = slab / gps, lane = threadIdx.x % 32;
  for (int gi = threadIdx.x / 32; gi < gps; gi += kThreads / 32) {
    float gs = 0.f, gq = 0.f;
    for (int c = gi * cpg + lane; c < (gi + 1) * cpg; c += 32) {
      gs += fold[c];
      gq += fold[slab + c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
      gq += __shfl_xor_sync(0xffffffffu, gq, o);
    }
    if (lane == 0) {
      const float n = (float)a.HW * (float)cpg;
      const float mean = gs / n;
      gst[gi] = mean;
      gst[gps + gi] = rsqrtf(gq / n - mean * mean + a.eps);
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < slab; ch += kThreads) {
    const int gi = ch / cpg;
    const float av = gst[gps + gi] * a.scale[c0 + ch];
    const float rv = aff[slab + ch];
    aff[slab + ch] = a.bias[c0 + ch] - gst[gi] * av + rv * av;
    aff[ch] = av;
  }
  __syncthreads();

  // pass 2: y = x a + b (+ SiLU), one write
  float av[V], bv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    av[e] = active ? aff[col * V + e] : 0.f;
    bv[e] = active ? aff[slab + col * V + e] : 0.f;
  }
  auto apply = [&](const unsigned char* buf, int rows, int first) {
    if (!active) return;
#pragma unroll 4
    for (int r = roff; r < rows; r += rstep) {
      const P pk = *reinterpret_cast<const P*>(buf + r * sb + col * kVec);
      P o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = to_f<T>(pk.v[e]) * av[e] + bv[e];
        if (a.silu) v = silu<T>(v);
        o.v[e] = from_f<T>(v);
      }
      *reinterpret_cast<P*>(dst + (long long)(first + r) * a.C + col * V) = o;
    }
  };
  if constexpr (STAGED)
    apply(data, nrows, 0);
  else
    stream_rows<T, false>(data, src, nrows, a.C, sb, cr, apply);
}

template <typename T, bool STAGED>
cudaError_t launch(const GnArgs& a, int B, cudaStream_t stream, int* max_clusters) {
  auto kern = gn_cluster<T, STAGED>;
  static bool attr_set = false;  // the attribute holds for the process
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.cluster, a.p.slabs, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.p.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (void*)kern, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const GnArgs& a, int B, cudaStream_t s, int* max_clusters) {
  return a.p.staged ? launch<T, true>(a, B, s, max_clusters) : launch<T, false>(a, B, s, max_clusters);
}

}  // namespace
}  // namespace ctrlora

using PlanFn = bool (*)(int, int, int, int, int, int, ctrlora::GnPlan*);

// x, y: [B, HW, C] contiguous, 16-byte aligned; dtype 0 bf16, 1 fp32; scale,
// bias fp32 [C]; row: nullptr or [1 or B, C] (row_stride 0 or C), fp32 where
// row_f32 else bf16; sms: the card's multiprocessors (the plan's input)
static int run(PlanFn plan, const void* x, const void* scale, const void* bias, const void* row,
               void* y, int B, int HW, int C, int G, long long row_stride, int row_f32,
               float eps, int silu, int dtype, int sms, void* stream) {
  using namespace ctrlora;
  GnArgs a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), row, y, HW, C,
           G, row_f32, row_stride, eps, silu, {}};
  if ((dtype != 0 && dtype != 1) || !plan(B, HW, C, G, dtype ? 4 : 2, sms, &a.p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype ? dispatch<float>(a, B, s, nullptr)
                                : dispatch<bf16>(a, B, s, nullptr));
}

// the plan at one shape: out[0..7] = cluster, slab, slabs, staged, smem,
// chunk_rows, rows, groups of a slab; out[8] =
// cudaOccupancyMaxActiveClusters of that launch (on the current device)
static int config(PlanFn plan, int B, int HW, int C, int G, int itemsize, int sms, int* out) {
  using namespace ctrlora;
  GnArgs a{};
  if (!plan(B, HW, C, G, itemsize, sms, &a.p)) return static_cast<int>(cudaErrorInvalidValue);
  const GnPlan& p = a.p;
  const int vals[8] = {p.cluster, p.slab, p.slabs, p.staged, p.smem, p.chunk_rows, p.rows,
                       p.groups};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  a.HW = HW;
  a.C = C;
  a.G = G;
  const cudaError_t err = itemsize == 4 ? dispatch<float>(a, B, nullptr, &out[8])
                                        : dispatch<bf16>(a, B, nullptr, &out[8]);
  return static_cast<int>(err);
}

// kernel A
extern "C" int ctrlora_group_norm(const void* x, const void* scale, const void* bias,
                                  const void* row, void* y, int B, int HW, int C, int G,
                                  long long row_stride, int row_f32, float eps, int silu,
                                  int dtype, int sms, void* stream) {
  return run(ctrlora::gn_plan, x, scale, bias, row, y, B, HW, C, G, row_stride, row_f32, eps,
             silu, dtype, sms, stream);
}

extern "C" int ctrlora_group_norm_config(int B, int HW, int C, int G, int itemsize, int sms,
                                         int* out) {
  return config(ctrlora::gn_plan, B, HW, C, G, itemsize, sms, out);
}

// kernel A2: the same arguments; it raises (cudaErrorInvalidValue) where no
// staged plan exists
extern "C" int ctrlora_group_norm_onepass(const void* x, const void* scale, const void* bias,
                                          const void* row, void* y, int B, int HW, int C,
                                          int G, long long row_stride, int row_f32, float eps,
                                          int silu, int dtype, int sms, void* stream) {
  return run(ctrlora::gn_onepass_plan, x, scale, bias, row, y, B, HW, C, G, row_stride,
             row_f32, eps, silu, dtype, sms, stream);
}

extern "C" int ctrlora_group_norm_onepass_config(int B, int HW, int C, int G, int itemsize,
                                                 int sms, int* out) {
  return config(ctrlora::gn_onepass_plan, B, HW, C, G, itemsize, sms, out);
}
