// One-pass GroupNorm (+ add_row fold, + SiLU) over channels-last
// [B, HW, C] data for Hopper (sm_90a): kernel A2 of the port.
//
// Replaces the TPU kernel ctrlora_tpu/ops/group_norm.py `_onepass_kernel`
// and computes what it computes: per-(sample, group) fp32 mean and
// E[x^2] - mean^2 from per-channel sums; with a row [1, C] or [B, C], the
// moments of x + row from those of x (sum' = sum + HW row,
// sumsq' = sumsq + 2 row sum + HW row^2), so x + row is never built;
// then y = x * a + b (a = scale * rsqrt(var + eps), b = bias - mean * a
// + row * a), an optional SiLU, stored in x's dtype.
//
// What bounds it on the H100: a few flops per element, so device-memory
// bandwidth. Its point is that x is read from device memory once (the
// statistics) and y written once, where kernel A reads x twice. The TPU
// held the whole sample (<= 3 MiB) in VMEM; one H100 block has 227 KB of
// shared memory, so the sample does not fit, but one group's [HW, C/G]
// slice does (at most 3 MiB / 32 = 96 KB). So one block of 512 threads
// owns one (sample, group): it stages the slice in dynamic shared memory
// while summing it, reduces the sums in a fixed order (no atomics, the same
// result on every run), and then normalises from shared memory. B * G = 256
// blocks at the UNet's batch of 8 cover the 132 SMs, two blocks to an SM.
//
// Coalescing: in channels-last layout a group is a strip of C/G channels,
// 20-80 bytes of every row at bf16 (C/G = 10..40), so each row of the
// slice is a short run. Each thread owns one fixed pair of channels and
// walks the rows, loading and storing 4-byte pairs (a warp covers several
// consecutive rows); the other groups' blocks of the same sample run at the
// same time and read the rest of each 32-byte sector, mostly from L2. A
// thread-block cluster that spreads a sample's rows over up to 16 blocks and
// reduces the statistics through distributed shared memory would read whole
// rows instead; that is later work.

#include "common.cuh"

namespace ctrlora {
namespace {

constexpr int kGnThreads = 512;

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Shared memory, in this order (the wrapper's _onepass_smem):
//   part  f32 [2][kGnThreads][VEC]   per-thread sums, sums of squares
//   stat  f32 [4 * cpg + 2]          channel sums | sumsq | a | b, mean, inv
//                                    (padded to 16 bytes)
//   slice T   [HW][cpg]              the staged group slice
template <typename T, int VEC>
__global__ void __launch_bounds__(kGnThreads)
gn_onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ row,
                  T* __restrict__ y, int HW, int C, int G, long long row_stride,
                  float eps, int silu) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpg = C / G;
  const int ppr = cpg / VEC;                // pairs (or elements) per row
  const int rows_per_iter = kGnThreads / ppr;
  const int active = rows_per_iter * ppr;
  float* part = reinterpret_cast<float*>(smem);
  float* stat = part + 2 * kGnThreads * VEC;
  const int stat_bytes = ((4 * cpg + 2) * 4 + 15) / 16 * 16;
  T* slice = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stat) + stat_bytes);

  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const long long base = (long long)b * HW * C + (long long)g * cpg;
  const int tid = threadIdx.x;
  const int r0 = tid / ppr;
  const int cp = tid % ppr;

  // pass over x: stage the slice, sum each of this thread's channels
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (tid < active) {
    for (int r = r0; r < HW; r += rows_per_iter) {
      const P p = *reinterpret_cast<const P*>(x + base + (long long)r * C + cp * VEC);
      *reinterpret_cast<P*>(slice + (long long)r * cpg + cp * VEC) = p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f<T>(p.v[e]);
        s[e] += f;
        q[e] += f * f;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    part[tid * VEC + e] = s[e];
    part[(kGnThreads + tid) * VEC + e] = q[e];
  }
  __syncthreads();

  // per-channel moments in a fixed order, the row folded in per channel
  float rv = 0.f;
  if (tid < cpg) {
    const int pk = tid / VEC;
    const int e = tid % VEC;
    float cs = 0.f, cq = 0.f;
    for (int rr = 0; rr < rows_per_iter; ++rr) {
      cs += part[(rr * ppr + pk) * VEC + e];
      cq += part[(kGnThreads + rr * ppr + pk) * VEC + e];
    }
    if (row != nullptr) {
      rv = row[b * row_stride + g * cpg + tid];
      cq = cq + 2.f * rv * cs + (float)HW * rv * rv;
      cs = cs + (float)HW * rv;
    }
    stat[tid] = cs;
    stat[cpg + tid] = cq;
  }
  __syncthreads();
  if (tid == 0) {
    float gs = 0.f, gq = 0.f;
    for (int c = 0; c < cpg; ++c) {
      gs += stat[c];
      gq += stat[cpg + c];
    }
    const float n = (float)HW * (float)cpg;
    const float mean = gs / n;
    const float var = gq / n - mean * mean;
    stat[4 * cpg] = mean;
    stat[4 * cpg + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (tid < cpg) {
    const int ch = g * cpg + tid;
    const float a = stat[4 * cpg + 1] * scale[ch];
    stat[2 * cpg + tid] = a;
    stat[3 * cpg + tid] = bias[ch] - stat[4 * cpg] * a + rv * a;
  }
  __syncthreads();

  // normalise from shared memory, one write of y
  if (tid < active) {
    float a[VEC], bb[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a[e] = stat[2 * cpg + cp * VEC + e];
      bb[e] = stat[3 * cpg + cp * VEC + e];
    }
    for (int r = r0; r < HW; r += rows_per_iter) {
      const P p = *reinterpret_cast<const P*>(slice + (long long)r * cpg + cp * VEC);
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f<T>(p.v[e]) * a[e] + bb[e];
        if (silu) v = v / (1.f + __expf(-v));
        o.v[e] = from_f<T>(v);
      }
      *reinterpret_cast<P*>(y + base + (long long)r * C + cp * VEC) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_gn(const void* x, const float* scale, const float* bias, const float* row,
                      void* y, int B, int HW, int C, int G, long long row_stride, float eps,
                      int silu, int smem, cudaStream_t stream) {
  auto kern = gn_onepass_kernel<T, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<B * G, kGnThreads, smem, stream>>>(static_cast<const T*>(x), scale, bias, row,
                                            static_cast<T*>(y), HW, C, G, row_stride, eps,
                                            silu);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctrlora

// dtype: 0 bf16, 1 fp32. row: nullptr, or fp32 [1 or B, C] with row_stride
// 0 or C. smem: the dynamic shared memory the wrapper computed.
extern "C" int ctrlora_group_norm_onepass(const void* x, const void* scale, const void* bias,
                                          const void* row, void* y, int B, int HW, int C,
                                          int G, long long row_stride, float eps, int silu,
                                          int dtype, int smem, void* stream) {
  using namespace ctrlora;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* rw = static_cast<const float*>(row);
  if (G <= 0 || C % G != 0 || C / G > kGnThreads) return (int)cudaErrorInvalidValue;
  const bool pairs = (C / G) % 2 == 0;
  cudaError_t err;
  if (dtype == 0) {
    err = pairs ? launch_gn<bf16, 2>(x, sc, bi, rw, y, B, HW, C, G, row_stride, eps, silu, smem, s)
                : launch_gn<bf16, 1>(x, sc, bi, rw, y, B, HW, C, G, row_stride, eps, silu, smem, s);
  } else if (dtype == 1) {
    err = pairs ? launch_gn<float, 2>(x, sc, bi, rw, y, B, HW, C, G, row_stride, eps, silu, smem, s)
                : launch_gn<float, 1>(x, sc, bi, rw, y, B, HW, C, G, row_stride, eps, silu, smem, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
