// Row unpack of one DDIM step's hoisted time-embedding rows for Hopper
// (sm_90a), one launch per step: kernel D of the port.
//
// Replaces the TPU kernel ctrlora_tpu/ops/unpack_rows.py `_unpack_kernel`
// :32 (launched from `unpack_rows` :58) and computes what it computes: row
// i of the result is block[i, :C_i] of the step's padded [n, Cmax] block,
// all n rows from one launch, written back to back into one flat buffer
// (the wrapper hands out [1, C_i] views of it).
//
// What bounds it on the H100: ~120 KB of reads and writes at n = 32, so
// neither bytes nor operations but the launch, and on a host-bound step the
// host's time to issue it. So the layout (each row's bytes and output
// offset; n is the grid) travels in the kernel's parameters as one
// __grid_constant__ struct: no device tensor holds it, nothing is copied to
// the card at first use, and a CUDA graph can capture the launch as it is. One block copies
// one row in 16-byte pieces (every row's bytes and offset are multiples of
// 16, which the wrapper checks).

#include "common.cuh"

namespace ctrlora {
namespace {

constexpr int kUnpackMaxRows = 64;  // rows the layout struct holds
constexpr int kUnpackThreads = 128;

struct UnpackLayout {  // row i of the grid's n: its used bytes, its place in the output
  int bytes[kUnpackMaxRows];
  int offset[kUnpackMaxRows];
};

__global__ void __launch_bounds__(kUnpackThreads)
unpack_rows_kernel(const unsigned char* __restrict__ block, unsigned char* __restrict__ out,
                   long long row_stride, const __grid_constant__ UnpackLayout layout) {
  const int i = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(block + i * row_stride);
  uint4* dst = reinterpret_cast<uint4*>(out + layout.offset[i]);
  for (int v = threadIdx.x; v < layout.bytes[i] / 16; v += kUnpackThreads) dst[v] = src[v];
}

}  // namespace
}  // namespace ctrlora

// block: [n, Cmax] with unit column stride, rows row_stride bytes apart,
// 16-byte aligned; out: the flat output; bytes, offsets: int[n] (multiples
// of 16); n <= the capacity ctrlora_unpack_rows_capacity() reports
extern "C" int ctrlora_unpack_rows(const void* block, void* out, long long row_stride,
                                   const int* bytes, const int* offsets, int n, void* stream) {
  using namespace ctrlora;
  if (n <= 0 || n > kUnpackMaxRows || row_stride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  UnpackLayout layout;
  for (int i = 0; i < n; ++i) {
    if (bytes[i] % 16 != 0 || offsets[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    layout.bytes[i] = bytes[i];
    layout.offset[i] = offsets[i];
  }
  unpack_rows_kernel<<<n, kUnpackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(block), static_cast<unsigned char*>(out), row_stride,
      layout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctrlora_unpack_rows_capacity() { return ctrlora::kUnpackMaxRows; }
