// Serial per-row walk over a staged block of rows, for Hopper (sm_90a).
//
// Replaces: recsys_tpu/tools/stream_probe.py::_perrow_kernel, called by
// probe_perrow_vmem.  x (n, W) f32 -> out (1, W) f32, the column sums taken
// in serial row order: acc = 0, then acc += x[i] for i = 0 .. n-1.  The
// probe measures what one program pays per row when it walks rows one at
// a time out of on-chip memory, the access pattern of an in-kernel
// per-row gather or scatter.
//
// Bound on the H100: bytes, 4.19 MB at the probe's 8192 x 128, 1.25 us at
// 3.35 TB/s; the kernel is far slower by design (one block, a dependent
// add per row), and that gap is what the probe reports.
//
// Design: one block, as the TPU kernel is one program: a grid would hide
// the serial per-row cost the probe is after.  Rows are staged from device
// memory into shared memory in chunks of 64 KB, double buffered with
// cp.async (16-byte copies when W % 4 == 0 and x is 16-byte aligned, else
// 4-byte ones), so the next chunk lands while the block walks the current
// one.  Thread c owns column c and adds its rows one per step in row
// order; only adds are involved and their order is the TPU kernel's, so
// the output is bit-equal to the serial plain version.  W is at most 1024
// (one thread a column).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBufBytes = 64 * 1024;  // one of the two staging buffers

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue the copies of rows [r0, r0 + rows) of x into buf.
template <bool VEC>
__device__ __forceinline__ void stage(const float* __restrict__ x, float* buf, long long r0,
                                      int rows, int W) {
  const long long first = r0 * W;
  const int count = rows * W;
  if constexpr (VEC) {
    for (int e = threadIdx.x * 4; e < count; e += blockDim.x * 4) cp_async16(buf + e, x + first + e);
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) cp_async4(buf + e, x + first + e);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(1024)
    perrow_walk_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int W, int R) {
  extern __shared__ float4 smem4[];
  float* const bufs = reinterpret_cast<float*>(smem4);
  const int chunks = (n + R - 1) / R;
  const int c = threadIdx.x;
  float acc = 0.f;
  if (chunks > 0) stage<VEC>(x, bufs, 0, n < R ? n : R, W);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      const long long r1 = static_cast<long long>(k + 1) * R;
      const int rows1 = n - r1 < R ? static_cast<int>(n - r1) : R;
      stage<VEC>(x, bufs + ((k + 1) & 1) * R * W, r1, rows1, W);
    }
    cp_async_commit();  // possibly empty, so chunk k is always the older group
    cp_async_wait_all_but_newest();
    __syncthreads();
    const float* b = bufs + (k & 1) * R * W;
    const int rows = n - k * R < R ? n - k * R : R;
    if (c < W) {
      for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, b[r * W + c]);
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }
  if (c < W) out[c] = acc;
}

}  // namespace

// x (n, W) f32 -> out (W) f32, the serial column sums; 1 <= W <= 1024.
// Launches one block on `stream` and returns cudaGetLastError().
extern "C" int perrow_walk_launch(const void* x, void* out, int n, int W, void* stream) {
  if (n < 0 || W < 1 || W > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int R = kBufBytes / (W * static_cast<int>(sizeof(float)));
  if (R < 1) R = 1;
  const size_t smem = 2ull * R * W * sizeof(float);
  const int threads = (W + 31) / 32 * 32;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) {
    cudaFuncSetAttribute(perrow_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    perrow_walk_kernel<true><<<1, threads, smem, s>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(out), n, W, R);
  } else {
    cudaFuncSetAttribute(perrow_walk_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    perrow_walk_kernel<false><<<1, threads, smem, s>>>(static_cast<const float*>(x),
                                                       static_cast<float*>(out), n, W, R);
  }
  return static_cast<int>(cudaGetLastError());
}
