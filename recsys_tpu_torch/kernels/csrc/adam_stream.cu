// Elementwise Adam stream, in place, for Hopper (sm_90a).
//
// Replaces: recsys_tpu/tools/stream_probe.py::_pallas_adam_kernel, called by
// probe_pallas_adam_stream.  Over n f32 elements of p, m, v (updated in
// place) and g (read):
//   m = b1·m + (1−b1)·g,  v = b2·v + (1−b2)·g·g,  p = p − lr·m / (√v + eps)
// with no bias correction: a pure stream, the probe of how fast the card
// moves an optimizer's 7 bytes of traffic per parameter byte.
//
// Bound on the H100: bytes.  Each element reads p, m, v, g and writes p, m,
// v: 28 bytes for about 10 flops.  At the probe's 26 tables of 100,000 x 16
// that is 1.165 GB a pass, 0.348 ms at 3.35 TB/s.
//
// Design: a grid-stride loop, each thread four elements at a time with
// 16-byte loads and stores when every pointer is 16-byte aligned, and a
// scalar tail for a count that is not a multiple of 4.  The arithmetic is
// written with round-to-nearest intrinsics (__fmul_rn, __fadd_rn, ...), so
// nvcc cannot contract b1·m + (1−b1)·g into an FMA: each operation rounds
// once, as the plain PyTorch version's separate operations do, and the
// kernel is held to it bit for bit.  1−b1 and 1−b2 come from the wrapper,
// rounded once from double as the plain version's scalars are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr;
};

__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, m), __fadd_rn(__fsqrt_rn(v), h.eps)));
}

__global__ void __launch_bounds__(kThreads)
    adam_stream_vec_kernel(float4* __restrict__ p, float4* __restrict__ m,
                           float4* __restrict__ v, const float4* __restrict__ g,
                           long long n4, Hyper h) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = __ldg(g + i);
    adam1(pp.x, mm.x, vv.x, gg.x, h);
    adam1(pp.y, mm.y, vv.y, gg.y, h);
    adam1(pp.z, mm.z, vv.z, gg.z, h);
    adam1(pp.w, mm.w, vv.w, gg.w, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_stream_scalar_kernel(float* __restrict__ p, float* __restrict__ m,
                              float* __restrict__ v, const float* __restrict__ g,
                              long long start, long long n, Hyper h) {
  for (long long i = start + blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam1(pp, mm, vv, __ldg(g + i), h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b < 1 ? 1 : b) : kMaxBlocks);
}

}  // namespace

// p, m, v (n) f32, updated in place; g (n) f32, read.  omb1 = 1 − b1 and
// omb2 = 1 − b2.  Launches on `stream` and returns cudaGetLastError().
extern "C" int adam_stream_launch(void* p, void* m, void* v, const void* g, long long n,
                                  float b1, float omb1, float b2, float omb2, float eps,
                                  float lr, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, lr};
  const uintptr_t align = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  long long done = 0;
  if ((align & 15) == 0 && n >= 4) {
    const long long n4 = n / 4;
    adam_stream_vec_kernel<<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<float4*>(p), static_cast<float4*>(m), static_cast<float4*>(v),
        static_cast<const float4*>(g), n4, h);
    done = n4 * 4;
  }
  if (done < n) {
    adam_stream_scalar_kernel<<<blocks_for(n - done), kThreads, 0, s>>>(
        static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(g), done, n, h);
  }
  return static_cast<int>(cudaGetLastError());
}
