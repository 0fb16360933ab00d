// FM bi-interaction pooling for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/interactions_tpu.py::fm_pairwise_vector_pallas
// (body _fm_kernel).  (B, F, D) f32 or bf16 -> (B, D) f32 with
// out[b, d] = 0.5·((Σ_f x[b, f, d])² − Σ_f x[b, f, d]²), the TPU kernel's
// formula.  Both sums are f32 in registers, taken in field order.
//
// Bound on the H100: memory.  Each input element costs one add and one FMA,
// so only bytes count: the (B, F, D) input once and the (B, D) output once.
// At FM's serving shape (4096 examples, F = 39, D = 16, f32) that is 10.2 MB
// in and 0.26 MB out, about 3.1 us at 3.35 TB/s.
//
// Design: one thread per (example, chunk of VEC columns), where a chunk is
// 16 bytes of one field row (4 f32 or 8 bf16 values) when D splits into such
// chunks and the input is 16-byte aligned, else one value.  Neighbouring
// threads take neighbouring chunks of one example, then the next example:
// at D = 16 a warp covers 8 examples, and at each field it reads 8 fully
// used 64-byte segments.  The TPU kernel held a (512, F, D) tile in VMEM and
// reduced over F in one vector op; here each thread walks the F rows of its
// chunk itself, four rows unrolled so that several loads are in flight, and
// writes its chunk of the output once.  No shared memory and no
// synchronisation: the blocks are independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // small blocks: 4096 x 4 chunks spread over 128 blocks

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_chunk<float, 4>(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

template <>
__device__ __forceinline__ void load_chunk<float, 1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                             float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_chunk<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                             float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fm_interaction_kernel(const T* __restrict__ x, float* __restrict__ out, int B, int F,
                          int D) {
  const int chunks = D / VEC;  // VEC divides D (the launcher picks it so)
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(B) * chunks) return;
  const long long b = t / chunks;
  const int c = static_cast<int>(t - b * chunks);
  const T* p = x + static_cast<size_t>(b) * F * D + static_cast<size_t>(c) * VEC;

  float s[VEC], sq[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = sq[j] = 0.f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    float v[VEC];
    load_chunk<T, VEC>(p + static_cast<size_t>(f) * D, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += v[j];
      sq[j] = fmaf(v[j], v[j], sq[j]);
    }
  }

  float* o = out + static_cast<size_t>(b) * D + static_cast<size_t>(c) * VEC;
  float r[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) r[j] = 0.5f * fmaf(s[j], s[j], -sq[j]);
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      reinterpret_cast<float4*>(o)[j / 4] = make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = r[j];
  }
}

template <typename T, int VEC>
void launch(const void* x, void* out, int B, int F, int D, cudaStream_t s) {
  const long long threads = static_cast<long long>(B) * (D / VEC);
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  fm_interaction_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(out), B, F, D);
}

}  // namespace

// x: (B, F, D) f32 or bf16 (x_is_bf16), contiguous; out: (B, D) f32,
// contiguous.  B, F and D must be at least 1.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int fm_pairwise_vector_launch(const void* x, void* out, int B, int F, int D,
                                         int x_is_bf16, void* stream) {
  if (B < 1 || F < 1 || D < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (x_is_bf16) {
    if (aligned && D % 8 == 0) {
      launch<__nv_bfloat16, 8>(x, out, B, F, D, s);
    } else {
      launch<__nv_bfloat16, 1>(x, out, B, F, D, s);
    }
  } else if (aligned && D % 4 == 0) {
    launch<float, 4>(x, out, B, F, D, s);
  } else {
    launch<float, 1>(x, out, B, F, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}
