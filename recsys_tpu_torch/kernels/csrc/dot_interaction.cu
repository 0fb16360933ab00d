// DLRM dot interaction for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/interactions_tpu.py::dot_interaction_pallas
// (body _dot_kernel).  (B, F, D) f32 or bf16 -> (B, P) f32, the packed lower
// triangle of each example's Gram matrix X·Xᵀ in np.tril_indices row-major
// order, strict (P = F(F-1)/2) or with the diagonal (P = F(F+1)/2).
//
// Bound on the H100: memory.  At the serving shape (4096 examples, F = 27,
// D = 16, bf16) it reads 3.5 MB and writes 5.75 MB, about 2.8 us at
// 3.35 TB/s; its 2·B·P·D flops are ~1% of what the tensor cores would need
// to matter.
//
// Design: each block takes a tile of up to 8 examples, so a 4096-row slice
// spreads over ~4 blocks per SM and each thread has only a load or two in
// flight before it computes.  The tile is contiguous in device memory, so
// the block reads it with coalesced 16-byte loads into shared memory as f32
// (row stride D|1, odd, so lanes that read different field rows of one
// example hit different banks).  The (i, j) pair of every
// packed output slot is computed once per block into a shared table.  The
// block's outputs are also contiguous, (tile, P) row-major, so thread t
// walks flat output slots t, t + blockDim, ... and each warp writes 32
// neighbouring floats.  Each slot is one D-long f32 dot product from
// shared memory.  No tensor cores: the work is far too small per byte.
// A ragged last tile is handled by counting only the rows that exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in attribute needed
constexpr int kMaxTile = 8;  // small tiles: ~4 blocks per SM at 4096 rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_interaction_kernel(const T* __restrict__ x, float* __restrict__ out,
                           int B, int F, int D, int P, int tile,
                           int self_interaction) {
  extern __shared__ float smem[];
  int* pairs = reinterpret_cast<int*>(smem);  // (i << 16) | j, P entries
  float* xs = smem + P;                       // [tile][F][ds]
  const int ds = D | 1;
  const int b0 = blockIdx.x * tile;
  const int rows = min(tile, B - b0);

  for (int p = threadIdx.x; p < P; p += kThreads) {
    // row i holds i (strict) or i + 1 (with diagonal) slots; invert the
    // triangular number with a float guess and an exact integer fix-up
    int i, start;
    if (self_interaction) {
      i = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
      while (i * (i + 1) / 2 > p) --i;
      while ((i + 1) * (i + 2) / 2 <= p) ++i;
      start = i * (i + 1) / 2;
    } else {
      i = static_cast<int>((sqrtf(8.f * p + 1.f) + 1.f) * 0.5f);
      while (i * (i - 1) / 2 > p) --i;
      while ((i + 1) * i / 2 <= p) ++i;
      start = i * (i - 1) / 2;
    }
    pairs[p] = (i << 16) | (p - start);
  }

  const T* xt = x + static_cast<size_t>(b0) * F * D;
  const int n_in = rows * F * D;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  if ((reinterpret_cast<uintptr_t>(xt) & 15) == 0 && n_in % kVec == 0) {
    for (int v = threadIdx.x; v < n_in / kVec; v += kThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(xt)[v];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int idx = v * kVec + j, row = idx / D;  // (example, field) row
        xs[row * ds + (idx - row * D)] = to_f32(e[j]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < n_in; idx += kThreads) {
      const int row = idx / D;
      xs[row * ds + (idx - row * D)] = to_f32(xt[idx]);
    }
  }
  __syncthreads();

  float* ot = out + static_cast<size_t>(b0) * P;
  const int n_out = rows * P;
  for (int q = threadIdx.x; q < n_out; q += kThreads) {
    const int e = q / P;
    const int pair = pairs[q - e * P];
    const float* xi = xs + (e * F + (pair >> 16)) * ds;
    const float* xj = xs + (e * F + (pair & 0xffff)) * ds;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(xi[k], xj[k], acc);
    ot[q] = acc;
  }
}

}  // namespace

// Largest example tile that fits the shared-memory budget, or 0 when one
// example does not fit.  The wrapper uses it to refuse shapes up front.
extern "C" int dot_interaction_tile(int F, int D, int self_interaction) {
  const int P = self_interaction ? F * (F + 1) / 2 : F * (F - 1) / 2;
  const int per_example = F * (D | 1) * static_cast<int>(sizeof(float));
  const int tile = (kSmemBytes - P * static_cast<int>(sizeof(int))) / per_example;
  return tile < 1 ? 0 : (tile > kMaxTile ? kMaxTile : tile);
}

// x: (B, F, D) f32 or bf16 (x_is_bf16); out: (B, P) f32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dot_interaction_launch(const void* x, void* out, int B, int F,
                                      int D, int self_interaction,
                                      int x_is_bf16, void* stream) {
  const int P = self_interaction ? F * (F + 1) / 2 : F * (F - 1) / 2;
  const int tile = dot_interaction_tile(F, D, self_interaction);
  if (B < 1 || P < 1 || D < 1 || tile < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(P) * sizeof(int) +
                      static_cast<size_t>(tile) * F * (D | 1) * sizeof(float);
  const dim3 grid((B + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), B, F,
        D, P, tile, self_interaction);
  } else {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, F, D, P,
        tile, self_interaction);
  }
  return static_cast<int>(cudaGetLastError());
}
