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
// to matter.  What held the first design back was shared memory: each
// output read 2·D scalars from it (a warp-wide wavefront an output), which
// alone took about twice the bytes bound, and each block decoded a pair
// table with sqrtf and divided an output's flat index by P.
//
// Design: a block takes up to 8 examples (kTile) and stages them in shared
// memory as f32, rows padded to a multiple of 4 (zero columns, so every
// row is whole float4s) and each example an odd number of 16-byte chunks
// apart.  The Gram matrix is cut into 4 x 4 blocks of (row, column); a
// lane owns one such block of one example and computes its 16 dot products
// in registers from 16-byte loads: 8 float4 loads feed 64 FMAs, a
// sixteenth of the first design's load instructions an output and a
// quarter of its shared-memory bytes.  The 8 lanes of a quarter warp
// take the same block of 8 different examples, so their loads fall in 8
// different 16-byte bank groups (the odd example stride) and never
// conflict; the 4 quarters of a warp and the 8 warps take the next blocks
// of the triangle.  A lane writes the outputs of its block that lie in the
// packed triangle to a shared output tile at p = i(i-1)/2 + j (i(i+1)/2 + j
// with the diagonal): no pair table and no division.  The tile of a block's
// examples is contiguous in device memory, (tile, P) row-major, so after a
// barrier the block copies it out with 16-byte stores.  No tensor cores:
// an f32 input keeps exact f32 products, and for bf16 a variant with
// mma.sync m16n8k16 (6 a 27-field example, a warp an example) measured
// slower than these FMAs on an H100 (6.33 against 6.23 us at the serving
// shape).  A ragged last tile counts only the rows that exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kTile = 8;                      // examples a block, a quarter warp's lanes
constexpr int kSlots = kThreads / kTile;      // (row, column) blocks in flight a block
constexpr long long kSmemLimit = 227 * 1024;  // opt-in dynamic shared memory

__host__ __device__ inline int num_pairs(int F, int self_interaction) {
  return self_interaction ? F * (F + 1) / 2 : F * (F - 1) / 2;
}
// f32 values a staged row holds: D rounded up to whole float4s
__host__ __device__ inline int row_stride(int D) { return (D + 3) / 4 * 4; }
// f32 values between two staged examples: padded rows, an odd count of float4s
__host__ __device__ inline int example_stride(int F, int D) {
  return 4 * (((F + 3) / 4 * row_stride(D)) | 1);  // (F rounded up to 4) * S / 4 float4s
}
long long example_bytes(int F, int D, int P) {
  return (static_cast<long long>(example_stride(F, D)) + P) * 4;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of input as f32: 4 values of f32, 8 of bf16
__device__ __forceinline__ void unpack(const uint4& u, float (&o)[4]) {
  o[0] = __uint_as_float(u.x), o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z), o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&o)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    dot_interaction_kernel(const T* __restrict__ x, float* __restrict__ out, int B,
                           int F, int D, int P, int tile, int self_interaction) {
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);
  const int S = row_stride(D), ES = example_stride(F, D);
  float* const ys = xs + tile * ES;  // [tile][P], the packed outputs
  const int b0 = blockIdx.x * tile;
  const int rows = min(tile, B - b0);
  const int nb = (F + 3) / 4;  // 4-row blocks of the Gram matrix

  // stage: the tile's rows are contiguous in x.  The padding columns enter
  // every sum, so they are zeroed; the padding rows' products are never
  // written, so they are left as they are.
  const T* xt = x + static_cast<size_t>(b0) * F * D;
  constexpr int kVec = 16 / sizeof(T);
  const int n_in = rows * F * D;
  if (S != D) {
    const int n_pad = rows * ES;
    for (int i = threadIdx.x; i < n_pad; i += kThreads) xs[i] = 0.f;
    __syncthreads();
  }
  if (D % kVec == 0 && (reinterpret_cast<uintptr_t>(xt) & 15) == 0) {
    const int per_row = D / kVec;
    for (int c = threadIdx.x; c < n_in / kVec; c += kThreads) {
      const int r = c / per_row;  // (example, field) row
      const int e = r / F;
      float v[kVec];
      unpack(__ldg(reinterpret_cast<const uint4*>(xt) + c), v);
      float* dst = xs + e * ES + (r - e * F) * S + (c - r * per_row) * kVec;
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < n_in; i += kThreads) {
      const int r = i / D;
      const int e = r / F;
      xs[e * ES + (r - e * F) * S + (i - r * D)] = to_f32(xt[i]);
    }
  }
  __syncthreads();

  // compute: lane (e, slot) takes blocks t = slot, slot + kSlots, ... of
  // the lower triangle of 4 x 4 blocks, t = bi(bi+1)/2 + bj with bj <= bi
  const int e = threadIdx.x % kTile;
  const int slot = threadIdx.x / kTile;
  int bi = 0, bj = slot;
  while (bj > bi) bj -= ++bi;
  if (e < rows) {
    const float* xe = xs + e * ES;
    float* ye = ys + e * P;
    for (; bi < nb;) {
      float acc[4][4] = {};
      const float* xi = xe + 4 * bi * S;
      const float* xj = xe + 4 * bj * S;
      for (int c = 0; c < S; c += 4) {
        float4 a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = *reinterpret_cast<const float4*>(xi + u * S + c);
#pragma unroll
        for (int w = 0; w < 4; ++w) {  // the column rows one at a time: fewer registers
          const float4 b = *reinterpret_cast<const float4*>(xj + w * S + c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // D ascending, as the first design summed
            float s = acc[u][w];
            s = fmaf(a[u].x, b.x, s);
            s = fmaf(a[u].y, b.y, s);
            s = fmaf(a[u].z, b.z, s);
            acc[u][w] = fmaf(a[u].w, b.w, s);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * bi + u;
        const int row0 = self_interaction ? i * (i + 1) / 2 : i * (i - 1) / 2;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 4 * bj + w;
          if (i < F && (j < i || (self_interaction && j == i))) ye[row0 + j] = acc[u][w];
        }
      }
      bj += kSlots;  // the next block of this lane's slot, row by row
      while (bj > bi && bi < nb) bj -= ++bi;
    }
  }
  __syncthreads();

  // write: the tile's (rows, P) outputs are contiguous in out
  float* ot = out + static_cast<size_t>(b0) * P;
  const int n_out = rows * P;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(ot) & 15) == 0) {
    for (int q = threadIdx.x; q < n_out / 4; q += kThreads)
      reinterpret_cast<float4*>(ot)[q] = reinterpret_cast<const float4*>(ys)[q];
    done = n_out / 4 * 4;
  }
  for (int q = done + threadIdx.x; q < n_out; q += kThreads) ot[q] = ys[q];
}

__global__ void empty_kernel() {}

int grid_of(int B, int tile) { return (B + tile - 1) / tile; }

}  // namespace

// Examples a block takes (kTile, fewer where an example's shared memory
// is large), or 0 when the kernel does not take (F, D): no pair, or one
// example past the block's shared memory.  The wrapper uses it to refuse
// shapes up front; kernels/interactions.py::dot_in_domain mirrors it.
extern "C" int dot_interaction_tile(int F, int D, int self_interaction) {
  if (F < 1 || D < 1) return 0;
  const int P = num_pairs(F, self_interaction);
  if (P < 1) return 0;
  const long long tile = kSmemLimit / example_bytes(F, D, P);
  return tile < 1 ? 0 : (tile > kTile ? kTile : static_cast<int>(tile));
}

// x: (B, F, D) f32 or bf16 (x_is_bf16); out: (B, P) f32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dot_interaction_launch(const void* x, void* out, int B, int F,
                                      int D, int self_interaction,
                                      int x_is_bf16, void* stream) {
  const int tile = dot_interaction_tile(F, D, self_interaction);
  if (B < 1 || tile < 1) return cudaErrorInvalidValue;
  const int P = num_pairs(F, self_interaction);
  const size_t smem = static_cast<size_t>(tile) * example_bytes(F, D, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = x_is_bf16 ? reinterpret_cast<const void*>(dot_interaction_kernel<__nv_bfloat16>)
                             : reinterpret_cast<const void*>(dot_interaction_kernel<float>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(grid_of(B, tile));
  if (x_is_bf16) {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), B, F, D, P, tile,
        self_interaction);
  } else {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, F, D, P, tile,
        self_interaction);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel at the grid and block the kernel would
// take for (B, F, D), on `stream`.  Returns cudaGetLastError().
extern "C" int dot_interaction_floor(int B, int F, int D, int self_interaction,
                                     void* stream) {
  const int tile = dot_interaction_tile(F, D, self_interaction);
  if (B < 1 || tile < 1) return cudaErrorInvalidValue;
  empty_kernel<<<grid_of(B, tile), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
