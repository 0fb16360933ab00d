// Tile helpers shared by the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Every kernel works on 64 x 64 tiles of the (query, key) score matrix with
// 256 threads.  Thread t owns the 4 x 4 register micro-tile of rows
// 4·(t / 16) + i and columns 4·(t % 16) + j, i, j < 4; the 16 threads of one
// row group sit in one half-warp, so a row's max and sum reduce with four
// shuffles.  A product whose depth is the head dim D reads both operands
// transposed from shared memory, [d][row] with row stride kLdt, one float4
// of each per step of d: 16 FMAs for two 16-byte shared loads.  A product
// whose depth is the tile (P·V, dS·K, ...) reads the left operand as a
// [depth][row] tile and the right one row-major [depth][D]; thread t then
// owns head-dim columns (t % 16) + 16·c, c < DPT, of its four rows.
//
// All math is f32 (the JAX package's Precision.HIGHEST contract).
#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 256;
constexpr int kB = 64;        // tile rows and columns
constexpr int kLdt = kB + 4;  // stride of a transposed tile: float4 aligned
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ int tile_row() { return threadIdx.x / 16; }
__device__ __forceinline__ int tile_col() { return threadIdx.x % 16; }

// dst[d][r] = src[row0 + r][d] for r < kB, d < D; rows at or past `rows`
// read as 0.  `src` is a row-major (*, D) matrix, D % 4 == 0.
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                int row0, int rows, int D) {
  const int n4 = kB * D / 4;
  for (int v = threadIdx.x; v < n4; v += kThreads) {
    const int r = (v * 4) / D, d = v * 4 - r * D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D + d);
    dst[(d + 0) * kLdt + r] = x.x;
    dst[(d + 1) * kLdt + r] = x.y;
    dst[(d + 2) * kLdt + r] = x.z;
    dst[(d + 3) * kLdt + r] = x.w;
  }
}

// dst[r][d] = src[row0 + r][d], row-major with stride D; rows at or past
// `rows` read as 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int D) {
  const int n4 = kB * D / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + static_cast<size_t>(row0) * D);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int valid4 = rows * D / 4;
  for (int v = threadIdx.x; v < n4; v += kThreads)
    d4[v] = v < valid4 ? s4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// c[i][j] = sum_d aT[d][4·tr + i] · bT[d][4·tc + j].
__device__ __forceinline__ void mm_tile(const float* aT, const float* bT, int D,
                                        float c[4][4]) {
  const int tr = tile_row(), tc = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(aT + d * kLdt + 4 * tr);
    const float4 b = *reinterpret_cast<const float4*>(bT + d * kLdt + 4 * tc);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// dst[4·tc + j][4·tr + i] = c[i][j]: the micro-tile stored transposed, as
// the [depth][row] left operand of acc_update.
__device__ __forceinline__ void store_transposed(float* dst, const float c[4][4]) {
  const int tr = tile_row(), tc = tile_col();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (4 * tc + j) * kLdt + 4 * tr) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
}

// acc[i][c] += sum_{k < kB} lT[k][4·tr + i] · r[k][tc + 16·c], r row-major
// (kB, D).
template <int DPT>
__device__ __forceinline__ void acc_update(const float* lT, const float* r, int D,
                                           float acc[4][DPT]) {
  const int tr = tile_row(), tc = tile_col();
#pragma unroll 4
  for (int k = 0; k < kB; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(lT + k * kLdt + 4 * tr);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tc + 16 * c;
      const float x = d < D ? r[k * D + d] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(av[i], x, acc[i][c]);
    }
  }
}

// The max and the sum over the 16 threads of a row group.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Head dims per thread in acc_update: ceil(D / 16), rounded up to 1, 2, 4
// or 8; 0 when D is not a multiple of 8 in [8, 128].
inline int dims_per_thread(int D) {
  if (D < 8 || D > 128 || D % 8 != 0) return 0;
  return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8;
}

}  // namespace flash
