// Warp-level pieces shared by the flash-attention forward and backward
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu): split-TF32
// products on the tensor cores, fragment loads from shared memory, the
// cp.async staging of row tiles and the quad reductions of the softmax.
//
// Precision.  The port's flash contract is exact f32 (the JAX package's
// Precision.HIGHEST).  A single TF32 pass keeps 10 mantissa bits of each
// operand, about 4e-4 on a logit at D = 32, which the card limits
// (flash_check.py) reject.  So every operand x is split into
// big = tf32(x) and small = tf32(x - big), and each product is
// small·big + big·small + big·big on mma.sync.m16n8k8 TF32 with f32
// accumulation: the dropped small·small is about 2^-22 of the product, the
// order of f32 rounding.  Operands are split once where they are staged
// (a K/V, Q/dO tile), P and dS once where they are made, never per product.
//
// Why mma.sync and not wgmma: at the head dims of this repository (8 to
// 64) a wgmma's N would be 8-64 wide over a 64-row warpgroup tile, and the
// softmax has to run in registers between the two products of every key
// tile; mma.sync keeps each warp's 16 rows, their softmax state and both
// products in one warp with no warpgroup barrier, and its fragments feed P
// straight from the score accumulator (below).
//
// Fragments of m16n8k8 TF32, row.col, lane = 4·g + t (g < 8, t < 4), from
// PTX ISA "mma.m16n8k8" and CUTLASS cute/atom/mma_traits_sm80.hpp
// SM80_16x8x8_F32TF32TF32F32_TN:
//   A (16 x 8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8):   b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A product over keys (P·V, dS·K, ...) takes P from the score accumulator
// with no shuffle: its depth index t stands for key 2t and t+4 for key
// 2t+1, so a = (c0, c2, c1, c3), and the B operand reads rows 2t and 2t+1
// (load_bn).  The sum over keys is the same; only its order changes.
//
// Shared tiles are row-major [row][d] with row stride kStride(DMAX) =
// DMAX + 4 words: every fragment load below is free of bank conflicts at
// DMAX = 8, 16, 32, 64 and 128, and rows stay 16-byte aligned for cp.async.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e9f;

__host__ __device__ constexpr int kStride(int dmax) { return dmax + 4; }

// The head-dim instantiation for D: D rounded up to 8, 16, 32, 64 or 128;
// 0 when D is not a multiple of 8 in [8, 128].
inline int dmax_for(int D) {
  if (D < 8 || D > 128 || D % 8 != 0) return 0;
  return D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a·b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in split TF32: the two cross terms first, then big·big, into a
// fresh accumulator that is then added to c in f32.  The tensor cores round
// each accumulation toward zero, so a chain of products into one
// accumulator drifts.  Measured on the card: accumulating straight into c
// left dk and dv 5x further from float64 than the plain f32 version at S =
// 512, and a fresh accumulator a key tile still left out and dq at AutoInt's
// S = 39 over 2x; with one round-to-nearest add a k-step every output is
// within 1.5x of the plain version's error.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                     const uint32_t bb[2], const uint32_t bs[2]) {
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(x, as, bb);
  mma_tf32(x, ab, bs);
  mma_tf32(x, ab, bb);
  c[0] += x[0];
  c[1] += x[1];
  c[2] += x[2];
  c[3] += x[3];
}

// A fragment of rows r0..r0+15, depth columns k0..k0+7 of a [row][d] tile.
__device__ __forceinline__ void load_a(const uint32_t* x, int st, int r0, int k0,
                                       uint32_t a[4]) {
  const int g = lane_g(), t = lane_t();
  const uint32_t* p = x + (r0 + g) * st + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * st];
  a[2] = p[4];
  a[3] = p[8 * st + 4];
}

// B fragment of X·Yᵀ: n = rows n0..n0+7 of Y, depth = columns k0..k0+7.
__device__ __forceinline__ void load_bt(const uint32_t* y, int st, int n0, int k0,
                                        uint32_t b[2]) {
  const uint32_t* p = y + (n0 + lane_g()) * st + k0 + lane_t();
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment of P·Y over rows r0..r0+7 of Y (permuted as above), n =
// columns d0..d0+7.
__device__ __forceinline__ void load_bn(const uint32_t* y, int st, int r0, int d0,
                                        uint32_t b[2]) {
  const uint32_t* p = y + (r0 + 2 * lane_t()) * st + d0 + lane_g();
  b[0] = p[0];
  b[1] = p[st];
}

// The A fragment of an accumulator tile, split.
__device__ __forceinline__ void a_from_acc(const float c[4], uint32_t ab[4], uint32_t as[4]) {
  split_tf32(c[0], ab[0], as[0]);
  split_tf32(c[2], ab[1], as[1]);
  split_tf32(c[1], ab[2], as[2]);
  split_tf32(c[3], ab[3], as[3]);
}

// s[j] = X[r0..r0+15] · Y[8j..8j+7]ᵀ over nd 8-column depth steps, for the
// j < nt key (or query) groups of the tile; X and Y split (big, small).
template <int NDMAX, int NT>
__device__ __forceinline__ void product_xyt(const uint32_t* xb, const uint32_t* xs, int r0,
                                            const uint32_t* yb, const uint32_t* ys, int st,
                                            int nd, int nt, float s[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NDMAX; ++kk) {
    if (kk >= nd) break;
    uint32_t ab[4], as[4];
    load_a(xb, st, r0, 8 * kk, ab);
    load_a(xs, st, r0, 8 * kk, as);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      uint32_t bb[2], bs[2];
      load_bt(yb, st, 8 * j, 8 * kk, bb);
      load_bt(ys, st, 8 * j, 8 * kk, bs);
      mma3(s[j], ab, as, bb, bs);
    }
  }
}

// o[dt] += P · Y[0..8·nt)[8dt..8dt+7] for dt < nd, P the accumulator tiles
// p[j] (split here, once).
template <int NDMAX, int NT>
__device__ __forceinline__ void product_py(const float p[NT][4], const uint32_t* yb,
                                           const uint32_t* ys, int st, int nd, int nt,
                                           float o[NDMAX][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    uint32_t ab[4], as[4];
    a_from_acc(p[j], ab, as);
#pragma unroll
    for (int dt = 0; dt < NDMAX; ++dt) {
      if (dt >= nd) break;
      uint32_t bb[2], bs[2];
      load_bn(yb, st, 8 * j, 8 * dt, bb);
      load_bn(ys, st, 8 * j, 8 * dt, bs);
      mma3(o[dt], ab, as, bb, bs);
    }
  }
}

// The max and the sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --- staging -----------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// The staging loops below divide by D / 4: a constant where D is the
// instantiation's DMAX (a shift), a division only for other head dims.
#define FLASH_C4_DISPATCH(fn, ...) \
  do {                             \
    if (D == DMAX)                 \
      fn<DMAX / 4>(__VA_ARGS__);   \
    else                           \
      fn<0>(__VA_ARGS__);          \
  } while (0)

template <int C4>
__device__ __forceinline__ void stage_rows_c4(float* dst, int st, const float* src, int row0,
                                              int rows, int valid, int D) {
  const int c4 = C4 ? C4 : D / 4;
  for (int v = threadIdx.x; v < rows * c4; v += blockDim.x) {
    const int r = v / c4, c = 4 * (v - r * c4);
    const bool ok = r < valid;
    cp_async16(dst + r * st + c, ok ? src + static_cast<size_t>(row0 + r) * D + c : src, ok);
  }
}

// Start copying n f32 or int32 words src[i0..i0+n) into dst; words at or
// past `valid` are zero-filled.
__device__ __forceinline__ void stage_words(void* dst, const void* src, int i0, int n,
                                            int valid) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = i < valid;
    cp_async4(static_cast<uint32_t*>(dst) + i,
              ok ? static_cast<const uint32_t*>(src) + i0 + i : src, ok);
  }
}

// Start copying rows row0..row0+rows-1 of the row-major (*, D) matrix src
// into dst [rows][st]; rows at or past `valid` are zero-filled.
template <int DMAX>
__device__ __forceinline__ void stage_rows(float* dst, int st, const float* src, int row0,
                                           int rows, int valid, int D) {
  FLASH_C4_DISPATCH(stage_rows_c4, dst, st, src, row0, rows, valid, D);
}

template <int C4>
__device__ __forceinline__ void split_rows_c4(const float* raw, uint32_t* big, uint32_t* small,
                                              int st, int rows, int D) {
  const int c4 = C4 ? C4 : D / 4;
  for (int v = threadIdx.x; v < rows * c4; v += blockDim.x) {
    const int r = v / c4, o = r * st + 4 * (v - r * c4);
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    uint4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + o) = b;
    *reinterpret_cast<uint4*>(small + o) = s;
  }
}

// big/small = split(raw) for a [rows][st] tile of D columns; raw may be big.
template <int DMAX>
__device__ __forceinline__ void split_rows(const float* raw, uint32_t* big, uint32_t* small,
                                           int st, int rows, int D) {
  FLASH_C4_DISPATCH(split_rows_c4, raw, big, small, st, rows, D);
}

template <int C4>
__device__ __forceinline__ void stage_heads_c4(float* dst, int st, const float* src, int S,
                                               int R, int nh, int D) {
  const int c4 = C4 ? C4 : D / 4;
  for (int v = threadIdx.x; v < nh * R * c4; v += blockDim.x) {
    const int row = v / c4, c = 4 * (v - row * c4), hh = row / R, r = row - hh * R;
    const bool ok = r < S;
    cp_async16(dst + row * st + c, ok ? src + (static_cast<size_t>(hh) * S + r) * D + c : src,
               ok);
  }
}

// Start copying nh heads of S rows each (head hh row r at src + (hh·S + r)·D)
// into rows hh·R + r of dst [nh·R][st], the short-sequence kernels' whole
// heads; rows r >= S are zero-filled.
template <int DMAX>
__device__ __forceinline__ void stage_heads(float* dst, int st, const float* src, int S, int R,
                                            int nh, int D) {
  FLASH_C4_DISPATCH(stage_heads_c4, dst, st, src, S, R, nh, D);
}

// Write rows g and g+8 of a warp's 16 x D accumulator, times f[0] and f[1],
// to dst rows row0 + g (+8) of a (*, D) matrix; rows at or past `rows` are
// skipped.
template <int NDMAX>
__device__ __forceinline__ void store_rows(float* dst, int row0, int rows, int D, int nd,
                                           const float o[NDMAX][4], const float f[2]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
    float* p = dst + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < NDMAX; ++dt) {
      if (dt >= nd) break;
      *reinterpret_cast<float2*>(p + 8 * dt) =
          make_float2(o[dt][2 * h] * f[h], o[dt][2 * h + 1] * f[h]);
    }
  }
}

}  // namespace flash
