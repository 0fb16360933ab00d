// Shared by mlp_fwd.cu and mlp_bwd.cu: the tile sizes of a chain of
// matrix products over a row tile, the mma.sync / ldmatrix wrappers, and
// the staging of an f32 (K, N) row-major weight tile into shared memory as
// bf16 (rounded as it is staged).  Included inside each file's anonymous
// namespace, after <cuda_bf16.h> and <stdint.h>.
#pragma once

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per pass
constexpr int kBK = 32;        // weight rows per staged tile, f32 path
constexpr int kBKb = 64;       // weight rows per staged tile, bf16 path
constexpr int kBMf32 = 16;
constexpr int kBMbf16 = 32;
constexpr int kWLd = kBN + 8;  // bf16 per staged weight row (k-major)

// relu that keeps NaN, like jnp.maximum / torch.relu
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (kBKb x kBN) weight tile in flight: thread t holds the 4 columns
// 4 (t % 32) .. +3 of tile rows t / 32 + 8 i.  Rows past K and columns past
// N are zero, so partial tiles need no masking in the mma loop.
constexpr int kTileRegs = kBKb * kBN / 4 / kThreads;

__device__ __forceinline__ void fetch_tile(float4 (&r)[kTileRegs],
                                           const float* __restrict__ W, int K,
                                           int N, int k0, int n0, bool vec) {
  const int n = n0 + (threadIdx.x & 31) * 4;
#pragma unroll
  for (int i = 0; i < kTileRegs; ++i) {
    const int k = k0 + (threadIdx.x >> 5) + 8 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < K) {
      const float* row = W + static_cast<size_t>(k) * N;
      if (vec) {
        if (n < N) v = *reinterpret_cast<const float4*>(row + n);
      } else {
        if (n < N) v.x = row[n];
        if (n + 1 < N) v.y = row[n + 1];
        if (n + 2 < N) v.z = row[n + 2];
        if (n + 3 < N) v.w = row[n + 3];
      }
    }
    r[i] = v;
  }
}

// Round the tile to bf16 into shared memory, k-major: row k holds kBN
// columns at a stride of kWLd (the 16-byte pad keeps ldmatrix rows on
// distinct banks).
__device__ __forceinline__ void store_tile(__nv_bfloat16* wt,
                                           const float4 (&r)[kTileRegs]) {
  const int c = (threadIdx.x & 31) * 4;
#pragma unroll
  for (int i = 0; i < kTileRegs; ++i) {
    const int kk = (threadIdx.x >> 5) + 8 * i;
    __nv_bfloat162 lo = __floats2bfloat162_rn(r[i].x, r[i].y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(r[i].z, r[i].w);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(wt + kk * kWLd + c) = v;
  }
}
