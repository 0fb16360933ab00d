// Pooled embedding gather (masked segment sum) for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/embedding_tpu.py::pooled_gather_pallas
// (body _pooled_gather_kernel).  (V, D) f32 or bf16 table, (B, L) int32 row
// ids, (B, L) uint8 mask (nonzero = a real position) -> (B, D) f32, the sum
// of each example's unmasked rows.  An example with no unmasked row gets 0.
// The mean and sqrtn scalings are applied outside, as around the TPU kernel.
//
// Bound on the H100: memory.  The work is one f32 add per gathered element,
// so only bytes count: the ids and mask (5 bytes a position), the rows that
// are read and the (B, D) output.  At the serving block (8192 histories of
// 50, D = 32, f32) that is at most 2 MB of ids and mask, 1 MB of output and
// 52 MB of rows when every position is real; the catalog itself is 2.5 MB,
// so repeated rows come from L2.
//
// Design: one warp per example, no shared state between warps, so the
// block never synchronises.  The TPU kernel fetched one row per DMA, double
// buffered; here a warp reads 32 positions' ids and mask with one coalesced
// load each, compacts the real positions with a ballot (so padding costs no
// row load at all) and stages their ids in shared memory.  The warp's lanes
// are split into groups of T lanes, T the number of 16-byte chunks of a row
// (rounded up to a power of two, at most 32): each group reads whole rows
// with 16-byte loads, kUnroll rows in flight per group, and accumulates in
// f32 registers.  The groups' partial sums meet through warp shuffles and
// one group stores the row of output once.  A row wider than 32 chunks is
// walked in column blocks of 32 chunks.  Widths that do not split into
// 16-byte chunks (or a misaligned table) take the same path one element a
// lane at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // examples per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // rows in flight per lane group

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 8>(const __nv_bfloat16* p,
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
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                           float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    pooled_gather_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                         const uint8_t* __restrict__ mask, float* __restrict__ out,
                         int B, int L, int D) {
  __shared__ int ids[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below synchronises the block
  const int chunks = D / VEC;
  int tpr = 1;  // lanes per row
  while (tpr < chunks && tpr < 32) tpr <<= 1;
  const int groups = 32 / tpr;
  const int g = lane / tpr, c_lane = lane - g * tpr;
  const int* rb = rows + static_cast<size_t>(b) * L;
  const uint8_t* mb = mask + static_cast<size_t>(b) * L;
  float* ob = out + static_cast<size_t>(b) * D;

  for (int c0 = 0; c0 < chunks; c0 += tpr) {
    const int c = c0 + c_lane;
    const bool col = c < chunks;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const bool real = l < L && mb[l] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, real);
      const int n = __popc(bal);
      if (real) ids[warp][__popc(bal & ((1u << lane) - 1u))] = rb[l];
      __syncwarp();
      for (int j = g; j < n; j += groups * kUnroll) {
        float v[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = j + u * groups;
          if (col && jj < n) {
            load_row<T, VEC>(table + static_cast<size_t>(ids[warp][jj]) * D + c * VEC, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += v[u][e];
        }
      }
      __syncwarp();  // every lane is done with ids before the next 32 positions
    }
    // the groups' partial sums of the same chunk meet
    for (int off = tpr; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (g == 0 && col) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          reinterpret_cast<float4*>(ob + c * VEC)[e / 4] =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) ob[c * VEC + e] = acc[e];
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* table, const void* rows, const void* mask, void* out, int B, int L,
            int D, cudaStream_t s) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  pooled_gather_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int*>(rows),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), B, L, D);
}

}  // namespace

// table: (V, D) f32 or bf16 (table_is_bf16); rows: (B, L) int32; mask: (B, L)
// uint8; out: (B, D) f32, 16-byte aligned.  Row ids must lie in [0, V).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pooled_gather_launch(const void* table, const void* rows, const void* mask,
                                    void* out, int B, int L, int D, int table_is_bf16,
                                    void* stream) {
  if (B < 1 || L < 0 || D < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  if (table_is_bf16) {
    if (aligned && D % 8 == 0) {
      launch<__nv_bfloat16, 8>(table, rows, mask, out, B, L, D, s);
    } else {
      launch<__nv_bfloat16, 1>(table, rows, mask, out, B, L, D, s);
    }
  } else if (aligned && D % 4 == 0) {
    launch<float, 4>(table, rows, mask, out, B, L, D, s);
  } else {
    launch<float, 1>(table, rows, mask, out, B, L, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}
