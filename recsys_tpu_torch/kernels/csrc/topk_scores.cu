// Fused retrieval scoring + top-k for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/topk_tpu.py::topk_scores_pallas (body
// _topk_kernel).  (Q, D) f32 queries, (N, D) f32 items -> the k best items
// of every query: values (Q, k) f32 and indices (Q, k) int32, best first.
// Equal scores rank the lower item id first (the Pallas kernel's
// min(position) and lax.top_k's rule).  The (Q, N) score matrix never
// exists in device memory.  k <= 16.
//
// Bound on the H100: operations.  2·Q·N·D flops of exact f32 dot products
// on the CUDA cores (67 TFLOP/s; TF32 would break the Precision.HIGHEST
// contract); the bytes, queries and items once and k results a query, are
// far smaller.  Serving block, 8192 queries x 19,203 items x 32: 0.15 ms;
// the sweep shape, 1024 x 1M x 64: 2.0 ms.
//
// Design.  The TPU kernel swept the catalog in order inside one program per
// query block, carrying a (blk_q, k) set in scratch, and selected with a
// k-step argmax loop.  Here a block takes 32·WQ queries (WQ = 4, fewer for
// wide D) and one split of the catalog, so a small query batch still fills
// the card: the grid is (query blocks, catalog splits).  The block stages
// its queries in shared memory (row stride odd in 16-byte units, so the
// lanes' 16-byte loads of 32 different rows do not collide) and then walks
// its split in tiles of items staged with coalesced 16-byte loads.  A warp
// has 32 queries, one a lane, and the 4 warps of a query group share out
// the tile's items, 8 at a time: every lane reads the same item chunk (a
// shared-memory broadcast) and its own query chunk, and keeps 8 exact f32
// dot products in flight.  Each lane holds its running best KP (k rounded
// up to a power of two) as a sorted list in registers; a score enters only
// if it beats the list's last entry, by one pass of compare-and-swap.  At
// the end the 4 lists of a query meet in shared memory and one lane merges
// them.  With more than one split, a second small kernel merges the splits'
// k-lists of each query.  Both merges use the same (score desc, id asc)
// order, so the result does not depend on the split or the visiting order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsN = 4;   // warps of a query group sharing a tile's items
constexpr int kUnroll = 8;   // items scored at once by a lane
constexpr int kMaxThreads = 32 * kWarpsN * 4;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (s, j) into the sorted list (v, id), dropping its last entry.
template <int KP>
__device__ __forceinline__ void insert(float (&v)[KP], int (&id)[KP], float s, int j) {
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    if (better(s, j, v[t], id[t])) {
      const float tv = v[t];
      const int ti = id[t];
      v[t] = s;
      id[t] = j;
      s = tv;
      j = ti;
    }
  }
}

template <int KP>
__device__ __forceinline__ void init(float (&v)[KP], int (&id)[KP]) {
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    v[t] = -INFINITY;
    id[t] = INT32_MAX;
  }
}

template <int KP>
__global__ void __launch_bounds__(kMaxThreads)
    topk_kernel(const float4* __restrict__ q, const float4* __restrict__ items, int Q, int N,
                int d4, int k, int tile_n, int per_split, float* __restrict__ dst_v,
                int* __restrict__ dst_i) {
  extern __shared__ float4 smem[];
  const int nthreads = blockDim.x;
  const int bq = nthreads / kWarpsN;  // queries per block
  const int qstride = d4 | 1;
  float4* qs = smem;                  // [bq][qstride]
  float4* its = smem + bq * qstride;  // [tile_n][d4]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = warp / kWarpsN, gn = warp - gq * kWarpsN;
  const int q0 = blockIdx.x * bq;
  const int splits = gridDim.y, split = blockIdx.y;
  const int n0 = split * per_split, n1 = min(N, n0 + per_split);

  for (int x = threadIdx.x; x < bq * d4; x += nthreads) {
    const int r = x / d4, c = x - r * d4;
    qs[r * qstride + c] = q0 + r < Q ? q[static_cast<size_t>(q0 + r) * d4 + c]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float bv[KP];
  int bi[KP];
  init(bv, bi);
  const float4* myq = qs + (gq * 32 + lane) * qstride;

  for (int base = n0; base < n1; base += tile_n) {
    const int cnt = min(tile_n, n1 - base);
    __syncthreads();  // the last tile is consumed (and the queries staged)
    const float4* src = items + static_cast<size_t>(base) * d4;
    for (int x = threadIdx.x; x < cnt * d4; x += nthreads) its[x] = src[x];
    __syncthreads();
    for (int t0 = gn * kUnroll; t0 < cnt; t0 += kWarpsN * kUnroll) {
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
      const float4* it = its + t0 * d4;
      for (int c = 0; c < d4; ++c) {
        const float4 a = myq[c];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 x = it[u * d4 + c];  // one address across the warp
          acc[u] = fmaf(a.x, x.x, acc[u]);
          acc[u] = fmaf(a.y, x.y, acc[u]);
          acc[u] = fmaf(a.z, x.z, acc[u]);
          acc[u] = fmaf(a.w, x.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + t0 + u;
        if (t0 + u < cnt && better(acc[u], j, bv[KP - 1], bi[KP - 1])) {
          insert(bv, bi, acc[u], j);
        }
      }
    }
  }

  // the kWarpsN lists of each query meet in shared memory
  __syncthreads();
  float* lv = reinterpret_cast<float*>(smem);  // [bq][kWarpsN][KP]
  int* li = reinterpret_cast<int*>(lv + bq * kWarpsN * KP);
  const int row = gq * 32 + lane;
  {
    const int at = (row * kWarpsN + gn) * KP;
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      lv[at + t] = bv[t];
      li[at + t] = bi[t];
    }
  }
  __syncthreads();
  if (gn != 0) return;
  for (int w = 1; w < kWarpsN; ++w) {
    const int at = (row * kWarpsN + w) * KP;
    for (int t = 0; t < KP; ++t) {  // each list is sorted: stop at the first loser
      const float s = lv[at + t];
      const int j = li[at + t];
      if (!better(s, j, bv[KP - 1], bi[KP - 1])) break;
      insert(bv, bi, s, j);
    }
  }
  const int qq = q0 + row;
  if (qq >= Q) return;
  const size_t out = (static_cast<size_t>(qq) * splits + split) * k;
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    if (t < k) {
      dst_v[out + t] = bv[t];
      dst_i[out + t] = bi[t];
    }
  }
}

// One thread a query: merge its `splits` sorted k-lists.
template <int KP>
__global__ void __launch_bounds__(kMergeThreads)
    topk_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi, int Q,
                      int splits, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  const int qq = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qq >= Q) return;
  float bv[KP];
  int bi[KP];
  init(bv, bi);
  for (int s = 0; s < splits; ++s) {
    const size_t at = (static_cast<size_t>(qq) * splits + s) * k;
    for (int t = 0; t < k; ++t) {
      if (!better(pv[at + t], pi[at + t], bv[KP - 1], bi[KP - 1])) break;
      insert(bv, bi, pv[at + t], pi[at + t]);
    }
  }
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    if (t < k) {
      out_v[static_cast<size_t>(qq) * k + t] = bv[t];
      out_i[static_cast<size_t>(qq) * k + t] = bi[t];
    }
  }
}

int round_kp(int k) {
  int kp = 1;
  while (kp < k) kp <<= 1;
  return kp;
}

const void* kernel_of(int kp) {
  switch (kp) {
    case 1: return reinterpret_cast<const void*>(topk_kernel<1>);
    case 2: return reinterpret_cast<const void*>(topk_kernel<2>);
    case 4: return reinterpret_cast<const void*>(topk_kernel<4>);
    case 8: return reinterpret_cast<const void*>(topk_kernel<8>);
    default: return reinterpret_cast<const void*>(topk_kernel<16>);
  }
}

}  // namespace

// The launch plan for Q queries, N items of d4 16-byte chunks and k:
// plan = {threads, tile_n, splits, per_split, smem bytes}.  Returns 0 when
// the shape is outside the kernel's domain (k not in [1, 16], N <= k, or D
// too wide for shared memory), else 1.
extern "C" int topk_scores_plan(int Q, int N, int d4, int k, int* plan) {
  if (Q < 1 || k < 1 || k > 16 || N <= k || d4 < 1) return 0;
  const int kp = round_kp(k);
  const int tile_n = d4 <= 16 ? 128 : (d4 <= 32 ? 64 : 32);
  int wq = 4;
  long long smem = 0;
  for (; wq >= 1; wq >>= 1) {
    const long long bq = 32LL * wq;
    const long long stage = (bq * (d4 | 1) + static_cast<long long>(tile_n) * d4) * 16;
    const long long lists = bq * kWarpsN * kp * 8;
    smem = stage > lists ? stage : lists;
    if (smem <= kSmemLimit) break;
  }
  if (wq < 1) return 0;
  const int threads = 32 * kWarpsN * wq;
  const void* fn = kernel_of(kp);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    static_cast<size_t>(smem)) != cudaSuccess ||
      per_sm < 1) {
    return 0;
  }
  // split the catalog so the grid fills the card once, each split at least
  // one tile
  const int qblocks = (Q + 32 * wq - 1) / (32 * wq);
  int splits = sms * per_sm / qblocks;
  const int max_splits = (N + tile_n - 1) / tile_n;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  int per_split = (N + splits - 1) / splits;
  per_split = (per_split + tile_n - 1) / tile_n * tile_n;
  splits = (N + per_split - 1) / per_split;
  plan[0] = threads;
  plan[1] = tile_n;
  plan[2] = splits;
  plan[3] = per_split;
  plan[4] = static_cast<int>(smem);
  return 1;
}

// q: (Q, 4·d4) f32, items: (N, 4·d4) f32, both 16-byte aligned; out_v (Q, k)
// f32 and out_i (Q, k) int32; part_v / part_i (Q, splits, k) scratch when
// splits > 1 (else unused).  `plan` from topk_scores_plan with the same
// shape.  Launches on `stream` and returns cudaGetLastError().
extern "C" int topk_scores_launch(const void* q, const void* items, void* out_v, void* out_i,
                                  void* part_v, void* part_i, int Q, int N, int d4, int k,
                                  const int* plan, void* stream) {
  if (Q < 1 || k < 1 || k > 16 || N <= k || d4 < 1) return cudaErrorInvalidValue;
  const int threads = plan[0], tile_n = plan[1], splits = plan[2], per_split = plan[3];
  const size_t smem = static_cast<size_t>(plan[4]);
  if (splits > 1 && (part_v == nullptr || part_i == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bq = threads / kWarpsN;
  const dim3 grid((Q + bq - 1) / bq, splits);
  float* dv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* di = static_cast<int*>(splits > 1 ? part_i : out_i);
  const float4* qp = static_cast<const float4*>(q);
  const float4* ip = static_cast<const float4*>(items);
  const int kp = round_kp(k);
#define RECSYS_TOPK_CASE(KP)                                                              \
  case KP:                                                                                \
    topk_kernel<KP><<<grid, threads, smem, s>>>(qp, ip, Q, N, d4, k, tile_n, per_split,  \
                                                dv, di);                                  \
    if (splits > 1) {                                                                     \
      topk_merge_kernel<KP><<<(Q + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,  \
                              s>>>(dv, di, Q, splits, k, static_cast<float*>(out_v),      \
                                   static_cast<int*>(out_i));                             \
    }                                                                                     \
    break;
  switch (kp) {
    RECSYS_TOPK_CASE(1)
    RECSYS_TOPK_CASE(2)
    RECSYS_TOPK_CASE(4)
    RECSYS_TOPK_CASE(8)
    RECSYS_TOPK_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef RECSYS_TOPK_CASE
  return static_cast<int>(cudaGetLastError());
}
