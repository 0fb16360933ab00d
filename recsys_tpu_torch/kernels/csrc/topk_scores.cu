// Fused retrieval scoring + top-k for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/topk_tpu.py::topk_scores_pallas (body
// _topk_kernel).  (Q, D) f32 queries, (N, D) f32 items -> the k best items
// of every query: values (Q, k) f32 and indices (Q, k) int32, best first.
// Equal scores rank the lower item id first (the Pallas kernel's
// min(position) and lax.top_k's rule).  The (Q, N) score matrix never
// exists in device memory.  k <= 16, D <= 128.
//
// Bound on the H100: operations.  The scores are f32 dot products to the
// Precision.HIGHEST contract, made on the tensor cores in split TF32 as the
// flash kernels make theirs (flash_tiles.cuh): each operand x is split into
// a TF32 big part and a small one, x - big, and a product is small·big +
// big·small + big·big on mma.sync.m16n8k8, accumulated straight into the
// score: a chain of 3·D/8 products, each rounded toward zero by the tensor
// cores, stays within about 3·D/8 f32 ulps of it (a fresh accumulator a
// k-step, as the flash kernels keep, costs four adds a product).
// That is 3 x 2·Q·N·D operations at 495 TFLOP/s: 0.061 ms at the serving
// block (8192 queries x 19,203 items x 32), 0.794 ms at the sweep shape
// (1024 x 1M x 64).  The dropped small·small, the small parts' lost low
// bits and the tensor cores' rounding leave a score within about 2^-20 of
// |q|·|x| of the exact one, inside retrieval_check.SCORE_RTOL (1e-5, about
// 2^-16.6).  Equal item rows score bit-equal: each score
// comes from the same operands in the same order wherever the item sits in
// a tile.
//
// Design.  The TPU kernel swept the catalog in order inside one program per
// query block, carrying a (blk_q, k) set in scratch, and selected with a
// k-step argmax loop.  Here a block takes 128 queries, 16 a warp, and one
// split of the catalog; the grid is (query blocks, catalog splits), the
// splits sized so that the card holds its blocks at once.  Each warp splits
// its 16 query rows into A fragments once and keeps them in registers for
// the whole sweep (8 registers a k-step of 8 columns; D is padded to a
// multiple of 8 with zero columns, which changes no score).  The block
// walks its split in tiles of items through a ring of three shared-memory
// buffers filled by cp.async two tiles ahead, one barrier a tile; every
// warp scores all of a tile against its rows.  A lane splits each item
// value of its B fragment as it loads it: big keeps the value's top 19
// bits (a TF32 value), small = x - big exactly, of which the tensor cores
// keep the top 19 bits again, about 2^-20 of |x| short.  Splitting a tile
// once as it is staged would double the shared-memory bytes a product
// reads and add a pass over the tile between two barriers.
//
// Selection is a threshold filter.  Rows g and g + 8 of a warp's C fragment
// sit in the 4 lanes of quad g, which keep each row's running k-th best
// score as a threshold, raised to the best k-th that any split of the
// catalog has published for the query (a word a query in global memory,
// atomicMax of the score's ordered bits; another split's k-th may still be
// tied by a lower id here, so it bounds as >=).  A score that does not
// beat the threshold costs one compare; one that does is appended to the
// row's candidate buffer in shared memory by the lane that holds it (a
// shared atomic on the row's fill count).  At a tile's start, where any
// row of the block holds more than kLowFill candidates, every warp merges
// (a barrier vote: a merge costs the block its slowest warp, so merges are
// taken together); a warp also merges at once where a buffer could
// overflow in its next group of 32 items, and at the sweep's end.  In a
// merge lane r takes row r's buffer into the row's sorted list (score
// desc, id asc; in shared memory between merges, in registers during one,
// each insertion's compares made before its moves) and the quads reload
// their thresholds.  A warp visits its items in increasing id order, so a
// score equal to its own k-th comes after the list's k-th entry and
// rightly loses: the strict compare is exact.  With more than one split, a
// second small kernel merges the splits' k-lists of each query in the same
// order, so the result depends on neither the split nor the visiting order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                  // query rows a warp: one m16 tile
constexpr int kBlockQ = kRows * kWarps;    // queries a block
constexpr int kMaxD = 128;                 // the widest D the registers hold
constexpr int kGroupTiles = 4;             // n8 tiles scored between selections
constexpr int kGroup = 8 * kGroupTiles;    // items a selection step
constexpr int kCap = 64;                   // a row's candidate buffer
constexpr int kCapStride = kCap + 1;
constexpr int kLowFill = 16;  // candidates a row may carry into the next tile
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (s, j) into the sorted list (v, id), dropping its last entry:
// every compare first, then every move, so the steps do not wait on each
// other (a list's entries all below (s, j) leave it as it was).
template <int KP>
__device__ __forceinline__ void insert(float (&v)[KP], int (&id)[KP], float s, int j) {
  bool above[KP];
#pragma unroll
  for (int t = 0; t < KP; ++t) above[t] = better(s, j, v[t], id[t]);
#pragma unroll
  for (int t = KP - 1; t > 0; --t) {
    v[t] = above[t - 1] ? v[t - 1] : (above[t] ? s : v[t]);
    id[t] = above[t - 1] ? id[t - 1] : (above[t] ? j : id[t]);
  }
  v[0] = above[0] ? s : v[0];
  id[0] = above[0] ? j : id[0];
}

template <int KP>
__device__ __forceinline__ void init(float (&v)[KP], int (&id)[KP]) {
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    v[t] = -INFINITY;
    id[t] = INT32_MAX;
  }
}

// A float's bits mapped so that unsigned order is the float order (-0.0
// read as +0.0); 0 is below every float.
__device__ __forceinline__ unsigned ordered(float s) {
  const unsigned b = __float_as_uint(s + 0.0f);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_ordered(unsigned o) {
  return o == 0 ? -INFINITY : __uint_as_float(o & 0x80000000u ? o & 0x7fffffffu : ~o);
}

// Shared memory of a block: kStages item tiles [tile_n][8·nd + 4] (the
// row stride makes every B-fragment load free of bank conflicts, as
// flash_tiles.cuh's kStride does), the rows' lists [kBlockQ][KP] (values,
// ids), their candidate buffers [kBlockQ][kCapStride] (values, ids) and
// fill counts.
constexpr int kStages = 3;
__host__ __device__ inline int tile_stride(int nd) { return 8 * nd + 4; }
inline long long smem_bytes(int nd, int tile_n, int kp) {
  return 4LL * (static_cast<long long>(kStages) * tile_n * tile_stride(nd) +
                2LL * kBlockQ * kp + 2LL * kBlockQ * kCapStride + kBlockQ);
}
inline int tile_for(int nd) { return nd <= 4 ? 64 : 32; }

// Start copying items base..base+cnt-1 (rows of d4 16-byte chunks) into a
// tile [tile_n][st]; rows past cnt and the pad chunk are zero-filled.
__device__ __forceinline__ void stage_tile(float* tile, const float* items, int base, int cnt,
                                           int tile_n, int d4, int nd) {
  const int c8 = 2 * nd, st = tile_stride(nd);
  const int shift = (c8 & (c8 - 1)) == 0 ? __ffs(c8) - 1 : -1;  // D = 8, 16, 32, 64, 128
  for (int v = threadIdx.x; v < tile_n * c8; v += kThreads) {
    const int r = shift >= 0 ? v >> shift : v / c8, c = v - r * c8;
    const bool ok = r < cnt && c < d4;
    flash::cp_async16(tile + r * st + 4 * c,
                      ok ? items + (static_cast<size_t>(base) + r) * 4 * d4 + 4 * c : items, ok);
  }
}

// The big and small TF32 parts of an item value: big keeps its top 19 bits
// (a TF32 value), small = x - big exactly, whose low bits the tensor cores
// drop; the pair carries x to about 2^-20 of |x|.
__device__ __forceinline__ void split_item(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int NDMAX, int KP>
__global__ void __launch_bounds__(kThreads, NDMAX <= 8 ? 2 : 1)
    topk_kernel(const float* __restrict__ q, const float* __restrict__ items, int Q, int N,
                int d4, int k, int tile_n, int per_split, float* __restrict__ dst_v,
                int* __restrict__ dst_i, unsigned* shared_kth) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int D = 4 * d4, nd = (d4 + 1) >> 1, st = tile_stride(nd);
  float* tiles = reinterpret_cast<float*>(smem);
  float* lv = tiles + kStages * tile_n * st;
  int* li = reinterpret_cast<int*>(lv + kBlockQ * KP);
  float* cv = reinterpret_cast<float*>(li + kBlockQ * KP);
  int* ci = reinterpret_cast<int*>(cv + kBlockQ * kCapStride);
  int* cn = ci + kBlockQ * kCapStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ + warp * kRows;
  const int splits = gridDim.y, split = blockIdx.y;
  const int n0 = split * per_split, n1 = min(N, n0 + per_split);
  const int ntiles = (n1 - n0 + tile_n - 1) / tile_n;

  // the first two tiles in flight
  for (int x = 0; x < kStages - 1; ++x) {
    const int base = n0 + x * tile_n;
    if (x < ntiles) stage_tile(tiles + x * tile_n * st, items, base, min(tile_n, n1 - base),
                               tile_n, d4, nd);
    flash::cp_async_commit();
  }

  // the warp's A fragments, split once: a0 (g, t) a1 (g+8, t) a2 (g, t+4)
  // a3 (g+8, t+4) of each k-step
  uint32_t ab[NDMAX][4], as[NDMAX][4];
#pragma unroll
  for (int kk = 0; kk < NDMAX; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = q0 + g + 8 * (x & 1), col = 8 * kk + t + 4 * (x >> 1);
      const float val = kk < nd && row < Q && col < D ? q[static_cast<size_t>(row) * D + col]
                                                      : 0.f;
      flash::split_tf32(val, ab[kk][x], as[kk][x]);
    }
  }

  float* wlv = lv + warp * kRows * KP;
  int* wli = li + warp * kRows * KP;
  float* wcv = cv + warp * kRows * kCapStride;
  int* wci = ci + warp * kRows * kCapStride;
  int* wcn = cn + warp * kRows;
  for (int x = lane; x < kRows * KP; x += 32) {
    wlv[x] = -INFINITY;
    wli[x] = INT32_MAX;
  }
  if (lane < kRows) wcn[lane] = 0;
  // Thresholds of rows g and g + 8, the own k-th (strict) and the published
  // one (>=) as one strict compare: eff = max(own, the float below the
  // published one).  The published word is read a tile before it is used,
  // so the read's round trip to L2 overlaps a tile's products.
  float own0 = -INFINITY, own1 = -INFINITY, eff0 = -INFINITY, eff1 = -INFINITY;
  const bool publishes = shared_kth != nullptr && lane < kRows && q0 + lane < Q;
  unsigned pub = 0;
  auto refresh = [&]() {
    const float f0 = from_ordered(__shfl_sync(0xffffffffu, pub, g));
    const float f1 = from_ordered(__shfl_sync(0xffffffffu, pub, g + 8));
    eff0 = fmaxf(own0, nextafterf(f0, -INFINITY));
    eff1 = fmaxf(own1, nextafterf(f1, -INFINITY));
    if (publishes) pub = __ldcg(shared_kth + q0 + lane);
  };

  // lane r < 16 merges row r's buffer into its list; then every quad
  // reloads its thresholds
  auto merge = [&]() {
    __syncwarp();
    if (lane < kRows) {
      const int n = wcn[lane];
      float v[KP];
      int id[KP];
#pragma unroll
      for (int x = 0; x < KP; ++x) {
        v[x] = wlv[lane * KP + x];
        id[x] = wli[lane * KP + x];
      }
      for (int c = 0; c < n; ++c) {
        const float s = wcv[lane * kCapStride + c];
        const int j = wci[lane * kCapStride + c];
        insert(v, id, s, j);
      }
#pragma unroll
      for (int x = 0; x < KP; ++x) {
        wlv[lane * KP + x] = v[x];
        wli[lane * KP + x] = id[x];
      }
      wcn[lane] = 0;
      const float kth = wlv[lane * KP + k - 1];
      if (publishes && kth > -INFINITY) atomicMax(shared_kth + q0 + lane, ordered(kth));
    }
    __syncwarp();
    own0 = wlv[g * KP + k - 1];
    own1 = wlv[(g + 8) * KP + k - 1];
    refresh();
  };

  // a score that beats its row's threshold goes to the row's buffer; the
  // lane keeps the highest slot it took, for the overflow vote
  int top = -1;
  auto offer = [&](int row, float s, int j) {
    const int at = atomicAdd(wcn + row, 1);
    wcv[row * kCapStride + at] = s;
    wci[row * kCapStride + at] = j;
    top = max(top, at);
  };

  for (int tt = 0; tt < ntiles; ++tt) {
    const int base = n0 + tt * tile_n, cnt = min(tile_n, n1 - base);
    flash::cp_async_wait<kStages - 2>();
    // every thread's copies of tile tt have landed, and every warp is done
    // with tile tt - 1, whose buffer takes tile tt + 2.  Where any row of
    // the block holds more than kLowFill candidates, every warp merges now:
    // merges cost the block their slowest warp, so they are taken together
    const bool full = __syncthreads_or(lane < kRows && wcn[lane] > kLowFill);
    if (tt + kStages - 1 < ntiles) {
      const int nb = base + (kStages - 1) * tile_n;
      stage_tile(tiles + ((tt + kStages - 1) % kStages) * tile_n * st, items, nb,
                 min(tile_n, n1 - nb), tile_n, d4, nd);
    }
    flash::cp_async_commit();
    if (full) {
      merge();
    } else if (tt > 0) {
      refresh();
    }
    const float* tile = tiles + (tt % kStages) * tile_n * st;

    for (int j0 = 0; j0 < cnt; j0 += kGroup) {
      float acc[kGroupTiles][4];
#pragma unroll
      for (int j = 0; j < kGroupTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NDMAX; ++kk) {
        if (kk >= nd) break;
#pragma unroll
        for (int j = 0; j < kGroupTiles; ++j) {
          // B fragment: item j0 + 8j + g, depth 8kk + t and 8kk + t + 4
          const float* p = tile + (j0 + 8 * j + g) * st + 8 * kk + t;
          uint32_t bb[2], bs[2];
          split_item(p[0], bb[0], bs[0]);
          split_item(p[4], bb[1], bs[1]);
          flash::mma_tf32(acc[j], as[kk], bb);
          flash::mma_tf32(acc[j], ab[kk], bs);
          flash::mma_tf32(acc[j], ab[kk], bb);
        }
      }
      // c0 (row g, item 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1) of each
      // n8 tile; items past the tile's end score -inf and enter nowhere
      if (j0 + kGroup > cnt) {
#pragma unroll
        for (int j = 0; j < kGroupTiles; ++j) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (j0 + 8 * j + 2 * t + (x & 1) >= cnt) acc[j][x] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kGroupTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int item = base + j0 + 8 * j + 2 * t + e;
          if (acc[j][e] > eff0) offer(g, acc[j][e], item);
          if (acc[j][2 + e] > eff1) offer(g + 8, acc[j][2 + e], item);
        }
      }
      // a buffer filled past kCap - kGroup could overflow in the next group
      if (__any_sync(0xffffffffu, top >= kCap - kGroup)) merge();
      top = -1;
    }
  }
  __syncwarp();
  const int fill = lane < kRows ? wcn[lane] : 0;
  if (__any_sync(0xffffffffu, fill > 0)) merge();

  if (lane < kRows && q0 + lane < Q) {
    const size_t out = (static_cast<size_t>(q0 + lane) * splits + split) * k;
    for (int x = 0; x < k; ++x) {
      dst_v[out + x] = wlv[lane * KP + x];
      dst_i[out + x] = wli[lane * KP + x];
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

__global__ void topk_empty_kernel() {}

int round_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int NDMAX>
const void* kernel_of_kp(int kp) {
  switch (kp) {
    case 1: return reinterpret_cast<const void*>(topk_kernel<NDMAX, 1>);
    case 2: return reinterpret_cast<const void*>(topk_kernel<NDMAX, 2>);
    case 4: return reinterpret_cast<const void*>(topk_kernel<NDMAX, 4>);
    case 8: return reinterpret_cast<const void*>(topk_kernel<NDMAX, 8>);
    default: return reinterpret_cast<const void*>(topk_kernel<NDMAX, 16>);
  }
}

const void* kernel_of(int ndmax, int kp) {
  switch (ndmax) {
    case 1: return kernel_of_kp<1>(kp);
    case 2: return kernel_of_kp<2>(kp);
    case 4: return kernel_of_kp<4>(kp);
    case 8: return kernel_of_kp<8>(kp);
    default: return kernel_of_kp<16>(kp);
  }
}

bool takes(int Q, int N, int d4, int k) {
  return Q >= 1 && k >= 1 && k <= 16 && N > k && d4 >= 1 && 4 * d4 <= kMaxD;
}

}  // namespace

// The launch plan for Q queries, N items of d4 16-byte chunks and k:
// plan = {threads, tile_n, splits, per_split, smem bytes}.  Returns 0 when
// the shape is outside the kernel's domain (k not in [1, 16], N <= k, or D
// past 128), else 1.
extern "C" int topk_scores_plan(int Q, int N, int d4, int k, int* plan) {
  if (!takes(Q, N, d4, k)) return 0;
  const int nd = (d4 + 1) / 2, kp = round_pow2(k), tile_n = tile_for(nd);
  const long long smem = smem_bytes(nd, tile_n, kp);
  const void* fn = kernel_of(round_pow2(nd), kp);
  if (smem > kSmemLimit ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    static_cast<size_t>(smem)) != cudaSuccess ||
      per_sm < 1) {
    return 0;
  }
  // split the catalog so the grid fills the card once, each split at least
  // one tile
  const int qblocks = (Q + kBlockQ - 1) / kBlockQ;
  int splits = sms * per_sm / qblocks;
  const int max_splits = (N + tile_n - 1) / tile_n;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  int per_split = (N + splits - 1) / splits;
  per_split = (per_split + tile_n - 1) / tile_n * tile_n;
  splits = (N + per_split - 1) / per_split;
  plan[0] = kThreads;
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
  if (!takes(Q, N, d4, k)) return cudaErrorInvalidValue;
  const int tile_n = plan[1], splits = plan[2], per_split = plan[3];
  const size_t smem = static_cast<size_t>(plan[4]);
  if (splits > 1 && (part_v == nullptr || part_i == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, splits);
  // with splits, out_v holds each query's published k-th best until the
  // merge kernel writes the result over it
  unsigned* kth = nullptr;
  if (splits > 1) {
    kth = static_cast<unsigned*>(out_v);
    const cudaError_t rc = cudaMemsetAsync(kth, 0, sizeof(unsigned) * Q, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  float* dv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* di = static_cast<int*>(splits > 1 ? part_i : out_i);
  const float* qp = static_cast<const float*>(q);
  const float* ip = static_cast<const float*>(items);
  const int kp = round_pow2(k), ndmax = round_pow2((d4 + 1) / 2);
#define RECSYS_TOPK_CASE(NDMAX, KP)                                                        \
  if (ndmax == NDMAX && kp == KP) {                                                        \
    topk_kernel<NDMAX, KP><<<grid, kThreads, smem, s>>>(qp, ip, Q, N, d4, k, tile_n,      \
                                                        per_split, dv, di, kth);           \
    if (splits > 1) {                                                                      \
      topk_merge_kernel<KP><<<(Q + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, \
                              s>>>(dv, di, Q, splits, k, static_cast<float*>(out_v),       \
                                   static_cast<int*>(out_i));                              \
    }                                                                                      \
    return static_cast<int>(cudaGetLastError());                                           \
  }
#define RECSYS_TOPK_KP(NDMAX) \
  RECSYS_TOPK_CASE(NDMAX, 1)  \
  RECSYS_TOPK_CASE(NDMAX, 2)  \
  RECSYS_TOPK_CASE(NDMAX, 4)  \
  RECSYS_TOPK_CASE(NDMAX, 8)  \
  RECSYS_TOPK_CASE(NDMAX, 16)
  RECSYS_TOPK_KP(1)
  RECSYS_TOPK_KP(2)
  RECSYS_TOPK_KP(4)
  RECSYS_TOPK_KP(8)
  RECSYS_TOPK_KP(16)
#undef RECSYS_TOPK_KP
#undef RECSYS_TOPK_CASE
  return cudaErrorInvalidValue;
}

// An empty kernel at the plan's grid, block and shared memory: the launch
// floor of topk_scores_launch's first kernel.
extern "C" int topk_scores_floor(int Q, const int* plan, void* stream) {
  if (cudaFuncSetAttribute(reinterpret_cast<const void*>(topk_empty_kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, plan[4]) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, plan[2]);
  topk_empty_kernel<<<grid, plan[0], static_cast<size_t>(plan[4]),
                      static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
