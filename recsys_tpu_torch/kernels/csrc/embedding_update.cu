// Fused embedding backward + dense optimizer update for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/embedding_update_tpu.py
//   ::fused_bwd_adam (body _kernel)                -> embedding_adam_launch
//   ::fused_bwd_rowwise_adagrad (body _adagrad_kernel)
//                                                  -> embedding_rowwise_adagrad_launch
// on the port's logical (V, D) tables (one vocab row per table row).
// Inputs, as the TPU kernel's: cot (nc*ch, D) f32 or bf16, the cotangent
// rows in host-prep order; ids (nc, ch) int32 vocab ids padded with the
// sentinel nb*block; cptr (nb+1) int32, block k owns chunks
// [cptr[k], cptr[k+1]), its ids ascending and then the sentinel, as host
// prep sorts them.  The table p (V, D) is f32 or bf16; m, v (V, D) and
// acc (V) are f32.  Every row is updated in place, touched or not.
//
// Bound on the H100: bytes.  One 100k x 16 table with Adam reads and writes
// p, m and v (38.4 MB) and reads the bf16 cotangent and ids (~2.4 MB at
// B = 16384): ~12 us at 3.35 TB/s.  Rowwise AdaGrad moves ~15.6 MB.  The
// arithmetic is a few flops per byte.
//
// Design: the TPU kernel summed each block's gradient as a one-hot matmul
// on the MXU.  Here no one-hot is needed: one CUDA block per table block of
// `block` rows zeroes an f32 (block, D) gradient tile in shared memory
// (32 KB at block 512, D 16), walks its chunks and adds each cotangent
// element into the tile with a shared-memory atomicAdd (threads take
// consecutive elements, so cotangent reads coalesce; duplicate ids sum, in
// an order that varies from run to run).  A walk stops at the first id
// past its block: the last block owns every static padding chunk (65 of
// them, 266k elements, at 16384 ids), and walking them all cost each of
// its threads about 1040 steps where another block's take about 5.
// A thread loads the ids and cotangent values of four of its elements
// before it adds any, so eight loads are in flight where the walk waited
// on each in turn.
// Then Adam streams the block's rows of p, m, v once, with 16-byte loads
// where D allows, updates them from the tile and writes them back.  The
// bias corrections c1, c2 come from the wrapper, computed in f32.
// Rowwise AdaGrad runs 512 threads a block (its 196 blocks leave 24 warps
// an SM where 256 left 12) and puts L = D/4 lanes across each row (D = 4,
// 8, ..., 128 and a table aligned to a lane's 4 elements): a lane reads 4
// values of the tile as one float4 (a warp's 8 rows at D = 16 are 512
// contiguous bytes: no bank conflict, where one thread a row read 2 banks
// a warp), and 16 bytes of p (8 of a bf16 table); the row's sum of g^2 is
// taken by __shfl_xor across its lanes, its accumulator read and written
// once, by the row's first lane, and broadcast, and its rate lr / (sqrt(acc)
// + eps) is one division a row.  A thread's first 4 rows of p and acc (the
// whole block at D = 16) load before the tile is summed: they do not
// depend on it, since only this block updates its rows, so their latency
// hides behind the walk.  Any other D, or a table that is not so aligned,
// takes a warp a row, lanes over its elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // a block of Adam
constexpr int kAdagradThreads = 512;  // a block of rowwise AdaGrad

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// Sum the block's chunks into the shared tile g[block * D], with all
// blockDim.x threads.
template <typename C>
__device__ void accumulate(float* g, const C* __restrict__ cot,
                           const int* __restrict__ ids,
                           const int* __restrict__ cptr, int k, int V, int D,
                           int block, int ch, int nc) {
  const int T = blockDim.x;
  const int rows = block * D;
  for (int i = threadIdx.x; i < rows / 4; i += T)
    reinterpret_cast<float4*>(g)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = rows / 4 * 4 + threadIdx.x; i < rows; i += T) g[i] = 0.f;
  __syncthreads();
  const int c0 = min(cptr[k], nc), c1 = max(c0, min(cptr[k + 1], nc));
  const int base = k * block;
  const int n = (c1 - c0) * ch * D;  // this block's cotangent elements
  const int* bids = ids + static_cast<size_t>(c0) * ch;
  const C* bcot = cot + static_cast<size_t>(c0) * ch * D;
  // The ids ascend through a block's chunks, and the sentinel that pads
  // them lies above every vocab id; a thread's slots ascend too, so its
  // first id past the block ends its walk.  The last block thus reads a
  // few sentinels per thread of the static padding chunks, not all of them.
  // A batch's ids and cotangent values load together (a value's address
  // does not depend on its id), and only then are they added.
  constexpr int kBatch = 4;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * T) {
    int id[kBatch];
    float c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T;
      id[u] = e < n ? bids[e / D] : INT_MAX;
      c[u] = e < n ? load_f(bcot, e) : 0.f;
    }
    bool past = false;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T, local = id[u] - base;
      past = past || local >= block || id[u] >= V;
      if (!past && local >= 0) atomicAdd(&g[local * D + e % D], c[u]);
    }
    if (past) break;
  }
  __syncthreads();
}

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, c1, c2, eps, wd;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float g,
                                         const AdamHyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  float upd = h.lr * (m * h.c1) / (sqrtf(v * h.c2) + h.eps);
  if (h.wd != 0.f) upd = upd + h.lr * (h.wd * p);
  p = p - upd;
}

template <typename P, typename C>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(P* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                const C* __restrict__ cot, const int* __restrict__ ids,
                const int* __restrict__ cptr, int V, int D, int block, int ch,
                int nc, AdamHyper h, int vec) {
  extern __shared__ float4 g4[];
  float* const g = reinterpret_cast<float*>(g4);
  const int k = blockIdx.x;
  accumulate(g, cot, ids, cptr, k, V, D, block, ch, nc);
  const int r0 = k * block;
  const int n = (min(V, r0 + block) - r0) * D;
  const size_t e0 = static_cast<size_t>(r0) * D;
  if (vec) {  // D % 4 == 0 and every pointer 16-byte aligned
    for (int q = threadIdx.x; q < n / 4; q += kThreads) {
      const size_t e = e0 + 4 * static_cast<size_t>(q);
      float4 mm = *reinterpret_cast<const float4*>(m + e);
      float4 vv = *reinterpret_cast<const float4*>(v + e);
      float pp[4], mv[4] = {mm.x, mm.y, mm.z, mm.w}, vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pp[j] = load_f(p, e + j);
        adam_one(pp[j], mv[j], vw[j], g[4 * q + j], h);
        store_f(p, e + j, pp[j]);
      }
      *reinterpret_cast<float4*>(m + e) = make_float4(mv[0], mv[1], mv[2], mv[3]);
      *reinterpret_cast<float4*>(v + e) = make_float4(vw[0], vw[1], vw[2], vw[3]);
    }
  } else {
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const size_t e = e0 + q;
      float pp = load_f(p, e), mv = m[e], vw = v[e];
      adam_one(pp, mv, vw, g[q], h);
      store_f(p, e, pp);
      m[e] = mv;
      v[e] = vw;
    }
  }
}

// 4 consecutive table elements as f32: 16 bytes of an f32 table, 8 of bf16
__device__ __forceinline__ void load4(const float* p, size_t e, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p + e);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, size_t e, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p + e);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, size_t e, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p + e) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t e, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p + e) = t;
}

// The AdaGrad step of one value; rate = lr / (sqrt(acc) + eps), one
// division a row: a division a value bound the update phase by its
// arithmetic.  g * rate is lr * g / (sqrt(acc) + eps) to about an ulp.
__device__ __forceinline__ float adagrad_one(float p, float g, float rate, float lr,
                                             float wd) {
  float upd = g * rate;
  if (wd != 0.f) upd = upd + (lr * wd) * p;
  return p - upd;
}

// L lanes a row, 4 elements a lane (D = 4L); kGroup rows a thread in
// flight.  Shuffles run on every lane: rows past the block only mask their
// loads and stores.
template <typename P, typename C, int L>
__global__ void __launch_bounds__(kAdagradThreads)
    adagrad_lanes_kernel(P* __restrict__ p, float* __restrict__ acc,
                         const C* __restrict__ cot, const int* __restrict__ ids,
                         const int* __restrict__ cptr, int V, int block, int ch,
                         int nc, float lr, float eps, float wd) {
  constexpr int D = 4 * L, kRowsAPass = kAdagradThreads / L, kGroup = 4;
  extern __shared__ float4 g4[];
  const int k = blockIdx.x;
  const int r0 = k * block;
  const int rows = min(V, r0 + block) - r0;
  const int q = threadIdx.x % L, first = threadIdx.x / L;
  float x[kGroup][4] = {}, a0[kGroup] = {};
  auto load_group = [&](int base) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int r = base + first + u * kRowsAPass;
      if (r < rows) {
        load4(p, static_cast<size_t>(r0 + r) * D + 4 * q, x[u]);
        a0[u] = q == 0 ? acc[r0 + r] : 0.f;
      }
    }
  };
  load_group(0);
  accumulate(reinterpret_cast<float*>(g4), cot, ids, cptr, k, V, D, block, ch, nc);
  const float inv_d = 1.f / D;
  for (int base = 0;;) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int r = base + first + u * kRowsAPass;
      const bool in = r < rows;
      const float4 gv = in ? g4[r * L + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      float s = gv.x * gv.x + gv.y * gv.y + gv.z * gv.z + gv.w * gv.w;
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float a = __shfl_sync(0xffffffffu, a0[u], 0, L) + s * inv_d;
      if (in) {
        if (q == 0) acc[r0 + r] = a;
        const float rate = lr / (sqrtf(a) + eps);
        const float gq[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) x[u][j] = adagrad_one(x[u][j], gq[j], rate, lr, wd);
        store4(p, static_cast<size_t>(r0 + r) * D + 4 * q, x[u]);
      }
    }
    base += kGroup * kRowsAPass;
    if (base >= rows) break;
    load_group(base);
  }
}

// Any D and alignment: a warp a row, lanes over its elements.
template <typename P, typename C>
__global__ void __launch_bounds__(kAdagradThreads)
    adagrad_warp_kernel(P* __restrict__ p, float* __restrict__ acc,
                        const C* __restrict__ cot, const int* __restrict__ ids,
                        const int* __restrict__ cptr, int V, int D, int block,
                        int ch, int nc, float lr, float eps, float wd) {
  extern __shared__ float4 g4[];
  float* const g = reinterpret_cast<float*>(g4);
  const int k = blockIdx.x;
  accumulate(g, cot, ids, cptr, k, V, D, block, ch, nc);
  const int r0 = k * block;
  const int rows = min(V, r0 + block) - r0;
  const int lane = threadIdx.x % 32;
  const float inv_d = 1.f / D;
  for (int r = threadIdx.x / 32; r < rows; r += kAdagradThreads / 32) {
    const float* gr = g + r * D;
    float s = 0.f;
    for (int j = lane; j < D; j += 32) s += gr[j] * gr[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    float a = 0.f;
    if (lane == 0) {
      a = acc[r0 + r] + s * inv_d;
      acc[r0 + r] = a;
    }
    const float rate = lr / (sqrtf(__shfl_sync(0xffffffffu, a, 0)) + eps);
    const size_t e = static_cast<size_t>(r0 + r) * D;
    for (int j = lane; j < D; j += 32)
      store_f(p, e + j, adagrad_one(load_f(p, e + j), gr[j], rate, lr, wd));
  }
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// Shapes the kernels take: a (block, D) f32 tile in shared memory, and
// every block's cotangent elements and every table element indexable in int.
bool bad_args(int V, int D, int block, int ch, int nc) {
  return V < 1 || D < 1 || block < 1 || ch < 1 || nc < 1 ||
         static_cast<long long>(block) * D * 4 > 227 * 1024 ||
         static_cast<long long>(nc) * ch * D >= (1LL << 31) ||
         static_cast<long long>(V + block) * D >= (1LL << 31);
}

// Above 48 KB a block's dynamic shared memory must be opted in to.
template <typename K>
void allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
}

template <typename P, typename C>
void launch_adam(void* p, void* m, void* v, const void* cot, const void* ids,
                 const void* cptr, int V, int D, int block, int ch, int nc,
                 const AdamHyper& h, void* stream) {
  const int nb = (V + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * D * sizeof(float);
  const uintptr_t align = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(m) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = D % 4 == 0 && (align & 15) == 0;
  allow_smem(adam_kernel<P, C>, smem);
  adam_kernel<P, C><<<nb, kThreads, smem, as_stream(stream)>>>(
      static_cast<P*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const C*>(cot), static_cast<const int*>(ids),
      static_cast<const int*>(cptr), V, D, block, ch, nc, h, vec);
}

template <typename P, typename C, int L>
void run_lanes(void* p, void* acc, const void* cot, const void* ids, const void* cptr,
               int V, int block, int ch, int nc, float lr, float eps, float wd,
               int nb, size_t smem, cudaStream_t s) {
  allow_smem(adagrad_lanes_kernel<P, C, L>, smem);
  adagrad_lanes_kernel<P, C, L><<<nb, kAdagradThreads, smem, s>>>(
      static_cast<P*>(p), static_cast<float*>(acc), static_cast<const C*>(cot),
      static_cast<const int*>(ids), static_cast<const int*>(cptr), V, block, ch, nc,
      lr, eps, wd);
}

template <typename P, typename C>
void launch_adagrad(void* p, void* acc, const void* cot, const void* ids,
                    const void* cptr, int V, int D, int block, int ch, int nc,
                    float lr, float eps, float wd, void* stream) {
  const int nb = (V + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * D * sizeof(float);
  cudaStream_t s = as_stream(stream);
  // lanes across a row where D is 4 times a power of two up to 32 lanes
  // and the table is aligned to a lane's 4 elements
  const bool aligned = reinterpret_cast<uintptr_t>(p) % (4 * sizeof(P)) == 0;
  switch (aligned && D % 4 == 0 ? D / 4 : 0) {
    case 1: run_lanes<P, C, 1>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    case 2: run_lanes<P, C, 2>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    case 4: run_lanes<P, C, 4>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    case 8: run_lanes<P, C, 8>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    case 16: run_lanes<P, C, 16>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    case 32: run_lanes<P, C, 32>(p, acc, cot, ids, cptr, V, block, ch, nc, lr, eps, wd, nb, smem, s); return;
    default:
      allow_smem(adagrad_warp_kernel<P, C>, smem);
      adagrad_warp_kernel<P, C><<<nb, kAdagradThreads, smem, s>>>(
          static_cast<P*>(p), static_cast<float*>(acc), static_cast<const C*>(cot),
          static_cast<const int*>(ids), static_cast<const int*>(cptr), V, D, block, ch, nc,
          lr, eps, wd);
  }
}

}  // namespace

// p (V, D) f32 or bf16 (p_bf16), m and v (V, D) f32, updated in place;
// cot (nc*ch, D) f32 or bf16 (cot_bf16); ids (nc, ch) and cptr (nb+1) int32
// with nb = ceil(V / block).  omb1 = 1 - b1, omb2 = 1 - b2; c1 and c2 are
// the bias corrections.  Launches on `stream`, returns cudaGetLastError().
extern "C" int embedding_adam_launch(void* p, void* m, void* v, const void* cot,
                                     const void* ids, const void* cptr, int V,
                                     int D, int block, int ch, int nc,
                                     int p_bf16, int cot_bf16, float lr,
                                     float b1, float b2, float omb1, float omb2,
                                     float c1, float c2, float eps, float wd,
                                     void* stream) {
  if (bad_args(V, D, block, ch, nc)) return cudaErrorInvalidValue;
  const AdamHyper h = {lr, b1, b2, omb1, omb2, c1, c2, eps, wd};
  if (p_bf16 && cot_bf16)
    launch_adam<__nv_bfloat16, __nv_bfloat16>(p, m, v, cot, ids, cptr, V, D, block, ch, nc, h, stream);
  else if (p_bf16)
    launch_adam<__nv_bfloat16, float>(p, m, v, cot, ids, cptr, V, D, block, ch, nc, h, stream);
  else if (cot_bf16)
    launch_adam<float, __nv_bfloat16>(p, m, v, cot, ids, cptr, V, D, block, ch, nc, h, stream);
  else
    launch_adam<float, float>(p, m, v, cot, ids, cptr, V, D, block, ch, nc, h, stream);
  return static_cast<int>(cudaGetLastError());
}

// p as above, acc (V) f32, updated in place; the other inputs as above.
extern "C" int embedding_rowwise_adagrad_launch(
    void* p, void* acc, const void* cot, const void* ids, const void* cptr,
    int V, int D, int block, int ch, int nc, int p_bf16, int cot_bf16, float lr,
    float eps, float wd, void* stream) {
  if (bad_args(V, D, block, ch, nc)) return cudaErrorInvalidValue;
  if (p_bf16 && cot_bf16)
    launch_adagrad<__nv_bfloat16, __nv_bfloat16>(p, acc, cot, ids, cptr, V, D, block, ch, nc, lr, eps, wd, stream);
  else if (p_bf16)
    launch_adagrad<__nv_bfloat16, float>(p, acc, cot, ids, cptr, V, D, block, ch, nc, lr, eps, wd, stream);
  else if (cot_bf16)
    launch_adagrad<float, __nv_bfloat16>(p, acc, cot, ids, cptr, V, D, block, ch, nc, lr, eps, wd, stream);
  else
    launch_adagrad<float, float>(p, acc, cot, ids, cptr, V, D, block, ch, nc, lr, eps, wd, stream);
  return static_cast<int>(cudaGetLastError());
}
