// Fused embedding backward + dense optimizer update for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/embedding_update_tpu.py
//   ::fused_bwd_adam (body _kernel)                -> embedding_adam_launch
//                                                     (up to 32 tables a launch)
//   ::fused_bwd_rowwise_adagrad (body _adagrad_kernel)
//                                                  -> embedding_rowwise_adagrad_launch
// on the port's logical (V, D) tables (one vocab row per table row).
// Inputs, as the TPU kernel's: cot (nc*ch, D) f32 or bf16, the cotangent
// rows in host-prep order; ids (nc, ch) int32 vocab ids padded with the
// sentinel nb*block; cptr (nb+1) int32, block k owns chunks
// [cptr[k], cptr[k+1]), its ids ascending and then the sentinel, as host
// prep sorts them.  Like the TPU kernel these take `streams` such sorted
// streams one after the other (one a data rank, under the local data
// contract), block k summing every stream's window in turn, and a model
// shard's window: the table is rows [row0, row0 + V) of the global one,
// its ids stay global (less row0 in the kernel, where the TPU wrapper
// rebases them in a pass of their own) and cptr points at its first block
// (shard-aligned fences from host prep).  The one-stream walk of a whole
// table (streams 1, row0 0, every table of a launch) compiles apart
// (accumulate<false>), without the stream loop or the offset.  The table
// p (V, D) is f32 or bf16; m, v (V, D) and acc (V) are f32.  Every row is
// updated in place, touched or not.
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
// Adam cuts each table block into parts of at most 2048 values (4 parts
// of 128 rows at block 512, D = 16), a CUDA block of 256 threads each:
// the first design's 196 blocks of 256 threads and 8192 values each left
// 64 SMs streaming two blocks' rows while 68 streamed one, and each block
// walked its gradient before it loaded a byte of p, m or v.  Now each part
// walks its block's chunks (skipping the ids below its rows, stopping past
// them) and every thread loads its two float4s of p, m and v (16 bytes of
// an f32 table, 8 of bf16) before the walk, so that their latency hides
// behind it; 784 small blocks spread evenly over the SMs.  One launch may
// also take up to 32 tables: its blocks are
// the tables' parts one after another, so a step's 26 tables pay one
// launch and one tail.  The bias corrections c1, c2 come from the wrapper,
// computed in f32; each value takes one IEEE division, as the plain
// version does.
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

constexpr int kAdamThreads = 256;     // a block of Adam
constexpr int kAdamPre = 4;           // float4s of p, m and v a thread loads before the walk
constexpr int kAdamValues = kAdamThreads * 4 * kAdamPre;  // values a block of Adam updates
constexpr int kPassTables = 32;       // tables a launch of Adam takes
constexpr int kAdagradThreads = 512;  // a block of rowwise AdaGrad

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// Where a table's chunks lie: `streams` sorted streams of nc chunks each,
// stream s's chunk pointers at cptr[s * cstride ..], and every id offset by
// row0 (a model shard's first row: ids are global, the table is the shard).
struct Chunks {
  const int* ids;
  const int* cptr;
  int nc, streams, cstride, row0;
};

// Sum the chunks of table block k into the shared tile g[(hi - lo) * D]
// for the table rows [lo, hi) (a part of the block, or all of it up to
// V), with all blockDim.x threads: every stream's window of the block,
// one after the other.  kMulti = false compiles the one-stream walk of a
// whole table (streams 1, row0 0) with neither loop nor offset.
template <bool kMulti, typename C>
__device__ void accumulate(float* g, const C* __restrict__ cot, const Chunks& q, int k,
                           int lo, int hi, int D, int ch) {
  const int T = blockDim.x;
  const int rows = (hi - lo) * D;
  for (int i = threadIdx.x; i < rows / 4; i += T)
    reinterpret_cast<float4*>(g)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = rows / 4 * 4 + threadIdx.x; i < rows; i += T) g[i] = 0.f;
  __syncthreads();
  const int streams = kMulti ? q.streams : 1, row0 = kMulti ? q.row0 : 0;
  for (int s = 0; s < streams; ++s) {
    const int* cp = q.cptr + static_cast<size_t>(s) * q.cstride;
    const int c0 = min(cp[k], q.nc), c1 = max(c0, min(cp[k + 1], q.nc));
    const int n = (c1 - c0) * ch * D;  // this block's cotangent elements
    const size_t first = static_cast<size_t>(s) * q.nc + c0;
    const int* bids = q.ids + first * ch;
    const C* bcot = cot + first * ch * D;
    // The ids ascend through a block's chunks, and the sentinel that pads
    // them lies above every vocab id; a thread's slots ascend too, so its
    // first id past hi ends its walk of this stream.  The last block thus
    // reads a few sentinels per thread of the static padding chunks, not
    // all of them.  A batch's ids and cotangent values load together (a
    // value's address does not depend on its id), and only then are they
    // added.
    constexpr int kBatch = 4;
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * T) {
      int id[kBatch];
      float c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * T;
        id[u] = e < n ? bids[e / D] - row0 : INT_MAX;
        c[u] = e < n ? load_f(bcot, e) : 0.f;
      }
      bool past = false;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * T, local = id[u] - lo;
        past = past || id[u] >= hi;
        if (!past && local >= 0) atomicAdd(&g[local * D + e % D], c[u]);
      }
      if (past) break;
    }
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

// One table of an Adam pass.  Its table block k is cut into `parts`
// parts of `part_rows` rows, a CUDA block each, so that a CUDA block
// updates at most kAdamValues values; the table's CUDA blocks are
// [first, first + nb * parts) of the launch.  vec: D % 4 == 0, p aligned
// to 4 elements and m, v to 16 bytes.
struct AdamTable {
  void* p;
  float* m;
  float* v;
  const void* cot;
  Chunks q;
  int V, block, parts, part_rows, first, vec;
};
struct AdamPass {
  AdamTable t[kPassTables];
  int count;
};

// A CUDA block updates the rows [r0, r1) of one table: it loads its
// threads' float4s of p, m and v (kAdamPre each) before the walk, which
// they do not depend on (only this block updates these rows), so their
// latency hides behind it; then it sums the part's gradient into the tile
// and updates the loaded values.  Any D or alignment other than vec takes
// single values after the walk.
template <typename P, typename C, bool kMulti>
__global__ void __launch_bounds__(kAdamThreads)
    adam_kernel(const __grid_constant__ AdamPass a, int D, int ch, AdamHyper h) {
  extern __shared__ float4 g4[];
  float* const g = reinterpret_cast<float*>(g4);
  const int bid = blockIdx.x;
  int t = 0;
  while (t + 1 < a.count && bid >= a.t[t + 1].first) ++t;
  const AdamTable& tb = a.t[t];
  const int j = bid - tb.first, k = j / tb.parts;
  const int r0 = k * tb.block + (j - k * tb.parts) * tb.part_rows;
  const int r1 = min(min(tb.V, (k + 1) * tb.block), r0 + tb.part_rows);
  if (r0 >= r1) return;  // a part past a ragged last block: the whole block leaves
  P* const p = static_cast<P*>(tb.p);
  float* const m = tb.m;
  float* const v = tb.v;
  const C* const cot = static_cast<const C*>(tb.cot);
  const int n = (r1 - r0) * D;
  const size_t e0 = static_cast<size_t>(r0) * D;
  if (tb.vec) {
    const int n4 = n / 4;
    float pp[kAdamPre][4], mm[kAdamPre][4], vv[kAdamPre][4];
#pragma unroll
    for (int i = 0; i < kAdamPre; ++i) {
      const int q = threadIdx.x + i * kAdamThreads;
      if (q < n4) {
        load4(p, e0 + 4 * q, pp[i]);
        load4(m, e0 + 4 * q, mm[i]);
        load4(v, e0 + 4 * q, vv[i]);
      }
    }
    accumulate<kMulti>(g, cot, tb.q, k, r0, r1, D, ch);
    const float4* const gt = g4;
    auto update = [&](int q, float (&x)[4], float (&mx)[4], float (&vx)[4]) {
      const float4 gq = gt[q];
      const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) adam_one(x[u], mx[u], vx[u], gv[u], h);
      store4(p, e0 + 4 * q, x);
      store4(m, e0 + 4 * q, mx);
      store4(v, e0 + 4 * q, vx);
    };
#pragma unroll
    for (int i = 0; i < kAdamPre; ++i) {
      const int q = threadIdx.x + i * kAdamThreads;
      if (q < n4) update(q, pp[i], mm[i], vv[i]);
    }
    for (int q = threadIdx.x + kAdamPre * kAdamThreads; q < n4; q += kAdamThreads) {
      float x[4], mx[4], vx[4];
      load4(p, e0 + 4 * q, x);
      load4(m, e0 + 4 * q, mx);
      load4(v, e0 + 4 * q, vx);
      update(q, x, mx, vx);
    }
  } else {
    accumulate<kMulti>(g, cot, tb.q, k, r0, r1, D, ch);
    for (int q = threadIdx.x; q < n; q += kAdamThreads) {
      const size_t e = e0 + q;
      float pv = load_f(p, e), mv = m[e], vw = v[e];
      adam_one(pv, mv, vw, g[q], h);
      store_f(p, e, pv);
      m[e] = mv;
      v[e] = vw;
    }
  }
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
template <typename P, typename C, int L, bool kMulti>
__global__ void __launch_bounds__(kAdagradThreads)
    adagrad_lanes_kernel(P* __restrict__ p, float* __restrict__ acc,
                         const C* __restrict__ cot, const Chunks chunks, int V, int block,
                         int ch, float lr, float eps, float wd) {
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
  accumulate<kMulti>(reinterpret_cast<float*>(g4), cot, chunks, k, r0, r0 + rows, D, ch);
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
template <typename P, typename C, bool kMulti>
__global__ void __launch_bounds__(kAdagradThreads)
    adagrad_warp_kernel(P* __restrict__ p, float* __restrict__ acc,
                        const C* __restrict__ cot, const Chunks chunks, int V, int D,
                        int block, int ch, float lr, float eps, float wd) {
  extern __shared__ float4 g4[];
  float* const g = reinterpret_cast<float*>(g4);
  const int k = blockIdx.x;
  const int r0 = k * block;
  const int rows = min(V, r0 + block) - r0;
  accumulate<kMulti>(g, cot, chunks, k, r0, r0 + rows, D, ch);
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
bool bad_args(int V, int D, int block, int ch, const Chunks& q) {
  return V < 1 || D < 1 || block < 1 || ch < 1 || q.nc < 1 || q.streams < 1 ||
         q.cstride < (V + block - 1) / block + 1 || q.row0 < 0 ||
         static_cast<long long>(block) * D * 4 > 227 * 1024 ||
         static_cast<long long>(q.streams) * q.nc * ch * D >= (1LL << 31) ||
         static_cast<long long>(V + block) * D >= (1LL << 31);
}

Chunks chunks_of(const void* ids, const void* cptr, int nc, int streams, int cstride,
                 int row0) {
  return Chunks{static_cast<const int*>(ids), static_cast<const int*>(cptr), nc, streams,
                cstride, row0};
}

// Above 48 KB a block's dynamic shared memory must be opted in to.
template <typename K>
void allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
}

// An Adam pass over `count` tables of one D, one ch and one pair of
// types: ptrs holds each table's p, m, v, cot, ids and cptr, ints its V,
// block, nc, streams, cstride and row0.
template <typename P, typename C>
int launch_adam(const uint64_t* ptrs, const int* ints, int count, int D, int ch,
                const AdamHyper& h, cudaStream_t s) {
  if (count < 1 || count > kPassTables) return cudaErrorInvalidValue;
  AdamPass a = {};
  a.count = count;
  long long blocks = 0;
  size_t smem = 16;
  bool multi = false;
  for (int t = 0; t < count; ++t) {
    const uint64_t* q = ptrs + 6 * t;
    const int* n = ints + 6 * t;
    const int V = n[0], block = n[1];
    AdamTable& tb = a.t[t];
    tb.q = chunks_of(reinterpret_cast<const void*>(q[4]), reinterpret_cast<const void*>(q[5]),
                     n[2], n[3], n[4], n[5]);
    if (bad_args(V, D, block, ch, tb.q)) return cudaErrorInvalidValue;
    multi = multi || tb.q.streams > 1 || tb.q.row0 > 0;
    tb.p = reinterpret_cast<void*>(q[0]);
    tb.m = reinterpret_cast<float*>(q[1]);
    tb.v = reinterpret_cast<float*>(q[2]);
    tb.cot = reinterpret_cast<const void*>(q[3]);
    tb.V = V, tb.block = block;
    tb.parts = static_cast<int>((static_cast<long long>(block) * D + kAdamValues - 1) /
                                kAdamValues);
    tb.part_rows = (block + tb.parts - 1) / tb.parts;
    tb.first = static_cast<int>(blocks);
    tb.vec = D % 4 == 0 && q[0] % (4 * sizeof(P)) == 0 && q[1] % 16 == 0 && q[2] % 16 == 0;
    blocks += static_cast<long long>((V + block - 1) / block) * tb.parts;
    const size_t tile = static_cast<size_t>(tb.part_rows) * D * sizeof(float);
    smem = tile > smem ? tile : smem;
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (multi) {
    allow_smem(adam_kernel<P, C, true>, smem);
    adam_kernel<P, C, true><<<grid, kAdamThreads, smem, s>>>(a, D, ch, h);
  } else {
    allow_smem(adam_kernel<P, C, false>, smem);
    adam_kernel<P, C, false><<<grid, kAdamThreads, smem, s>>>(a, D, ch, h);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_adam_types(const uint64_t* ptrs, const int* ints, int count, int D, int ch,
                      int p_bf16, int cot_bf16, const AdamHyper& h, void* stream) {
  cudaStream_t s = as_stream(stream);
  if (p_bf16 && cot_bf16)
    return launch_adam<__nv_bfloat16, __nv_bfloat16>(ptrs, ints, count, D, ch, h, s);
  if (p_bf16) return launch_adam<__nv_bfloat16, float>(ptrs, ints, count, D, ch, h, s);
  if (cot_bf16) return launch_adam<float, __nv_bfloat16>(ptrs, ints, count, D, ch, h, s);
  return launch_adam<float, float>(ptrs, ints, count, D, ch, h, s);
}

template <typename P, typename C, int L, bool kMulti>
void run_lanes(void* p, void* acc, const void* cot, const Chunks& q, int V, int block,
               int ch, float lr, float eps, float wd, int nb, size_t smem,
               cudaStream_t s) {
  allow_smem(adagrad_lanes_kernel<P, C, L, kMulti>, smem);
  adagrad_lanes_kernel<P, C, L, kMulti><<<nb, kAdagradThreads, smem, s>>>(
      static_cast<P*>(p), static_cast<float*>(acc), static_cast<const C*>(cot), q, V,
      block, ch, lr, eps, wd);
}

template <typename P, typename C, bool kMulti>
void launch_adagrad(void* p, void* acc, const void* cot, const Chunks& q, int V, int D,
                    int block, int ch, float lr, float eps, float wd, void* stream) {
  const int nb = (V + block - 1) / block;
  const size_t smem = static_cast<size_t>(block) * D * sizeof(float);
  cudaStream_t s = as_stream(stream);
  // lanes across a row where D is 4 times a power of two up to 32 lanes
  // and the table is aligned to a lane's 4 elements
  const bool aligned = reinterpret_cast<uintptr_t>(p) % (4 * sizeof(P)) == 0;
  switch (aligned && D % 4 == 0 ? D / 4 : 0) {
    case 1: run_lanes<P, C, 1, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    case 2: run_lanes<P, C, 2, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    case 4: run_lanes<P, C, 4, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    case 8: run_lanes<P, C, 8, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    case 16: run_lanes<P, C, 16, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    case 32: run_lanes<P, C, 32, kMulti>(p, acc, cot, q, V, block, ch, lr, eps, wd, nb, smem, s); return;
    default:
      allow_smem(adagrad_warp_kernel<P, C, kMulti>, smem);
      adagrad_warp_kernel<P, C, kMulti><<<nb, kAdagradThreads, smem, s>>>(
          static_cast<P*>(p), static_cast<float*>(acc), static_cast<const C*>(cot), q, V, D,
          block, ch, lr, eps, wd);
  }
}

// The multi-stream (or shard-window) walk, or the one-stream one.
template <typename P, typename C>
void adagrad_form(bool multi, void* p, void* acc, const void* cot, const Chunks& q, int V,
                  int D, int block, int ch, float lr, float eps, float wd, void* stream) {
  if (multi)
    launch_adagrad<P, C, true>(p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
  else
    launch_adagrad<P, C, false>(p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
}

}  // namespace

// Adam over `count` tables (1 <= count <= 32) of one D, one ch and one
// pair of types, in one launch.  Table t: p (V, D) f32 or bf16 (p_bf16), m
// and v (V, D) f32, updated in place; cot (streams*nc*ch, D) f32 or bf16
// (cot_bf16), `streams` sorted streams of nc chunks one after the other;
// ids (streams*nc, ch) int32; stream s's chunk pointers at cptr[s * cstride
// .. s * cstride + nb] with nb = ceil(V / block); every id less row0 is
// the table row (row0 > 0 for a model shard whose rows start there, with
// cptr pointing at the shard's first block).  ptrs (6 * count) holds each
// table's p, m, v, cot, ids and cptr, ints (6 * count) its V, block, nc,
// streams, cstride and row0.  omb1 = 1 - b1, omb2 = 1 - b2; c1 and c2 are
// the bias corrections.  Launches on `stream`, returns cudaGetLastError()
// (cudaErrorInvalidValue for a count or shape out of range).
extern "C" int embedding_adam_launch(const uint64_t* ptrs, const int* ints, int count,
                                     int D, int ch, int p_bf16, int cot_bf16, float lr,
                                     float b1, float b2, float omb1, float omb2, float c1,
                                     float c2, float eps, float wd, void* stream) {
  const AdamHyper h = {lr, b1, b2, omb1, omb2, c1, c2, eps, wd};
  return launch_adam_types(ptrs, ints, count, D, ch, p_bf16, cot_bf16, h, stream);
}

// p as above, acc (V) f32, updated in place; the other inputs as above.
extern "C" int embedding_rowwise_adagrad_launch(
    void* p, void* acc, const void* cot, const void* ids, const void* cptr,
    int V, int D, int block, int ch, int nc, int streams, int cstride, int row0,
    int p_bf16, int cot_bf16, float lr, float eps, float wd, void* stream) {
  const Chunks q = chunks_of(ids, cptr, nc, streams, cstride, row0);
  if (bad_args(V, D, block, ch, q)) return cudaErrorInvalidValue;
  const bool multi = streams > 1 || row0 > 0;
  if (p_bf16 && cot_bf16)
    adagrad_form<__nv_bfloat16, __nv_bfloat16>(multi, p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
  else if (p_bf16)
    adagrad_form<__nv_bfloat16, float>(multi, p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
  else if (cot_bf16)
    adagrad_form<float, __nv_bfloat16>(multi, p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
  else
    adagrad_form<float, float>(multi, p, acc, cot, q, V, D, block, ch, lr, eps, wd, stream);
  return static_cast<int>(cudaGetLastError());
}
