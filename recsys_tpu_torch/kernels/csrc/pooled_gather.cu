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
// so repeated rows come from L2 (or L1, where an SM saw them before).
//
// Design.  The TPU kernel fetched one row per DMA, double buffered.  Here
// the time is the chain of dependent round trips to memory (an example's
// ids, then its rows) plus the dispatch of the blocks, so the design keeps
// both short.  A warp takes one example (two, a half-warp each, where a row
// is at most 64 bytes).  It loads the ids and mask of 64 positions at once,
// two a lane (longer histories in passes of 64: one round trip where the
// earlier design took one every 32 positions), ballots the mask and
// compacts the real positions' ids into shared memory by their rank, so
// padding costs no row load.  Its lanes form groups of T lanes, T the
// number of 16-byte chunks of a row (a power of two, at most the example's
// lanes); group i reads the compacted rows i, i + G, i + 2G, ... (G
// groups), kUnroll of them a lane in flight, and accumulates in f32
// registers.  The groups' partial sums meet through shuffles and one group
// stores the row of output.  A block has 32 warps, so the serving block's
// 8192 examples are 256 blocks, all resident at once at 32 registers a
// thread.  A row wider than the example's lanes is walked in column
// blocks.  Widths that do not split into 16-byte chunks (or a misaligned
// table) take the same path one element a lane at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kPass = 64;         // positions whose ids a pass loads
constexpr int kUnroll = 4;        // rows in flight a lane
constexpr int kHalfWarpRow = 64;  // rows of at most this many bytes: two examples a warp

// What a lane loads of a row, and how it becomes VEC floats.
template <typename T, int VEC>
struct Piece;

template <>
struct Piece<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(float (&a)[4], raw u) {
    a[0] += u.x;
    a[1] += u.y;
    a[2] += u.z;
    a[3] += u.w;
  }
};

template <>
struct Piece<float, 1> {
  using raw = float;
  static __device__ __forceinline__ raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ raw zero() { return 0.f; }
  static __device__ __forceinline__ void add(float (&a)[1], raw u) { a[0] += u; }
};

template <>
struct Piece<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void add(float (&a)[8], raw u) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      a[2 * i] += f.x;
      a[2 * i + 1] += f.y;
    }
  }
};

template <>
struct Piece<__nv_bfloat16, 1> {
  using raw = __nv_bfloat16;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) { return p[0]; }
  static __device__ __forceinline__ raw zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ void add(float (&a)[1], raw u) { a[0] += __bfloat162float(u); }
};

// E lanes an example (32, or 16 for rows of at most kHalfWarpRow bytes).
template <typename T, int VEC, int E>
__global__ void __launch_bounds__(kThreads)
    pooled_gather_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                         const uint8_t* __restrict__ mask, float* __restrict__ out,
                         int B, int L, int D) {
  using P = Piece<T, VEC>;
  constexpr int kSlots = kPass / E;  // positions a lane loads a pass
  __shared__ int ids[kWarps][kPass * 32 / E];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane / E, el = lane - half * E;
  const int b0 = (blockIdx.x * kWarps + warp) * (32 / E);
  if (b0 >= B) return;  // the whole warp: nothing below synchronises the block
  const int b = b0 + half;
  const bool live = b < B;
  const int chunks = D / VEC;
  int tpr = 1;  // lanes a row
  while (tpr < chunks && tpr < E) tpr <<= 1;
  const int groups = E / tpr;
  const int gi = el / tpr, cl = el - gi * tpr;
  const int* rb = rows + static_cast<size_t>(b) * L;
  const uint8_t* mb = mask + static_cast<size_t>(b) * L;
  int* my = ids[warp] + half * kPass;  // this example's compacted ids

  for (int c0 = 0; c0 < chunks; c0 += tpr) {
    const int c = c0 + cl;
    const bool col = c < chunks;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int p0 = 0; p0 < L; p0 += kPass) {
      // the pass's ids and mask at once, position p0 + s·E + el in slot s of
      // lane el, then each real one's id at its rank
      int id[kSlots];
      bool real[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int l = p0 + s * E + el;
        real[s] = live && l < L && mb[l] != 0;
        id[s] = real[s] ? rb[l] : 0;
      }
      int n = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        unsigned bal = __ballot_sync(0xffffffffu, real[s]);
        if constexpr (E < 32) bal = (bal >> (half * E)) & ((1u << E) - 1u);
        if (real[s]) my[n + __popc(bal & ((1u << el) - 1u))] = id[s];
        n += __popc(bal);
      }
      __syncwarp();
      int most = n;  // the warp walks as far as its longer example
      if constexpr (E < 32) most = max(most, __shfl_xor_sync(0xffffffffu, most, 16));
      for (int j = gi; j < most; j += groups * kUnroll) {
        typename P::raw v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = j + u * groups;
          v[u] = col && jj < n ? P::load(table + static_cast<size_t>(my[jj]) * D + c * VEC)
                               : P::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) P::add(acc, v[u]);
      }
      __syncwarp();  // every lane is done with the ids before the next pass
    }
    // the groups' partial sums of the same chunk meet
    for (int off = tpr; off < E; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (live && gi == 0 && col) {
      float* ob = out + static_cast<size_t>(b) * D + c * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          reinterpret_cast<float4*>(ob)[e / 4] =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) ob[e] = acc[e];
      }
    }
  }
}

__global__ void pooled_gather_empty_kernel() {}

template <typename T>
int lanes_an_example(int D) {
  return D * static_cast<int>(sizeof(T)) <= kHalfWarpRow ? 16 : 32;
}

template <typename T>
int grid_of(int B, int D) {
  const int per_block = kWarps * (32 / lanes_an_example<T>(D));
  return (B + per_block - 1) / per_block;
}

template <typename T, int VEC>
void launch(const void* table, const void* rows, const void* mask, void* out, int B, int L,
            int D, cudaStream_t s) {
  const dim3 grid(grid_of<T>(B, D));
  const T* tp = static_cast<const T*>(table);
  const int* rp = static_cast<const int*>(rows);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* op = static_cast<float*>(out);
  if (lanes_an_example<T>(D) == 16) {
    pooled_gather_kernel<T, VEC, 16><<<grid, kThreads, 0, s>>>(tp, rp, mp, op, B, L, D);
  } else {
    pooled_gather_kernel<T, VEC, 32><<<grid, kThreads, 0, s>>>(tp, rp, mp, op, B, L, D);
  }
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

// An empty kernel at pooled_gather_launch's grid and block for B examples
// of width D of an f32 table: its launch floor.
extern "C" int pooled_gather_floor(int B, int D, void* stream) {
  if (B < 1 || D < 1) return cudaErrorInvalidValue;
  pooled_gather_empty_kernel<<<grid_of<float>(B, D), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
