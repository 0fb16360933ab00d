// Elementwise Adam stream over many tables in one launch, in place, for
// Hopper (sm_90a).
//
// Replaces: recsys_tpu/tools/stream_probe.py::_pallas_adam_kernel, called by
// probe_pallas_adam_stream, whose pass calls it once on each table.  Over
// the f32 elements of each table's p, m, v (updated in place) and g (read):
//   m = b1·m + (1−b1)·g,  v = b2·v + (1−b2)·g·g,  p = p − lr·m / (√v + eps)
// with no bias correction: a pure stream, the probe of how fast the card
// moves an optimizer's 7 bytes of traffic per parameter byte.
//
// Bound on the H100: bytes.  Each element reads p, m, v, g and writes p, m,
// v: 28 bytes for about 10 flops.  At the probe's 26 tables of 100,000 x 16
// that is 1.165 GB a pass, 0.348 ms at 3.35 TB/s.
//
// Design: one launch a pass of up to kMaxTables tables, their pointers and
// counts passed by value in the kernel's parameters.  The float4 pieces of
// every table whose four pointers are 16-byte aligned form one concatenated
// index space.  A persistent grid of a whole number of blocks per SM, all
// resident at once, sweeps it in steps of 512 float4, step j to block
// j mod grid: no wave runs half empty, blocks loop within one step of each
// other, and the whole grid streams one window of each array at a time.
// (Equal contiguous ranges a block balance exactly but measured slower:
// thousands of scattered streams, and ranges that start off a 128-byte
// line.)  Each thread keeps two float4 of each of p, m, v and g in flight,
// with streaming loads and stores (__ldcs, __stcs: a pass is 23x the 50 MB
// L2).  The elements left over (a count that is not a multiple of 4, or a
// whole table with an unaligned pointer) form a second index space, split
// into equal contiguous shares and taken one element at a time in the same
// launch.  The arithmetic is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...), so nvcc cannot contract
// b1·m + (1−b1)·g into an FMA: each operation rounds once, as the plain
// PyTorch version's separate operations do, and the kernel is held to it
// bit for bit.  1−b1 and 1−b2 come from the wrapper, rounded once from
// double as the plain version's scalars are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // float4 of each array a thread keeps in flight
constexpr long long kStep = kUnroll * kThreads;
constexpr int kMaxTables = 32;

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr;
};

// A pass of `count` tables.  Table t owns float4 pieces [voff[t], voff[t+1])
// of the vector space and elements [soff[t], soff[t+1]) of the scalar space,
// the latter starting at its element sfirst[t].
struct Pass {
  float* p[kMaxTables];
  float* m[kMaxTables];
  float* v[kMaxTables];
  const float* g[kMaxTables];
  long long voff[kMaxTables + 1];
  long long soff[kMaxTables + 1];
  long long sfirst[kMaxTables];
  int count;
};

__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, m), __fadd_rn(__fsqrt_rn(v), h.eps)));
}

__device__ __forceinline__ void adam4(float4& p, float4& m, float4& v, const float4& g,
                                      const Hyper& h) {
  adam1(p.x, m.x, v.x, g.x, h);
  adam1(p.y, m.y, v.y, g.y, h);
  adam1(p.z, m.z, v.z, g.z, h);
  adam1(p.w, m.w, v.w, g.w, h);
}

// The table whose range of `off` holds i, searched upward from t.
__device__ __forceinline__ int table_of(const long long* off, long long i, int t) {
  while (i >= off[t + 1]) ++t;
  return t;
}

__global__ void __launch_bounds__(kThreads)
    adam_stream_pass_kernel(const __grid_constant__ Pass a, const Hyper h) {
  const long long n4 = a.voff[a.count], ns = a.soff[a.count];
  // the vector space in steps of kStep float4, step j to block j % gridDim.x
  int tv = 0;
  for (long long base = blockIdx.x * kStep; base < n4;
       base += static_cast<long long>(gridDim.x) * kStep) {
    float4 pp[kUnroll], mm[kUnroll], vv[kUnroll], gg[kUnroll];
    float4 *P[kUnroll], *M[kUnroll], *V[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the step before any use
      const long long i = base + u * kThreads + threadIdx.x;
      in[u] = i < n4;
      if (in[u]) {
        tv = table_of(a.voff, i, tv);
        const long long j = i - a.voff[tv];
        P[u] = reinterpret_cast<float4*>(a.p[tv]) + j;
        M[u] = reinterpret_cast<float4*>(a.m[tv]) + j;
        V[u] = reinterpret_cast<float4*>(a.v[tv]) + j;
        pp[u] = __ldcs(P[u]);
        mm[u] = __ldcs(M[u]);
        vv[u] = __ldcs(V[u]);
        gg[u] = __ldcs(reinterpret_cast<const float4*>(a.g[tv]) + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (in[u]) {
        adam4(pp[u], mm[u], vv[u], gg[u], h);
        __stcs(P[u], pp[u]);
        __stcs(M[u], mm[u]);
        __stcs(V[u], vv[u]);
      }
    }
  }
  // the scalar space: this block's equal share, one element a thread a step
  const long long slo = ns * blockIdx.x / gridDim.x, shi = ns * (blockIdx.x + 1ll) / gridDim.x;
  int t = 0;
  for (long long i = slo + threadIdx.x; i < shi; i += kThreads) {
    t = table_of(a.soff, i, t);
    const long long j = a.sfirst[t] + (i - a.soff[t]);
    float pp = a.p[t][j], mm = a.m[t][j], vv = a.v[t][j];
    adam1(pp, mm, vv, __ldg(a.g[t] + j), h);
    a.p[t][j] = pp;
    a.m[t][j] = mm;
    a.v[t][j] = vv;
  }
}

// Blocks of the persistent grid: a whole number a SM, as many as stay
// resident, and no more than the work needs.
int grid_for(long long n4, long long ns) {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& full = cached[dev & 63];
  if (full == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_stream_pass_kernel, kThreads,
                                                  0);
    full = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (n4 + kStep - 1) / kStep + (ns + kThreads - 1) / kThreads;
  return static_cast<int>(need < full ? (need < 1 ? 1 : need) : full);
}

}  // namespace

// One pass over `count` tables (1 <= count <= 32): table t is p[t], m[t],
// v[t] (updated in place) and g[t] (read), `n[t]` f32 elements each, the
// pointers at ptrs[4t .. 4t+3] in the order p, m, v, g.  omb1 = 1 − b1 and
// omb2 = 1 − b2.  One launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a count or size out of range.
extern "C" int adam_stream_launch(const uint64_t* ptrs, const long long* n, int count,
                                  float b1, float omb1, float b2, float omb2, float eps,
                                  float lr, void* stream) {
  if (count < 1 || count > kMaxTables) return cudaErrorInvalidValue;
  Pass a{};
  a.count = count;
  for (int t = 0; t < count; ++t) {
    if (n[t] < 0) return cudaErrorInvalidValue;
    a.p[t] = reinterpret_cast<float*>(ptrs[4 * t]);
    a.m[t] = reinterpret_cast<float*>(ptrs[4 * t + 1]);
    a.v[t] = reinterpret_cast<float*>(ptrs[4 * t + 2]);
    a.g[t] = reinterpret_cast<const float*>(ptrs[4 * t + 3]);
    const uint64_t align = ptrs[4 * t] | ptrs[4 * t + 1] | ptrs[4 * t + 2] | ptrs[4 * t + 3];
    const long long vec = (align & 15) == 0 ? n[t] / 4 : 0;
    a.voff[t + 1] = a.voff[t] + vec;
    a.sfirst[t] = 4 * vec;
    a.soff[t + 1] = a.soff[t] + n[t] - 4 * vec;
  }
  const long long n4 = a.voff[count], ns = a.soff[count];
  if (n4 + ns == 0) return 0;
  const Hyper h{b1, omb1, b2, omb2, eps, lr};
  adam_stream_pass_kernel<<<grid_for(n4, ns), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h);
  return static_cast<int>(cudaGetLastError());
}
