// Fused multi-layer MLP backward for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/mlp_tpu.py::mlp_bwd_pallas (body
// _bwd_kernel).  x (B, D0) f32, the output cotangent g (B, Dk) f32, weights
// W_i (D_i, D_{i+1}) f32 and biases b_i f32 -> dx (B, D0) f32, dW_i and
// db_i f32.  Rounding as the TPU kernel: the hidden layers are recomputed
// as the forward does, each rounded to the matmul type; dh = g rounded;
// walking the layers in reverse, below the last layer dh is masked by
// h_{i+1} > 0 (and rounded), dW_i = h_iᵀ·dh and db_i = Σ dh in f32, then
// dh = dh·W_iᵀ accumulated in f32 and rounded.  With mm_bf16 the matmul
// type is bf16, otherwise exact f32 (no TF32).
//
// Bound on the H100: operations.  At a 4096-row microbatch the DLRM top
// tower (ΣW = 2.08 M) does 6·B·ΣW ≈ 51 GFLOP (recompute, dx and dW), about
// 52 us at 989 TFLOP/s bf16; the bottom tower (ΣW = 142 k) about 3.5 us.
//
// Design: the TPU kernel kept dW and db in output blocks that stay resident
// while its grid runs in order.  CUDA blocks run in no order, so the sum
// over the batch is a second kernel with each output tile owned by one
// block (no atomics, deterministic):
//   A. per row tile, as mlp_fwd.cu: recompute the hidden layers in shared
//      memory, then walk the chain backwards (dh·W_iᵀ, with W_iᵀ staged
//      like a forward weight from a transposed copy the wrapper makes).
//      It emits dx, and writes each layer's rounded input h_i and masked
//      cotangent dz_i, in the matmul type, to scratch the wrapper
//      allocates (rows padded to 8 columns with zeros, for 16-byte loads).
//   B. one block per (64 x 128) tile of any layer's dW_i = h_iᵀ·dz_i,
//      summing over the batch in 32-row steps; the blocks of the first row
//      of tiles also sum dz_i's columns into db_i.
// bf16: mma.sync m16n8k16 with f32 accumulation (A: 32-row tiles as in the
// forward; B: h_iᵀ fragments by ldmatrix.trans from k-major tiles).  f32:
// FMA on the CUDA cores.  The scratch round trip (26 MB each way for the
// top tower at 4096 rows, in bf16) and mma.sync's share of the wgmma rate
// keep this version well above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "mlp_tiles.cuh"

constexpr int kMaxLayers = 8;
// dW tiles of kernel B
constexpr int kTM = 64, kTN = 128, kTK = 32;  // bf16
constexpr int kFM = 64, kFN = 64, kFK = 32;   // f32

struct BwdArgs {
  const float* w[kMaxLayers];   // W_i (D_i, D_{i+1})
  const float* wt[kMaxLayers];  // W_iᵀ (D_{i+1}, D_i)
  const float* b[kMaxLayers];
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
  void* h[kMaxLayers];   // h_i (B, round8(D_i)), matmul type
  void* dz[kMaxLayers];  // dz_i (B, round8(D_{i+1})), matmul type
  int dims[kMaxLayers + 1];
  int n_layers;
  int tile_start[kMaxLayers + 1];  // kernel B: first tile of each layer
  int tiles_n[kMaxLayers];         // kernel B: column tiles of each layer
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ __nv_bfloat16 bf(float v) { return __float2bfloat16_rn(v); }

// out (BM x N) = in (BM x K, bf16 in shared memory, row stride ld, columns
// past K zero up to a multiple of 16) @ W (K x N, f32 row-major, rounded
// while staged), accumulated in f32.  epi(row, col, acc) is called for every
// row of the tile and every column of each 128-wide pass below ld.
template <class Epi>
__device__ __forceinline__ void layer_bf16(const __nv_bfloat16* in, int ld,
                                           __nv_bfloat16* wbuf,
                                           const float* __restrict__ W, int K,
                                           int N, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kp = (K + 15) & ~15;
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const int nk = (kp + kBKb - 1) / kBKb;
  const int tiles = nk * ((N + kBN - 1) / kBN);
  float4 r[kTileRegs];
  fetch_tile(r, W, K, N, 0, 0, vec);
  store_tile(wbuf, r);
  __syncthreads();  // also orders the writes of `in` before its reads
  float acc[2][2][4] = {};
  for (int t = 0; t < tiles; ++t) {
    const int k0 = (t % nk) * kBKb, n0 = (t / nk) * kBN;
    if (t + 1 < tiles)
      fetch_tile(r, W, K, N, ((t + 1) % nk) * kBKb, ((t + 1) / nk) * kBN, vec);
    const __nv_bfloat16* wt = wbuf + (t & 1) * kBKb * kWLd;
    const int ksteps = min(kBKb, kp - k0);
    for (int ks = 0; ks < ksteps; ks += 16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], in + (mi * 16 + (lane & 15)) * ld + k0 + ks + (lane >> 4) * 8);
      ldmatrix_x4_trans(b, wt + (ks + (lane & 15)) * kWLd + warp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16_16816(acc[mi][0], a[mi], b[0], b[1]);
        mma_bf16_16816(acc[mi][1], a[mi], b[2], b[3]);
      }
    }
    if (t + 1 < tiles) store_tile(wbuf + ((t + 1) & 1) * kBKb * kWLd, r);
    if (t % nk == nk - 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + warp * 16 + ni * 8 + tig * 2 + (e & 1);
            if (n < ld) epi(mi * 16 + gid + (e >> 1) * 8, n, acc[mi][ni][e]);
            acc[mi][ni][e] = 0.f;
          }
    }
    __syncthreads();
  }
}

// The same product in exact f32 on the CUDA cores (16-row tiles, row
// stride ld of `in`); epi is called for columns below N only.
template <class Epi>
__device__ __forceinline__ void layer_f32(const float* in, int ld, float* wt,
                                          const float* __restrict__ W, int K,
                                          int N, Epi epi) {
  constexpr int TM = kBMf32 / 8, TN = kBN / 32;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  __syncthreads();  // orders the writes of `in` before its reads
  for (int n0 = 0; n0 < N; n0 += kBN) {
    float acc[TM][TN] = {};
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const int kc = min(kBK, K - k0);
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kk = i / kBN, nn = i % kBN;
        wt[i] = (kk < kc && n0 + nn < N) ? W[static_cast<size_t>(k0 + kk) * N + n0 + nn] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float a[TM], w[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = in[(ty + 8 * i) * ld + k0 + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) w[j] = wt[kk * kBN + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) epi(ty + 8 * i, n, acc[i][j]);
    }
  }
  __syncthreads();
}

// Kernel A, bf16.
__global__ void __launch_bounds__(kThreads)
    chain_bf16_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ dx, BwdArgs a, int B, int ld) {
  constexpr int BM = kBMbf16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* in = wbuf + 2 * kBKb * kWLd;  // [BM][ld]
  __nv_bfloat16* nxt = in + BM * ld;           // [BM][ld]
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);
  const int n_layers = a.n_layers;

  // h_0 = x rounded; columns up to a multiple of 16 are zero
  {
    const int d = a.dims[0], dp = (d + 15) & ~15, l8 = round8(d);
    __nv_bfloat16* h0 = static_cast<__nv_bfloat16*>(a.h[0]);
    for (int i = threadIdx.x; i < BM * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const __nv_bfloat16 v =
          bf((r < rows && c < d) ? x[static_cast<size_t>(row0 + r) * d + c] : 0.f);
      in[r * ld + c] = v;
      if (r < rows && c < l8) h0[static_cast<size_t>(row0 + r) * l8 + c] = v;
    }
  }
  // recompute h_1 .. h_{n-1} (the last layer's output is not needed)
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int N = a.dims[l + 1], l8 = round8(N);
    const float* __restrict__ bias = a.b[l];
    __nv_bfloat16* hn = static_cast<__nv_bfloat16*>(a.h[l + 1]);
    layer_bf16(in, ld, wbuf, a.w[l], a.dims[l], N, [&](int rr, int n, float z) {
      const __nv_bfloat16 v = bf(n < N ? relu(z + bias[n]) : 0.f);
      nxt[rr * ld + n] = v;
      if (rr < rows && n < l8) hn[static_cast<size_t>(row0 + rr) * l8 + n] = v;
    });
    __nv_bfloat16* t = in;
    in = nxt;
    nxt = t;
  }
  // dz_{n-1} = g rounded, over the last h (no longer read)
  __syncthreads();
  {
    const int d = a.dims[n_layers], dp = (d + 15) & ~15, l8 = round8(d);
    __nv_bfloat16* dzl = static_cast<__nv_bfloat16*>(a.dz[n_layers - 1]);
    for (int i = threadIdx.x; i < BM * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      const __nv_bfloat16 v =
          bf((r < rows && c < d) ? g[static_cast<size_t>(row0 + r) * d + c] : 0.f);
      in[r * ld + c] = v;
      if (r < rows && c < l8) dzl[static_cast<size_t>(row0 + r) * l8 + c] = v;
    }
  }
  // dh_i = dz_i · W_iᵀ, rounded; masked by h_i > 0 it is dz_{i-1}
  for (int i = n_layers - 1; i >= 0; --i) {
    const int N = a.dims[i], l8 = round8(N);
    if (i > 0) {
      const __nv_bfloat16* hm = static_cast<const __nv_bfloat16*>(a.h[i]);
      __nv_bfloat16* dzo = static_cast<__nv_bfloat16*>(a.dz[i - 1]);
      layer_bf16(in, ld, wbuf, a.wt[i], a.dims[i + 1], N, [&](int rr, int n, float z) {
        __nv_bfloat16 v = bf(0.f);
        if (n < N && rr < rows &&
            __bfloat162float(hm[static_cast<size_t>(row0 + rr) * l8 + n]) > 0.f)
          v = bf(z);
        nxt[rr * ld + n] = v;
        if (rr < rows && n < l8) dzo[static_cast<size_t>(row0 + rr) * l8 + n] = v;
      });
    } else {
      layer_bf16(in, ld, wbuf, a.wt[0], a.dims[1], N, [&](int rr, int n, float z) {
        if (rr < rows && n < N)
          dx[static_cast<size_t>(row0 + rr) * N + n] = __bfloat162float(bf(z));
      });
    }
    __nv_bfloat16* t = in;
    in = nxt;
    nxt = t;
  }
}

// Kernel A, exact f32.
__global__ void __launch_bounds__(kThreads)
    chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, BwdArgs a, int B, int ld) {
  constexpr int BM = kBMf32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);  // [kBK][kBN]
  float* in = wt + kBK * kBN;                  // [BM][ld]
  float* nxt = in + BM * ld;                   // [BM][ld]
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);
  const int n_layers = a.n_layers;

  {
    const int d = a.dims[0], l8 = round8(d);
    float* h0 = static_cast<float*>(a.h[0]);
    for (int i = threadIdx.x; i < BM * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const float v = r < rows ? x[static_cast<size_t>(row0 + r) * d + c] : 0.f;
      in[r * ld + c] = v;
      if (r < rows) h0[static_cast<size_t>(row0 + r) * l8 + c] = v;
    }
  }
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int N = a.dims[l + 1], l8 = round8(N);
    const float* __restrict__ bias = a.b[l];
    float* hn = static_cast<float*>(a.h[l + 1]);
    layer_f32(in, ld, wt, a.w[l], a.dims[l], N, [&](int rr, int n, float z) {
      const float v = relu(z + bias[n]);
      nxt[rr * ld + n] = v;
      if (rr < rows) hn[static_cast<size_t>(row0 + rr) * l8 + n] = v;
    });
    float* t = in;
    in = nxt;
    nxt = t;
  }
  __syncthreads();
  {
    const int d = a.dims[n_layers], l8 = round8(d);
    float* dzl = static_cast<float*>(a.dz[n_layers - 1]);
    for (int i = threadIdx.x; i < BM * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const float v = r < rows ? g[static_cast<size_t>(row0 + r) * d + c] : 0.f;
      in[r * ld + c] = v;
      if (r < rows) dzl[static_cast<size_t>(row0 + r) * l8 + c] = v;
    }
  }
  for (int i = n_layers - 1; i >= 0; --i) {
    const int N = a.dims[i], l8 = round8(N);
    if (i > 0) {
      const float* hm = static_cast<const float*>(a.h[i]);
      float* dzo = static_cast<float*>(a.dz[i - 1]);
      layer_f32(in, ld, wt, a.wt[i], a.dims[i + 1], N, [&](int rr, int n, float z) {
        const float v =
            (rr < rows && hm[static_cast<size_t>(row0 + rr) * l8 + n] > 0.f) ? z : 0.f;
        nxt[rr * ld + n] = v;
        if (rr < rows) dzo[static_cast<size_t>(row0 + rr) * l8 + n] = v;
      });
    } else {
      layer_f32(in, ld, wt, a.wt[0], a.dims[1], N, [&](int rr, int n, float z) {
        if (rr < rows) dx[static_cast<size_t>(row0 + rr) * N + n] = z;
      });
    }
    float* t = in;
    in = nxt;
    nxt = t;
  }
}

// Which layer's dW tile this block owns: (layer, first row m0, first column n0).
__device__ __forceinline__ void tile_of(const BwdArgs& a, int tm, int tn, int& l,
                                        int& m0, int& n0) {
  int t = blockIdx.x;
  l = 0;
  while (t >= a.tile_start[l + 1]) ++l;
  t -= a.tile_start[l];
  m0 = (t / a.tiles_n[l]) * tm;
  n0 = (t % a.tiles_n[l]) * tn;
}

// Kernel B, bf16: dW_l[m0:+64, n0:+128] = h_lᵀ·dz_l over the batch.
__global__ void __launch_bounds__(kThreads) dw_bf16_kernel(BwdArgs a, int B) {
  __shared__ __align__(16) __nv_bfloat16 hs[kTK][kTM + 8];  // [k][m]
  __shared__ __align__(16) __nv_bfloat16 zs[kTK][kTN + 8];  // [k][n]
  int l, m0, n0;
  tile_of(a, kTM, kTN, l, m0, n0);
  const int M = a.dims[l], N = a.dims[l + 1];
  const int ldh = round8(M), ldz = round8(N);
  const __nv_bfloat16* H = static_cast<const __nv_bfloat16*>(a.h[l]);
  const __nv_bfloat16* Z = static_cast<const __nv_bfloat16*>(a.dz[l]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool sums = m0 == 0 && tid < kTN;  // this thread also sums db
  float acc[4][2][4] = {};
  float colsum = 0.f;
  for (int k0 = 0; k0 < B; k0 += kTK) {
    {  // 32 x 64 of h: one 16-byte load per thread
      const int r = tid >> 3, c = (tid & 7) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + r < B && m0 + c < ldh)
        v = *reinterpret_cast<const uint4*>(H + static_cast<size_t>(k0 + r) * ldh + m0 + c);
      *reinterpret_cast<uint4*>(&hs[r][c]) = v;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 32 x 128 of dz: two per thread
      const int q = tid + kThreads * j, r = q >> 4, c = (q & 15) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + r < B && n0 + c < ldz)
        v = *reinterpret_cast<const uint4*>(Z + static_cast<size_t>(k0 + r) * ldz + n0 + c);
      *reinterpret_cast<uint4*>(&zs[r][c]) = v;
    }
    __syncthreads();
    if (sums)
      for (int r = 0; r < kTK; ++r) colsum += __bfloat162float(zs[r][tid]);
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 16) {
      uint32_t af[4][4], b[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], &hs[ks + (lane & 7) + ((lane >> 4) << 3)]
                                     [mi * 16 + ((lane >> 3) & 1) * 8]);
      ldmatrix_x4_trans(b, &zs[ks + (lane & 15)][warp * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        mma_bf16_16816(acc[mi][0], af[mi], b[0], b[1]);
        mma_bf16_16816(acc[mi][1], af[mi], b[2], b[3]);
      }
    }
    __syncthreads();
  }
  float* dw = a.dw[l];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mi * 16 + gid + (e >> 1) * 8;
        const int n = n0 + warp * 16 + ni * 8 + tig * 2 + (e & 1);
        if (m < M && n < N) dw[static_cast<size_t>(m) * N + n] = acc[mi][ni][e];
      }
  if (sums && n0 + tid < N) a.db[l][n0 + tid] = colsum;
}

// Kernel B, exact f32: dW_l[m0:+64, n0:+64], 4 x 4 outputs per thread.
__global__ void __launch_bounds__(kThreads) dw_f32_kernel(BwdArgs a, int B) {
  __shared__ float hs[kFK][kFM];
  __shared__ float zs[kFK][kFN];
  int l, m0, n0;
  tile_of(a, kFM, kFN, l, m0, n0);
  const int M = a.dims[l], N = a.dims[l + 1];
  const int ldh = round8(M), ldz = round8(N);
  const float* H = static_cast<const float*>(a.h[l]);
  const float* Z = static_cast<const float*>(a.dz[l]);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool sums = m0 == 0 && tid < kFN;
  float acc[4][4] = {};
  float colsum = 0.f;
  for (int k0 = 0; k0 < B; k0 += kFK) {
    for (int q = tid; q < kFK * kFM; q += kThreads) {
      const int r = q / kFM, c = q % kFM;
      hs[r][c] = (k0 + r < B && m0 + c < M) ? H[static_cast<size_t>(k0 + r) * ldh + m0 + c] : 0.f;
      zs[r][c] = (k0 + r < B && n0 + c < N) ? Z[static_cast<size_t>(k0 + r) * ldz + n0 + c] : 0.f;
    }
    __syncthreads();
    if (sums)
      for (int r = 0; r < kFK; ++r) colsum += zs[r][tid];
    for (int kk = 0; kk < kFK; ++kk) {
      float hv[4], zv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) zv[j] = zs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], zv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dw = a.dw[l];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) dw[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  if (sums && n0 + tid < N) a.db[l][n0 + tid] = colsum;
}

}  // namespace

// Dynamic shared memory kernel A asks for (0 when the stack is too wide or
// too deep for one block); the wrapper uses it to refuse shapes up front.
extern "C" long long mlp_bwd_smem_bytes(const int* dims, int n_layers, int mm_bf16) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  int dmax = 0;
  for (int l = 0; l <= n_layers; ++l) dmax = dims[l] > dmax ? dims[l] : dmax;
  long long bytes;
  if (mm_bf16) {
    const int ld = ((dmax + 63) / 64) * 64 + 8;
    bytes = 2LL * (2LL * kBKb * kWLd + 2LL * kBMbf16 * ld);
  } else {
    bytes = 4LL * (kBK * kBN + 2LL * kBMf32 * dmax);
  }
  return bytes > 227LL * 1024 ? 0 : bytes;
}

// x (B, dims[0]) f32, g (B, dims[n]) f32 -> dx (B, dims[0]) f32; ws, wts,
// bs, dws, dbs are host arrays of device pointers: W_i (dims[i], dims[i+1]),
// W_iᵀ (dims[i+1], dims[i]), b_i, dW_i like W_i and db_i (dims[i+1]), all
// f32.  h and dz are scratch in the matmul type (bf16 with mm_bf16, else
// f32) of B·Σ_{i<n} round8(dims[i]) and B·Σ_{i<n} round8(dims[i+1])
// elements.  Launches kernels A and B on `stream`; returns the first CUDA
// error of a launch (0 when both launched).
extern "C" int mlp_bwd_launch(const void* x, const void* g, void* dx,
                              const void* const* ws, const void* const* wts,
                              const void* const* bs, void* const* dws,
                              void* const* dbs, void* h, void* dz,
                              const int* dims, int n_layers, int B, int mm_bf16,
                              void* stream) {
  const long long smem = mlp_bwd_smem_bytes(dims, n_layers, mm_bf16);
  if (smem == 0 || B < 1) return cudaErrorInvalidValue;
  BwdArgs a = {};
  const size_t elem = mm_bf16 ? 2 : 4;
  char* hp = static_cast<char*>(h);
  char* zp = static_cast<char*>(dz);
  const int tm = mm_bf16 ? kTM : kFM, tn = mm_bf16 ? kTN : kFN;
  int dmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(ws[l]);
    a.wt[l] = static_cast<const float*>(wts[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.dw[l] = static_cast<float*>(dws[l]);
    a.db[l] = static_cast<float*>(dbs[l]);
    a.h[l] = hp;
    a.dz[l] = zp;
    hp += static_cast<size_t>(B) * round8(dims[l]) * elem;
    zp += static_cast<size_t>(B) * round8(dims[l + 1]) * elem;
    a.tiles_n[l] = (dims[l + 1] + tn - 1) / tn;
    a.tile_start[l + 1] = a.tile_start[l] + ((dims[l] + tm - 1) / tm) * a.tiles_n[l];
  }
  for (int l = 0; l <= n_layers; ++l) {
    a.dims[l] = dims[l];
    dmax = dims[l] > dmax ? dims[l] : dmax;
  }
  a.n_layers = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  if (mm_bf16) {
    const int ld = ((dmax + 63) / 64) * 64 + 8;
    cudaFuncSetAttribute(chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    chain_bf16_kernel<<<(B + kBMbf16 - 1) / kBMbf16, kThreads, smem, s>>>(xf, gf, dxf, a, B, ld);
  } else {
    cudaFuncSetAttribute(chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    chain_f32_kernel<<<(B + kBMf32 - 1) / kBMf32, kThreads, smem, s>>>(xf, gf, dxf, a, B, dmax);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mm_bf16)
    dw_bf16_kernel<<<a.tile_start[n_layers], kThreads, 0, s>>>(a, B);
  else
    dw_f32_kernel<<<a.tile_start[n_layers], kThreads, 0, s>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}
