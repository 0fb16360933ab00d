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
// The TPU kernel kept dW and db in output blocks that stay resident while
// its grid runs in order.  CUDA blocks run in no order, so the sum over the
// batch is a kernel of its own with each output tile owned by one block (no
// atomics, deterministic).  A bf16 call is up to four launches:
//   0. The pre-pass (pack_tiles_kernel, mlp_tiles.cuh) rounds each W_i to
//      bf16 once and packs W_0 .. W_{n-2} for the recompute and W_{n-1}ᵀ ..
//      W_0ᵀ for the walk back, in the order kernel A consumes them, from
//      the same f32 weights (no transposed copy).
//   A. Per 32-row tile, the chain of mlp_fwd.cu: recompute the hidden
//      layers in shared memory, then walk back (dh·W_iᵀ), emitting dx and
//      each layer's rounded input h_i and masked cotangent dz_i, in the
//      matmul type, to scratch (rows padded to 8 columns with zeros, for
//      16-byte loads).  It streams every weight twice, so as in the forward
//      clusters of C = 2 CTAs share each packed tile through one multicast
//      bulk copy into a ring of up to 8 slots with full and empty
//      mbarriers, 16 consumer warps run the products, and one barrier a
//      layer is left.  Each tile's hand-over and the mma.sync loop bound
//      it, not L2; beside them, the scratch round trip (26 MB of h and 23
//      MB of dz written for the top tower at 4096 rows, the relu mask read
//      back).
//   B. One block per (128 x 128) tile of any layer's dW_i = h_iᵀ·dz_i and
//      per slice of the batch, streaming 32-row steps of h_i and dz_i
//      through a 4-stage cp.async ring, so loads overlap the products; the
//      blocks of the first row of tiles also sum dz_i's columns into db_i.
//      Each tile reads its rows of h_i and dz_i once for every tile beside
//      it (about 270 MB of L2 reads a 4096-row call of the top tower; 410
//      MB at 64 x 128).  Where the tiles leave more than half the SMs idle (the
//      bottom tower has 15) the batch is cut into S slices of the rows
//      dispatch.mlp_bwd_split plans.
//   R. With S > 1, a small pass sums the slices' partial dW and db in slice
//      order: two launches give the same bits.
// bf16: mma.sync m16n8k16 with f32 accumulation (A: 32-row tiles as in the
// forward; B: h_iᵀ fragments by ldmatrix.trans from k-major tiles).  The
// exact-f32 path is kept for its exact results: FMA on the CUDA cores, W_iᵀ
// from a transposed copy the wrapper makes, one block a 64 x 64 dW tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "mlp_tiles.cuh"

constexpr int kMaxLayers = 8;
// dW tiles of kernel B
constexpr int kTM = 128, kTN = 128, kTK = 32;  // bf16
constexpr int kFM = 64, kFN = 64, kFK = 32;   // f32
constexpr int kDwStages = 4;
constexpr int kHsLd = kTM + 8, kZsLd = kTN + 8;
constexpr int kDwStageElems = kTK * (kHsLd + kZsLd);
constexpr int kDwSmem = kDwStages * kDwStageElems * 2;

struct BwdArgs {
  const float* w[kMaxLayers];   // W_i (D_i, D_{i+1})
  const float* wt[kMaxLayers];  // W_iᵀ (D_{i+1}, D_i), f32 path
  const float* b[kMaxLayers];
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
  void* h[kMaxLayers];   // h_i (B, round8(D_i)), matmul type
  void* dz[kMaxLayers];  // dz_i (B, round8(D_{i+1})), matmul type
  int dims[kMaxLayers + 1];
  int n_layers;
  int tile_start[kMaxLayers + 1];  // kernel B: first tile of each layer
  int tiles_n[kMaxLayers];         // kernel B: column tiles of each layer
  int part_off[kMaxLayers + 1];    // kernel B: layer l's dW then db in a slice's partials
};

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ __nv_bfloat16 bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Kernel A, bf16: the consumer warps run the chain, lane 0 of each producer
// warp feeds it.
__global__ void __launch_bounds__(kChainThreads, 1)
    chain_bf16_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ dx, BwdArgs a, Chain chain,
                      const __nv_bfloat16* __restrict__ tiles, int B, int ld, int stages) {
  constexpr int BM = kBMbf16;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  __nv_bfloat16* in = ring_setup(ring, smem, stages, ld);
  __nv_bfloat16* nxt = in + BM * ld;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);  // <= 0 past the batch
  const int n_layers = a.n_layers;

  if (tid >= kConsumers) {
    if ((tid & 31) == 0) produce(chain, tiles, ring);
    cluster_sync();
    return;
  }
  // h_0 = x rounded; columns up to a multiple of 64 are zero
  {
    const int d = a.dims[0], dp = (d + 63) & ~63, l8 = round8(d);
    __nv_bfloat16* h0 = static_cast<__nv_bfloat16*>(a.h[0]);
    for (int i = tid; i < BM * dp; i += kConsumers) {
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
    consume_step(in, ld, a.dims[l], N, ring, [&](int rr, int n, float z) {
      const __nv_bfloat16 v = bf(n < N ? relu(z + bias[n]) : 0.f);
      nxt[rr * ld + n] = v;
      if (rr < rows && n < l8) hn[static_cast<size_t>(row0 + rr) * l8 + n] = v;
    });
    __nv_bfloat16* t = in;
    in = nxt;
    nxt = t;
  }
  // dz_{n-1} = g rounded, over the last h (no longer read) once every
  // warp's epilogue is done with it
  consumer_sync();
  {
    const int d = a.dims[n_layers], dp = (d + 63) & ~63, l8 = round8(d);
    __nv_bfloat16* dzl = static_cast<__nv_bfloat16*>(a.dz[n_layers - 1]);
    for (int i = tid; i < BM * dp; i += kConsumers) {
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
      consume_step(in, ld, a.dims[i + 1], N, ring, [&](int rr, int n, float z) {
        __nv_bfloat16 v = bf(0.f);
        if (n < N && rr < rows &&
            __bfloat162float(hm[static_cast<size_t>(row0 + rr) * l8 + n]) > 0.f)
          v = bf(z);
        nxt[rr * ld + n] = v;
        if (rr < rows && n < l8) dzo[static_cast<size_t>(row0 + rr) * l8 + n] = v;
      });
    } else {
      consume_step(in, ld, a.dims[1], N, ring, [&](int rr, int n, float z) {
        if (rr < rows && n < N)
          dx[static_cast<size_t>(row0 + rr) * N + n] = __bfloat162float(bf(z));
      });
    }
    __nv_bfloat16* t = in;
    in = nxt;
    nxt = t;
  }
  cluster_sync();  // no CTA leaves while a peer may still arrive on its barriers
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

// Kernel B, bf16: dW_l[m0:+128, n0:+128] = h_lᵀ·dz_l over the rows of batch
// slice blockIdx.y, written to dW (one slice) or to the slice's partials.
// Warp w owns rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31.
__global__ void __launch_bounds__(kThreads)
    dw_bf16_kernel(BwdArgs a, int B, int slice_rows, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][hs | zs]
  int l, m0, n0;
  tile_of(a, kTM, kTN, l, m0, n0);
  const int M = a.dims[l], N = a.dims[l + 1];
  const int ldh = round8(M), ldz = round8(N);
  const __nv_bfloat16* H = static_cast<const __nv_bfloat16*>(a.h[l]);
  const __nv_bfloat16* Z = static_cast<const __nv_bfloat16*>(a.dz[l]);
  const int r0 = blockIdx.y * slice_rows, r1 = min(B, r0 + slice_rows);
  const int steps = (r1 - r0 + kTK - 1) / kTK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const bool sums = m0 == 0 && tid < kTN;  // this thread also sums db

  // step i: 32 rows of h and of dz (32 x 128 each, two 16-byte copies a
  // thread for each), zero past the slice and past the row
  auto load = [&](int i) {
    __nv_bfloat16* hs = ring + (i % kDwStages) * kDwStageElems;
    __nv_bfloat16* zs = hs + kTK * kHsLd;
    const int k0 = r0 + i * kTK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = tid + kThreads * j, r = q >> 4, c = (q & 15) * 8;
      const bool okh = k0 + r < r1 && m0 + c < ldh;
      cp_async16(hs + r * kHsLd + c, okh ? H + static_cast<size_t>(k0 + r) * ldh + m0 + c : H,
                 okh);
      const bool okz = k0 + r < r1 && n0 + c < ldz;
      cp_async16(zs + r * kZsLd + c, okz ? Z + static_cast<size_t>(k0 + r) * ldz + n0 + c : Z,
                 okz);
    }
  };
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  float acc[4][4][4] = {};  // [m16 tile][n8 tile][fragment]
  float colsum = 0.f;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kDwStages - 2>();  // step i has landed
    __syncthreads();                 // and every warp is done with step i - 1's slot
    if (i + kDwStages - 1 < steps) load(i + kDwStages - 1);
    cp_async_commit();
    const __nv_bfloat16* hs = ring + (i % kDwStages) * kDwStageElems;
    const __nv_bfloat16* zs = hs + kTK * kHsLd;
    if (sums)
      for (int r = 0; r < kTK; ++r) colsum += __bfloat162float(zs[r * kZsLd + tid]);
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 16) {
      uint32_t af[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], hs + (ks + (lane & 7) + ((lane >> 4) << 3)) * kHsLd + wm +
                                      mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(b[nj], zs + (ks + (lane & 15)) * kZsLd + wn + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16_16816(acc[mi][2 * nj], af[mi], b[nj][0], b[nj][1]);
          mma_bf16_16816(acc[mi][2 * nj + 1], af[mi], b[nj][2], b[nj][3]);
        }
    }
  }
  cp_async_wait<0>();
  float* dw = a.dw[l];
  float* db = a.db[l];
  size_t ld_out = N;
  if (partial) {  // this slice's partial sums, summed by dw_reduce_kernel
    dw = partial + static_cast<size_t>(blockIdx.y) * a.part_off[a.n_layers] + a.part_off[l];
    db = dw + static_cast<size_t>(M) * N;
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + gid + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + tig * 2 + (e & 1);
        if (m < M && n < N) dw[m * ld_out + n] = acc[mi][ni][e];
      }
  if (sums && n0 + tid < N) db[n0 + tid] = colsum;
}

// Pass R: dW and db as the sum of the slices' partials, in slice order.
__global__ void __launch_bounds__(kThreads)
    dw_reduce_kernel(BwdArgs a, const float* __restrict__ partial, int split) {
  const int total = a.part_off[a.n_layers];
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    int l = 0;
    while (e >= a.part_off[l + 1]) ++l;
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += partial[static_cast<size_t>(k) * total + e];
    const int i = e - a.part_off[l], mn = a.dims[l] * a.dims[l + 1];
    if (i < mn)
      a.dw[l][i] = s;
    else
      a.db[l][i - mn] = s;
  }
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
// A bf16 stack too wide for 8 ring stages takes fewer, down to 2.
extern "C" long long mlp_bwd_smem_bytes(const int* dims, int n_layers, int mm_bf16) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  if (mm_bf16) {
    const int ld = chain_ld(dims, n_layers);
    const int stages = chain_stages(ld);
    return stages ? chain_smem(stages, ld) : 0;
  }
  const long long bytes = 4LL * (kBK * kBN + 2LL * kBMf32 * dims_max(dims, n_layers));
  return bytes > 227LL * 1024 ? 0 : bytes;
}

// How many clusters of kernel A the card holds at once at these widths (or
// minus a CUDA error); *cluster is set to their CTAs, C.
extern "C" int mlp_bwd_max_active_clusters(const int* dims, int n_layers, int* cluster) {
  *cluster = kCluster;
  const long long smem = mlp_bwd_smem_bytes(dims, n_layers, 1);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_clusters(chain_bf16_kernel, smem);
}

// x (B, dims[0]) f32, g (B, dims[n]) f32 -> dx (B, dims[0]) f32; ws, wts,
// bs, dws, dbs are host arrays of device pointers: W_i (dims[i], dims[i+1]),
// W_iᵀ (dims[i+1], dims[i]; read by the f32 path only), b_i, dW_i like W_i
// and db_i (dims[i+1]), all f32.  h and dz are scratch in the matmul type
// (bf16 with mm_bf16, else f32) of B·Σ_{i<n} round8(dims[i]) and
// B·Σ_{i<n} round8(dims[i+1]) elements.  bf16 only: `packed` holds the
// pre-pass's tiles (kTileElems bf16 each: W_0 .. W_{n-2}, then W_{n-1}ᵀ ..
// W_0ᵀ), kernel B cuts the batch into S = ceil(B / split_rows) slices of
// `split_rows` rows (a multiple of 32), and with S > 1 `partial` holds
// S·Σ_i (dims[i]·dims[i+1] + dims[i+1]) f32.  `parts` picks the launches: 1 the pre-pass, 2 kernel A, 4 kernel B
// and pass R (7 all; the parts apart are for timing).  Launches on
// `stream`; returns the first CUDA error of a launch (0 when all launched).
extern "C" int mlp_bwd_launch(const void* x, const void* g, void* dx,
                              const void* const* ws, const void* const* wts,
                              const void* const* bs, void* const* dws,
                              void* const* dbs, void* h, void* dz, void* packed,
                              void* partial, const int* dims, int n_layers, int B,
                              int mm_bf16, int split_rows, int parts, void* stream) {
  const long long smem = mlp_bwd_smem_bytes(dims, n_layers, mm_bf16);
  if (smem == 0 || B < 1) return cudaErrorInvalidValue;
  const int split = mm_bf16 && split_rows > 0 ? (B + split_rows - 1) / split_rows : 1;
  if (mm_bf16 && (split_rows < 1 || split_rows % kTK != 0 || (split > 1 && partial == nullptr)))
    return cudaErrorInvalidValue;
  BwdArgs a = {};
  const size_t elem = mm_bf16 ? 2 : 4;
  char* hp = static_cast<char*>(h);
  char* zp = static_cast<char*>(dz);
  const int tm = mm_bf16 ? kTM : kFM, tn = mm_bf16 ? kTN : kFN;
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
    a.part_off[l + 1] = a.part_off[l] + dims[l] * dims[l + 1] + dims[l + 1];
  }
  for (int l = 0; l <= n_layers; ++l) a.dims[l] = dims[l];
  a.n_layers = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  cudaError_t err = cudaSuccess;
  if (!mm_bf16) {
    if (parts & 2) {
      cudaFuncSetAttribute(chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      chain_f32_kernel<<<(B + kBMf32 - 1) / kBMf32, kThreads, smem, s>>>(
          xf, gf, dxf, a, B, dims_max(dims, n_layers));
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if (parts & 4) dw_f32_kernel<<<a.tile_start[n_layers], kThreads, 0, s>>>(a, B);
    return static_cast<int>(cudaGetLastError());
  }
  Chain chain = {};
  for (int l = 0; l + 1 < n_layers; ++l) add_step(chain, a.w[l], dims[l], dims[l + 1], 0);
  for (int i = n_layers - 1; i >= 0; --i) add_step(chain, a.w[i], dims[i + 1], dims[i], 1);
  __nv_bfloat16* tiles = static_cast<__nv_bfloat16*>(packed);
  if (parts & 1) {
    pack_tiles_kernel<<<chain.tile0[chain.n_steps], kThreads, 0, s>>>(chain, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    const int ld = chain_ld(dims, n_layers);
    err = launch_chain(chain_bf16_kernel, B, smem, s, xf, gf, dxf, a, chain, tiles, B, ld,
                       chain_stages(ld));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 4) {
    float* part = split > 1 ? static_cast<float*>(partial) : nullptr;
    err = cudaFuncSetAttribute(dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDwSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw_bf16_kernel<<<dim3(a.tile_start[n_layers], split), kThreads, kDwSmem, s>>>(a, B,
                                                                                 split_rows, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (split > 1) {
      const int total = a.part_off[n_layers];
      const int blocks = min((total + kThreads - 1) / kThreads, 1024);
      dw_reduce_kernel<<<blocks, kThreads, 0, s>>>(a, part, split);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
