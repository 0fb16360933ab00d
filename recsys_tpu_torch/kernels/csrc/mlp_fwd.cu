// Fused multi-layer MLP forward for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/mlp_tpu.py::mlp_fwd_pallas (body
// _fwd_kernel).  x (B, D0) f32; weights W_i (D_{i-1}, D_i) f32 row-major;
// biases b_i (D_i,) f32 -> (B, D_k) f32.  Relu on every layer but the last.
// Rounding as the TPU kernel: the input is rounded to the matmul type, each
// layer is h @ W accumulated in f32 plus the f32 bias, and every layer's
// output, the last one included, is rounded to the matmul type.  With
// mm_bf16 the matmul type is bf16, otherwise exact f32 (no TF32).
//
// Bound on the H100: operations.  The DLRM top tower 367->1024->1024->512->
// 256->1 is 2.08 M multiply-adds per example, ~17 GFLOP per 4096-row slice,
// about 17 us at 989 TFLOP/s bf16; its weights (8.3 MB f32) and activations
// are a few MB, so bytes bound it far less.
//
// Design: the TPU kernel kept every weight resident in VMEM; 227 KB of
// shared memory cannot, but the weights fit the 50 MB L2.  So one block
// owns a tile of batch rows for the whole stack: its hidden activations
// live only in shared memory, in two ping-pong buffers (layer l reads one
// and writes the other), and never reach device memory.  Weights stream
// from L2 tile by tile, rounded to the matmul type as they are staged.
// Bias, relu and the rounding are fused into the epilogue that writes the
// next buffer (or the output, for the last layer).
//   bf16: 32-row tiles, mma.sync m16n8k16 with f32 accumulators.  Weight
//         tiles (64 x 128) are fetched with 16-byte loads into registers
//         one tile ahead of the tensor cores, then rounded into a double
//         buffer in shared memory; fragments come from ldmatrix (.trans
//         for the k-major weight tile).  Row strides are padded so each
//         ldmatrix phase touches all 32 banks once.
//   f32:  16-row tiles, plain FMA on the CUDA cores (exact f32).
// Every block re-reads all f32 weights from L2 (1 GB per 4096-row slice of
// the top tower), and mma.sync reaches a fraction of the wgmma rate, so
// this version sits well above the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "mlp_tiles.cuh"

constexpr int kMaxLayers = 8;

struct MlpArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int n_layers;
};

__global__ void __launch_bounds__(kThreads)
    mlp_fwd_bf16_kernel(const float* __restrict__ x, float* __restrict__ out,
                        MlpArgs args, int B, int ld) {
  constexpr int BM = kBMbf16;
  extern __shared__ __align__(16) unsigned char smem[];
  // two weight tiles (double buffer), then the two activation buffers
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* in = wbuf + 2 * kBKb * kWLd;  // [BM][ld]
  __nv_bfloat16* nxt = in + BM * ld;           // [BM][ld]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);

  // input tile, rounded to bf16; the columns up to the next multiple of 16
  // are zero because each mma step reads 16 of them
  const int d0 = args.dims[0];
  const int d0p = (d0 + 15) & ~15;
  for (int i = tid; i < BM * d0p; i += kThreads) {
    const int r = i / d0p, c = i - r * d0p;
    const float v =
        (r < rows && c < d0) ? x[static_cast<size_t>(row0 + r) * d0 + c] : 0.f;
    in[r * ld + c] = __float2bfloat16_rn(v);
  }

  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const int kp = (K + 15) & ~15;
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ bias = args.b[l];
    const bool last = l == args.n_layers - 1;
    const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    // the layer is a sequence of tiles, k inner and n outer; tile t + 1 is
    // fetched into registers while tile t feeds the tensor cores
    const int nk = (kp + kBKb - 1) / kBKb;
    const int tiles = nk * ((N + kBN - 1) / kBN);
    float4 r[kTileRegs];
    fetch_tile(r, W, K, N, 0, 0, vec);
    store_tile(wbuf, r);
    __syncthreads();  // also orders the previous layer's epilogue writes

    float acc[2][2][4] = {};  // [m16 tile][n8 tile][fragment]
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

      if (t % nk == nk - 1) {  // the n tile is complete: fused epilogue
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = mi * 16 + gid + (e >> 1) * 8;
              const int n = n0 + warp * 16 + ni * 8 + tig * 2 + (e & 1);
              if (n < N) {
                const float z = acc[mi][ni][e] + bias[n];
                if (last) {
                  if (rr < rows)
                    out[static_cast<size_t>(row0 + rr) * N + n] =
                        __bfloat162float(__float2bfloat16_rn(z));
                } else {
                  nxt[rr * ld + n] = __float2bfloat16_rn(relu(z));
                }
              } else if (!last && n < ld) {
                // padding columns the next layer's last mma step reads
                nxt[rr * ld + n] = __float2bfloat16_rn(0.f);
              }
              acc[mi][ni][e] = 0.f;
            }
      }
      __syncthreads();
    }
    __nv_bfloat16* tmp = in;
    in = nxt;
    nxt = tmp;
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_fwd_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                       MlpArgs args, int B, int ld) {
  constexpr int BM = kBMf32, TM = BM / 8, TN = kBN / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);  // [kBK][kBN]
  float* in = wt + kBK * kBN;                  // [BM][ld]
  float* nxt = in + BM * ld;                   // [BM][ld]
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);

  const int d0 = args.dims[0];
  for (int i = tid; i < BM * d0; i += kThreads) {
    const int r = i / d0, c = i - r * d0;
    in[r * ld + c] = r < rows ? x[static_cast<size_t>(row0 + r) * d0 + c] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < args.n_layers; ++l) {
    const int K = args.dims[l], N = args.dims[l + 1];
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ bias = args.b[l];
    const bool last = l == args.n_layers - 1;
    for (int n0 = 0; n0 < N; n0 += kBN) {
      // thread (ty, tx) owns rows ty + 8i and columns n0 + tx + 32j
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kBK) {
        const int kc = min(kBK, K - k0);
        for (int i = tid; i < kBK * kBN; i += kThreads) {
          const int kk = i / kBN, nn = i % kBN;
          wt[i] = (kk < kc && n0 + nn < N)
                      ? W[static_cast<size_t>(k0 + kk) * N + n0 + nn]
                      : 0.f;
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
        const float bn = bias[n];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = ty + 8 * i;
          const float z = acc[i][j] + bn;
          if (last) {
            if (r < rows) out[static_cast<size_t>(row0 + r) * N + n] = z;
          } else {
            nxt[r * ld + n] = relu(z);
          }
        }
      }
    }
    __syncthreads();
    float* t = in;
    in = nxt;
    nxt = t;
  }
}

}  // namespace

// Dynamic shared memory the launch asks for (0 when the stack is too wide
// or too deep for one block); the wrapper uses it to refuse shapes up front.
extern "C" long long mlp_fwd_smem_bytes(const int* dims, int n_layers,
                                        int mm_bf16) {
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

// x: (B, dims[0]) f32; ws[l]: (dims[l], dims[l+1]) f32; bs[l]: (dims[l+1],)
// f32; out: (B, dims[n_layers]) f32.  ws and bs are host arrays of device
// pointers.  Launches on `stream` and returns cudaGetLastError().
extern "C" int mlp_fwd_launch(const void* x, void* out, const void* const* ws,
                              const void* const* bs, const int* dims,
                              int n_layers, int B, int mm_bf16, void* stream) {
  const long long smem = mlp_fwd_smem_bytes(dims, n_layers, mm_bf16);
  if (smem == 0 || B < 1) return cudaErrorInvalidValue;
  MlpArgs args = {};
  int dmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    args.w[l] = static_cast<const float*>(ws[l]);
    args.b[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    args.dims[l] = dims[l];
    dmax = dims[l] > dmax ? dims[l] : dmax;
  }
  args.n_layers = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mm_bf16) {
    const int ld = ((dmax + 63) / 64) * 64 + 8;
    cudaFuncSetAttribute(mlp_fwd_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mlp_fwd_bf16_kernel<<<(B + kBMbf16 - 1) / kBMbf16, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), args, B, ld);
  } else {
    cudaFuncSetAttribute(mlp_fwd_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mlp_fwd_f32_kernel<<<(B + kBMf32 - 1) / kBMf32, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), args, B, dmax);
  }
  return static_cast<int>(cudaGetLastError());
}
