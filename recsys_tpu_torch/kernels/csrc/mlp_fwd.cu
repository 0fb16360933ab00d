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
// are a few MB, so device memory bounds it far less.
//
// The TPU kernel kept every weight resident in VMEM; 227 KB of shared
// memory cannot, so a CTA owns 32 batch rows for the whole stack (its
// hidden activations live only in shared memory, in two ping-pong buffers,
// and never reach device memory) and every weight streams past them.  (64
// rows would feed the tensor cores twice as well, but two 64-row buffers of
// the 1024-wide tower take 258 KB.)  f32 weights read from L2 by every CTA
// would be 1.06 GB of L2 reads per 4096-row call of the top tower, each
// rounded again in every CTA, so:
//   1. A pre-pass (pack_tiles_kernel, mlp_tiles.cuh) rounds the weights to
//      bf16 once a call and packs them as contiguous 64 x 128 tiles in the
//      padded layout ldmatrix reads without bank conflicts, in the order
//      the chain consumes them (4.5 MB for the top tower).
//   2. The chain runs in thread block clusters of C = 2 CTAs (kCluster),
//      each with its own 32-row tile.  Three producer threads a CTA, each in a
//      warp of its own and issuing every third tile, keep a ring of up to 8
//      tile slots full with multicast bulk copies, so each tile leaves L2
//      once a cluster and lands in every CTA's slot.  Full and empty
//      mbarriers hand the slots over; the consumer warps release a slot to
//      the whole cluster.  The only block-wide barrier is one a layer,
//      which orders the epilogue's writes before the next layer reads them.
//   3. 16 consumer warps run mma.sync m16n8k16 (bf16 in, f32 accumulators)
//      on ldmatrix fragments, four to a column tile, each with its A
//      fragments loaded once a k tile; bias, relu and the rounding are
//      fused into the epilogue that writes the next buffer (or the output).
// Neither L2 nor its bandwidth bounds the chain.  The weights' delivery
// alone (no products, no epilogue) takes over half the chain's time and
// grows by under a fifth from 1024 rows to 4096 (four times the CTAs and
// the L2 reads), at 2 ring stages or 5: what bounds it is the
// latency of each tile's hand-over (the slot waits, the expected bytes,
// the copy's issue), paid once a tile.  Hence 64-deep tiles (half the hand-overs of 32-deep
// ones) and three producers walking the hand-overs side by side.  Beside
// the hand-over, each CTA still streams the whole packed
// stack past 32 rows, and mma.sync reaches a fraction of the wgmma rate.
// The exact-f32 path (16-row tiles, FMA on the CUDA cores, the weights
// staged from f32 in every block) is kept for its exact results.

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

__global__ void __launch_bounds__(kChainThreads, 1)
    mlp_fwd_bf16_kernel(const float* __restrict__ x, float* __restrict__ out, MlpArgs args,
                        Chain chain, const __nv_bfloat16* __restrict__ tiles, int B, int ld,
                        int stages) {
  constexpr int BM = kBMbf16;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  __nv_bfloat16* in = ring_setup(ring, smem, stages, ld);
  __nv_bfloat16* nxt = in + BM * ld;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, B - row0);  // <= 0 past the batch

  if (tid >= kConsumers) {
    if ((tid & 31) == 0) produce(chain, tiles, ring);
  } else {
    // input tile, rounded to bf16; the columns up to the next multiple of
    // 64 are zero because each product reads whole 64-deep tiles
    const int d0 = args.dims[0];
    const int d0p = (d0 + 63) & ~63;
    for (int i = tid; i < BM * d0p; i += kConsumers) {
      const int r = i / d0p, c = i - r * d0p;
      const float v = (r < rows && c < d0) ? x[static_cast<size_t>(row0 + r) * d0 + c] : 0.f;
      in[r * ld + c] = __float2bfloat16_rn(v);
    }
    for (int l = 0; l < args.n_layers; ++l) {
      const int N = args.dims[l + 1];
      const float* __restrict__ bias = args.b[l];
      if (l == args.n_layers - 1) {
        consume_step(in, ld, args.dims[l], N, ring, [&](int rr, int n, float acc) {
          if (n < N && rr < rows)
            out[static_cast<size_t>(row0 + rr) * N + n] =
                __bfloat162float(__float2bfloat16_rn(acc + bias[n]));
        });
      } else {
        // columns past N, up to ld - 8, are the zeros the next layer's last
        // mma step reads
        consume_step(in, ld, args.dims[l], N, ring, [&](int rr, int n, float acc) {
          nxt[rr * ld + n] = __float2bfloat16_rn(n < N ? relu(acc + bias[n]) : 0.f);
        });
      }
      __nv_bfloat16* t = in;
      in = nxt;
      nxt = t;
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still arrive on its barriers
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
// A bf16 stack too wide for 8 ring stages takes fewer, down to 2.
extern "C" long long mlp_fwd_smem_bytes(const int* dims, int n_layers, int mm_bf16) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  if (mm_bf16) {
    const int ld = chain_ld(dims, n_layers);
    const int stages = chain_stages(ld);
    return stages ? chain_smem(stages, ld) : 0;
  }
  const long long bytes = 4LL * (kBK * kBN + 2LL * kBMf32 * dims_max(dims, n_layers));
  return bytes > 227LL * 1024 ? 0 : bytes;
}

// How many clusters of the bf16 chain the card holds at once at these
// widths (or minus a CUDA error); *cluster is set to their CTAs, C.
extern "C" int mlp_fwd_max_active_clusters(const int* dims, int n_layers, int* cluster) {
  *cluster = kCluster;
  const long long smem = mlp_fwd_smem_bytes(dims, n_layers, 1);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_clusters(mlp_fwd_bf16_kernel, smem);
}

// x: (B, dims[0]) f32; ws[l]: (dims[l], dims[l+1]) f32; bs[l]: (dims[l+1],)
// f32; out: (B, dims[n_layers]) f32.  ws and bs are host arrays of device
// pointers.  bf16: `packed` holds the pre-pass's tiles (kTileElems bf16
// each, Σ_l k_tiles(dims[l]) * n_tiles(dims[l+1]) of them), and `parts`
// picks the launches: 1 the pre-pass, 2 the
// chain (3 both; the parts apart are for timing).  The f32 path ignores
// them.  Launches on `stream` and returns the first CUDA error.
extern "C" int mlp_fwd_launch(const void* x, void* out, const void* const* ws,
                              const void* const* bs, void* packed, const int* dims,
                              int n_layers, int B, int mm_bf16, int parts, void* stream) {
  const long long smem = mlp_fwd_smem_bytes(dims, n_layers, mm_bf16);
  if (smem == 0 || B < 1) return cudaErrorInvalidValue;
  MlpArgs args = {};
  for (int l = 0; l < n_layers; ++l) {
    args.w[l] = static_cast<const float*>(ws[l]);
    args.b[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n_layers; ++l) args.dims[l] = dims[l];
  args.n_layers = n_layers;
  const int ld = chain_ld(dims, n_layers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mm_bf16) {
    cudaFuncSetAttribute(mlp_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mlp_fwd_f32_kernel<<<(B + kBMf32 - 1) / kBMf32, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), args, B, dims_max(dims, n_layers));
    return static_cast<int>(cudaGetLastError());
  }
  Chain chain = {};
  for (int l = 0; l < n_layers; ++l) add_step(chain, args.w[l], dims[l], dims[l + 1], 0);
  __nv_bfloat16* tiles = static_cast<__nv_bfloat16*>(packed);
  if (parts & 1) {
    pack_tiles_kernel<<<chain.tile0[chain.n_steps], kThreads, 0, s>>>(chain, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    const cudaError_t err = launch_chain(mlp_fwd_bf16_kernel, B, smem, s,
                                         static_cast<const float*>(x), static_cast<float*>(out),
                                         args, chain, tiles, B, ld, chain_stages(ld));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
