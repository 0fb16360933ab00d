// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/attention_tpu.py::flash_attention_fwd
// (body _flash_kernel).  q (BH, Sq, D), k and v (BH, Sk, D) f32, an optional
// key-padding mask (B, Sk) int32 (nonzero = attend, batch row bh / H) and an
// optional causal mask q_index >= k_index -> out (BH, Sq, D) f32 and the
// per-row logsumexp lse (BH, Sq) f32.  A query row with no key to attend
// gives 0 and lse = -1e9; key rows past Sk are excluded and read as 0.
//
// Bound on the H100: operations.  At the SASRec bench shape (BH = 512,
// S = 512, D = 32, causal) the two products need 4·S(S+1)/2·D flops per head
// in exact f32 (8.6 GFLOP, 0.13 ms at 67 TFLOP/s on the CUDA cores) and move
// 134 MB (0.04 ms at 3.35 TB/s).
//
// Design: one block of 256 threads per (bh, 64-row q tile), heaviest causal
// tiles first.  The q tile stays in shared memory; 64-row k/v tiles stream
// through it, k transposed for the score product and v row-major for P·V.
// The softmax is online: each row keeps a running max and normaliser in
// registers (the 16 threads of a row group hold the same copy), and a tile's
// P goes through shared memory into the P·V product.  Causal tiles above the
// diagonal are skipped.  Scores and products are exact f32 FMAs on the CUDA
// cores; bf16 operands on the tensor cores (wgmma) and TMA loads are the
// next steps for speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

size_t fwd_smem_floats(int D) {
  return 2 * static_cast<size_t>(D) * kLdt + static_cast<size_t>(kB) * D +
         static_cast<size_t>(kB) * kLdt;
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][kLdt]
  float* kT = qT + D * kLdt;                     // [D][kLdt]
  float* vs = kT + D * kLdt;                     // [kB][D]
  float* pT = vs + kB * D;                       // [kB keys][kLdt]

  const int nq = (Sq + kB - 1) / kB;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * kB;
  const int tr = tile_row(), tc = tile_col();
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const float* kb = k + static_cast<size_t>(bh) * Sk * D;
  const float* vb = v + static_cast<size_t>(bh) * Sk * D;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  load_transposed(qT, qb, q0, min(kB, Sq - q0), D);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, (q0 + kB - 1) / kB + 1);  // tiles that reach the diagonal
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB, kval = min(kB, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_transposed(kT, kb, k0, kval, D);
    load_rows(vs, vb, k0, kval, D);
    __syncthreads();

    float s[4][4];
    mm_tile(qT, kT, D, s);
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tc + j;
      kok[j] = c < kval && (mrow == nullptr || mrow[k0 + c] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kok[j] && (!causal || row >= k0 + 4 * tc + j);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a masked entry stays 0 even while every key so far is masked
        s[i][j] = s[i][j] > kNegInf / 2 ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    store_transposed(pT, s);
    __syncthreads();
    acc_update<DPT>(pT, vs, D, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= Sq) continue;
    const bool live = l[i] > 0.f;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tc + 16 * c;
      if (d < D) orow[d] = live ? acc[i][c] * inv : 0.f;
    }
    if (tc == 0)
      lse[static_cast<size_t>(bh) * Sq + row] =
          live ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kNegInf;
  }
}

template <int DPT>
cudaError_t launch(const float* q, const float* k, const float* v, const int* mask,
                   float* out, float* lse, int BH, int H, int Sq, int Sk, int D,
                   float scale, int causal, cudaStream_t s) {
  const size_t smem = fwd_smem_floats(D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(BH) * ((Sq + kB - 1) / kB);
  flash_fwd_kernel<DPT><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      q, k, v, mask, out, lse, H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for head dim D, or 0 when the kernel
// does not take D (a multiple of 8 in [8, 128]).
extern "C" long long flash_attention_fwd_smem_bytes(int D) {
  if (flash::dims_per_thread(D) == 0) return 0;
  return static_cast<long long>(fwd_smem_floats(D) * sizeof(float));
}

// q (BH, Sq, D), k/v (BH, Sk, D), mask (BH / H, Sk) int32 or null, out
// (BH, Sq, D), lse (BH, Sq); every pointer 16-byte aligned, f32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse,
                                          int BH, int H, int Sq, int Sk, int D,
                                          float scale, int causal, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || Sq < 1 || Sk < 1 ||
      static_cast<long long>(BH) * ((Sq + flash::kB - 1) / flash::kB) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  const int* mp = static_cast<const int*>(mask);
  float *op = static_cast<float*>(out), *lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flash::dims_per_thread(D)) {
    case 1: return launch<1>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 2: return launch<2>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 4: return launch<4>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 8: return launch<8>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
