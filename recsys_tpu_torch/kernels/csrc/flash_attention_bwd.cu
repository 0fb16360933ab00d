// Flash-attention backward for Hopper (sm_90a).
//
// Replaces: recsys_tpu/kernels/pallas/attention_tpu.py::flash_attention_bwd
// (bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  From q, k, v,
// the mask and causal flag of the forward, its lse (BH, Sq), the output
// cotangent dO (BH, Sq, D) and delta = rowsum(dO·O) (BH, Sq), all f32:
// dq (BH, Sq, D), dk and dv (BH, Sk, D), f32.  P is recomputed from lse
// tile by tile with the forward's masking, so memory stays O(S); a row with
// lse = -1e9 (no key to attend) has P = 0 and adds nothing.
//
// Bound on the H100: operations.  Five products of the forward's size
// (S, dP, dV, dQ, dK), 10·S(S+1)/2·D flops per causal head in exact f32:
// 21 GFLOP at the SASRec bench shape (BH = 512, S = 512, D = 32), 0.32 ms
// at 67 TFLOP/s.  This kernel pair recomputes S and dP in both sweeps, 7
// products in all, as FlashAttention-2 does.
//
// Design: two kernels, as on the TPU, and every sum has one owner, so there
// are no atomics and the result is deterministic.
// - dq: one block per (bh, 64-row q tile) sweeps the k tiles up to the
//   diagonal; dS = P·(dP − delta) goes through shared memory into dS·K.
// - dk/dv: one block per (bh, 64-row k tile) sweeps the q tiles from the
//   diagonal on, computing the transposed scores Sᵀ = K·Qᵀ so that its
//   threads own key rows; Pᵀ·dO and dSᵀ·Q take turns in one shared buffer.
// Exact f32 FMAs on the CUDA cores; tensor cores and TMA come later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

size_t dq_smem_floats(int D) {
  return 4 * static_cast<size_t>(D) * kLdt + static_cast<size_t>(kB) * D +
         static_cast<size_t>(kB) * kLdt;
}

size_t dkv_smem_floats(int D) {
  return 4 * static_cast<size_t>(D) * kLdt + 2 * static_cast<size_t>(kB) * D +
         static_cast<size_t>(kB) * kLdt;
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ mask,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const float* __restrict__ delta, float* __restrict__ dq, int H,
                        int Sq, int Sk, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][kLdt]
  float* doT = qT + D * kLdt;                    // [D][kLdt]
  float* kT = doT + D * kLdt;                    // [D][kLdt]
  float* vT = kT + D * kLdt;                     // [D][kLdt]
  float* ks = vT + D * kLdt;                     // [kB][D]
  float* dsT = ks + kB * D;                      // [kB keys][kLdt]

  const int nq = (Sq + kB - 1) / kB;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * kB;
  const int tr = tile_row(), tc = tile_col();
  const size_t qoff = static_cast<size_t>(bh) * Sq, koff = static_cast<size_t>(bh) * Sk;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  const int qval = min(kB, Sq - q0);
  load_transposed(qT, q + qoff * D, q0, qval, D);
  load_transposed(doT, dout + qoff * D, q0, qval, D);
  float lse_r[4], delta_r[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    lse_r[i] = row < Sq ? lse[qoff + row] : kNegInf;
    delta_r[i] = row < Sq ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kB - 1) / kB;
  if (causal) nk = min(nk, (q0 + kB - 1) / kB + 1);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB, kval = min(kB, Sk - k0);
    __syncthreads();
    load_transposed(kT, k + koff * D, k0, kval, D);
    load_transposed(vT, v + koff * D, k0, kval, D);
    load_rows(ks, k + koff * D, k0, kval, D);
    __syncthreads();

    float p[4][4], dp[4][4];
    mm_tile(qT, kT, D, p);
    mm_tile(doT, vT, D, dp);
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tc + j;
      kok[j] = c < kval && (mrow == nullptr || mrow[k0 + c] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kok[j] && (!causal || row >= k0 + 4 * tc + j) &&
                        lse_r[i] > kNegInf / 2;
        const float pij = ok ? expf(p[i][j] * scale - lse_r[i]) : 0.f;
        p[i][j] = pij * (dp[i][j] - delta_r[i]);  // dS
      }
    }
    store_transposed(dsT, p);
    __syncthreads();
    acc_update<DPT>(dsT, ks, D, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= Sq) continue;
    float* out = dq + (qoff + row) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tc + 16 * c;
      if (d < D) out[d] = acc[i][c] * scale;
    }
  }
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Sq, int Sk, int D,
                         float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][kLdt]
  float* vT = kT + D * kLdt;                     // [D][kLdt]
  float* qT = vT + D * kLdt;                     // [D][kLdt]
  float* doT = qT + D * kLdt;                    // [D][kLdt]
  float* qs = doT + D * kLdt;                    // [kB][D]
  float* dos = qs + kB * D;                      // [kB][D]
  float* buf = dos + kB * D;                     // [kB q rows][kLdt]: Pᵀ, then dSᵀ

  const int nk = (Sk + kB - 1) / kB;
  const int bh = blockIdx.x / nk;
  const int t = blockIdx.x % nk;  // low k tiles have the most causal work
  const int k0 = t * kB, kval = min(kB, Sk - k0);
  const int tr = tile_row(), tc = tile_col();
  const size_t qoff = static_cast<size_t>(bh) * Sq, koff = static_cast<size_t>(bh) * Sk;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  load_transposed(kT, k + koff * D, k0, kval, D);
  load_transposed(vT, v + koff * D, k0, kval, D);
  bool kok[4];
  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * tr + i;
    kok[i] = c < kval && (mrow == nullptr || mrow[k0 + c] != 0);
#pragma unroll
    for (int c2 = 0; c2 < DPT; ++c2) dk_acc[i][c2] = dv_acc[i][c2] = 0.f;
  }

  const int nq = (Sq + kB - 1) / kB;
  // causal: q tile u reaches this k tile once u·kB + kB − 1 >= k0
  const int u0 = causal ? k0 / kB : 0;
  for (int u = u0; u < nq; ++u) {
    const int q0 = u * kB, qval = min(kB, Sq - q0);
    __syncthreads();
    load_transposed(qT, q + qoff * D, q0, qval, D);
    load_transposed(doT, dout + qoff * D, q0, qval, D);
    load_rows(qs, q + qoff * D, q0, qval, D);
    load_rows(dos, dout + qoff * D, q0, qval, D);
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + 4 * tc + j;
      lse_c[j] = row < Sq ? lse[qoff + row] : kNegInf;
      delta_c[j] = row < Sq ? delta[qoff + row] : 0.f;
    }
    __syncthreads();

    float p[4][4], dp[4][4];  // [key i][q row j]
    mm_tile(kT, qT, D, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * tr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kok[i] && (!causal || q0 + 4 * tc + j >= key) &&
                        lse_c[j] > kNegInf / 2;
        p[i][j] = ok ? expf(p[i][j] * scale - lse_c[j]) : 0.f;
      }
    }
    store_transposed(buf, p);
    __syncthreads();
    acc_update<DPT>(buf, dos, D, dv_acc);
    mm_tile(vT, doT, D, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = p[i][j] * (dp[i][j] - delta_c[j]);  // dSᵀ
    __syncthreads();  // every thread is done reading Pᵀ
    store_transposed(buf, dp);
    __syncthreads();
    acc_update<DPT>(buf, qs, D, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= Sk) continue;
    float* dkr = dk + (koff + key) * D;
    float* dvr = dv + (koff + key) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tc + 16 * c;
      if (d < D) {
        dkr[d] = dk_acc[i][c] * scale;
        dvr[d] = dv_acc[i][c];
      }
    }
  }
}

template <int DPT>
cudaError_t launch(const float* q, const float* k, const float* v, const int* mask,
                   const float* lse, const float* dout, const float* delta, float* dq,
                   float* dk, float* dv, int BH, int H, int Sq, int Sk, int D,
                   float scale, int causal, cudaStream_t s) {
  const size_t smem_dq = dq_smem_floats(D) * sizeof(float);
  const size_t smem_dkv = dkv_smem_floats(D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_dq));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DPT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return e;
  const long long bq = static_cast<long long>(BH) * ((Sq + kB - 1) / kB);
  const long long bk = static_cast<long long>(BH) * ((Sk + kB - 1) / kB);
  flash_bwd_dq_kernel<DPT><<<static_cast<unsigned>(bq), kThreads, smem_dq, s>>>(
      q, k, v, mask, lse, dout, delta, dq, H, Sq, Sk, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<DPT><<<static_cast<unsigned>(bk), kThreads, smem_dkv, s>>>(
      q, k, v, mask, lse, dout, delta, dk, dv, H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the larger (dk/dv) block for head dim D, or 0
// when the kernels do not take D (a multiple of 8 in [8, 128]).
extern "C" long long flash_attention_bwd_smem_bytes(int D) {
  if (flash::dims_per_thread(D) == 0) return 0;
  return static_cast<long long>(dkv_smem_floats(D) * sizeof(float));
}

// q, dout, dq (BH, Sq, D); k, v, dk, dv (BH, Sk, D); lse, delta (BH, Sq);
// mask (BH / H, Sk) int32 or null; every pointer 16-byte aligned, f32.
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* mask, const void* lse,
                                          const void* dout, const void* delta, void* dq,
                                          void* dk, void* dv, int BH, int H, int Sq,
                                          int Sk, int D, float scale, int causal,
                                          void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || Sq < 1 || Sk < 1 ||
      static_cast<long long>(BH) * (((Sq > Sk ? Sq : Sk) + flash::kB - 1) / flash::kB) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *lp = static_cast<const float*>(lse),
              *op = static_cast<const float*>(dout), *dp = static_cast<const float*>(delta);
  const int* mp = static_cast<const int*>(mask);
  float *dqp = static_cast<float*>(dq), *dkp = static_cast<float*>(dk),
        *dvp = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(n)                                                                \
  return launch<n>(qp, kp, vp, mp, lp, op, dp, dqp, dkp, dvp, BH, H, Sq, Sk, D, scale, \
                   causal, s)
  switch (flash::dims_per_thread(D)) {
    case 1: FLASH_BWD(1);
    case 2: FLASH_BWD(2);
    case 4: FLASH_BWD(4);
    case 8: FLASH_BWD(8);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD
}
