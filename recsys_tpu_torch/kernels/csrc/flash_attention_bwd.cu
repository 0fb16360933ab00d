// Flash-attention backward for Hopper (sm_90a), split TF32 on the tensor cores.
//
// Replaces: recsys_tpu/kernels/pallas/attention_tpu.py::flash_attention_bwd
// (bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel).  From q, k, v,
// the mask and causal flag of the forward, its lse (BH, Sq), the output
// cotangent dO (BH, Sq, D) and delta = rowsum(dO·O) (BH, Sq), all f32:
// dq (BH, Sq, D), dk and dv (BH, Sk, D), f32.  P is recomputed from lse
// tile by tile with the forward's masking, so memory stays O(S); a row with
// lse = -1e9 (no key to attend) has P = 0 and adds nothing.
//
// Bound on the H100.  Five products of the forward's size (S, dP, dV, dQ,
// dK), 10·S(S+1)/2·D flops per causal head, three TF32 products each in the
// split (flash_tiles.cuh): 64 GFLOP of TF32 at the SASRec shape (BH = 512,
// S = 512, D = 32), 0.130 ms at 495 TFLOP/s: operations.  At AutoInt's
// S = 39, D = 8: bytes.  The two long kernels recompute S and dP in both
// sweeps, 7 products in all, as FlashAttention-2 does.
//
// Design: every sum has one owner, so there are no atomics and the result
// is deterministic.  Warps own 16 rows; the products are split-TF32
// mma.sync.m16n8k8 and P, dS feed the next product from registers.
// - Long sequences (S > 64, or D > 64), two kernels as on the TPU, each a
//   block of 8 warps over 128 rows at D <= 32 (fewer above):
//   dq: the block's query rows (Q, dO staged and split once) sweep the
//   32-key tiles up to the diagonal through a two-stage cp.async ring of
//   K, V and the mask slice; dS = P·(dP − delta) feeds dS·K.  dk/dv: the
//   block's key rows (K, V staged and split once) sweep the 32-row query
//   tiles from the diagonal on through a ring of Q, dO, lse and delta; the
//   transposed scores Sᵀ = K·Qᵀ give each warp its key rows, and Pᵀ·dO and
//   dSᵀ·Q read the same staged Q/dO tiles.  One fused kernel would need a
//   dq reduction across blocks; the two sweeps keep one owner per sum.
// - Short sequences (Sq, Sk <= 64 and D <= 64, AutoInt's S = 39): one
//   kernel.  A block copies up to 2 whole heads once with cp.async and
//   splits them in place; its warps take the (head, 16 query rows) items
//   for dq and then the (head, 16 key rows) items for dk and dv.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <int DMAX>
struct DqCfg {
  static constexpr int kWarps = DMAX == 128 ? 2 : DMAX <= 32 ? 8 : 4;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = 32;
  static constexpr int kST = kStride(DMAX);
  static constexpr int kStage = 2 * kBK * kST + kBK;  // raw K, V and mask words
  // Q, dO big/small, two raw stages, K, V big/small, key flags
  static constexpr int kWords = 4 * kBQ * kST + 2 * kStage + 4 * kBK * kST + kBK;
};

template <int DMAX>
struct DkvCfg {
  static constexpr int kWarps = DMAX <= 32 ? 8 : 4;
  static constexpr int kBK = 16 * kWarps;
  static constexpr int kBQ = DMAX <= 64 ? 32 : 16;
  static constexpr int kST = kStride(DMAX);
  static constexpr int kStage = 2 * kBQ * kST + 2 * kBQ;  // raw Q, dO, lse, delta words
  // K, V big/small, two raw stages, Q, dO big/small, lse, delta
  static constexpr int kWords = 4 * kBK * kST + 2 * kStage + 4 * kBQ * kST + 2 * kBQ;
};

constexpr int kShortWarps = 4;
constexpr int kShortHeads = 2;  // heads a short block takes at most
constexpr int kShortSmem = 100 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dq orientation: s (scores of rows row0, row0 + 8 against the nt key
// groups from key0) becomes dS = P·(dP − delta) in place.  P = exp2(s·c2 −
// lse2), c2 = scale·log2(e) and lse2 = lse·log2(e), one exp2f an entry.
template <int NT>
__device__ __forceinline__ void ds_rows(float s[NT][4], const float dp[NT][4], int nt,
                                        const int* kok, int key0, int row0, bool diag,
                                        const float lse_r[2], const float delta_r[2],
                                        float c2) {
  const int t = lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    const int c = 8 * j + 2 * t;
    const int2 ok = *reinterpret_cast<const int2*>(kok + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool keep = ((e & 1) ? ok.y : ok.x) && lse_r[h] > kNegInf / 2 &&
                        (!diag || row0 + 8 * h >= key0 + c + (e & 1));
      const float p = keep ? exp2f(fmaf(s[j][e], c2, -lse_r[h])) : 0.f;
      s[j][e] = p * (dp[j][e] - delta_r[h]);
    }
  }
}

// dk/dv orientation: s (Sᵀ of key rows key_row0, key_row0 + 8 against the
// nt query groups from q0) becomes Pᵀ and dp becomes dSᵀ; lse_c and
// delta_c are the staged per-query values of the tile (lse in log2 units).
template <int NT>
__device__ __forceinline__ void p_ds_cols(float s[NT][4], float dp[NT][4], int nt,
                                          const float* lse_c, const float* delta_c, int q0,
                                          int key_row0, bool diag, const bool kok_r[2],
                                          float c2) {
  const int t = lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    const int c = 8 * j + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(lse_c + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta_c + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float lv = (e & 1) ? ls.y : ls.x, dv = (e & 1) ? dl.y : dl.x;
      const bool keep = kok_r[h] && lv > kNegInf / 2 &&
                        (!diag || q0 + c + (e & 1) >= key_row0 + 8 * h);
      const float p = keep ? exp2f(fmaf(s[j][e], c2, -lv)) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dv);
    }
  }
}

template <int NDMAX>
__device__ __forceinline__ void zero_acc(float o[NDMAX][4]) {
#pragma unroll
  for (int dt = 0; dt < NDMAX; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
}

template <int DMAX>
__global__ void __launch_bounds__(DqCfg<DMAX>::kWarps * 32, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ mask,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const float* __restrict__ delta, float* __restrict__ dq, int H,
                        int Sq, int Sk, int D, float scale, int causal) {
  using C = DqCfg<DMAX>;
  constexpr int ST = C::kST, BQ = C::kBQ, BK = C::kBK, NDMAX = DMAX / 8, NT = BK / 8;
  extern __shared__ float4 smem4[];
  uint32_t* qb = reinterpret_cast<uint32_t*>(smem4);  // [BQ][ST] each, raw until split
  uint32_t* qs = qb + BQ * ST;
  uint32_t* db = qs + BQ * ST;
  uint32_t* ds = db + BQ * ST;
  float* raw = reinterpret_cast<float*>(ds + BQ * ST);  // 2 x {K, V [BK][ST], mask [BK]}
  uint32_t* kb = reinterpret_cast<uint32_t*>(raw + 2 * C::kStage);
  uint32_t* ks = kb + BK * ST;
  uint32_t* vb = ks + BK * ST;
  uint32_t* vs = vb + BK * ST;
  int* kok = reinterpret_cast<int*>(vs + BK * ST);

  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * BQ;
  const int warp = threadIdx.x >> 5, nd = D / 8;
  const size_t qoff = static_cast<size_t>(bh) * Sq, koff = static_cast<size_t>(bh) * Sk;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  auto issue = [&](int tile, int stage) {
    float* st = raw + stage * C::kStage;
    const int k0 = tile * BK, kval = min(BK, Sk - k0);
    stage_rows<DMAX>(st, ST, k + koff * D, k0, BK, kval, D);
    stage_rows<DMAX>(st + BK * ST, ST, v + koff * D, k0, BK, kval, D);
    if (mrow) stage_words(st + 2 * BK * ST, mrow, k0, BK, kval);
  };
  const int qval = min(BQ, Sq - q0);
  stage_rows<DMAX>(reinterpret_cast<float*>(qb), ST, q + qoff * D, q0, BQ, qval, D);
  stage_rows<DMAX>(reinterpret_cast<float*>(db), ST, dout + qoff * D, q0, BQ, qval, D);
  cp_async_commit();
  issue(0, 0);
  cp_async_commit();
  if (nk > 1) issue(1, 1);
  cp_async_commit();

  const int wr0 = q0 + 16 * warp, row0 = wr0 + lane_g();
  float lse_r[2], delta_r[2], acc[NDMAX][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse_r[h] = row < Sq ? lse[qoff + row] * kLog2e : kNegInf;
    delta_r[h] = row < Sq ? delta[qoff + row] : 0.f;
  }
  zero_acc<NDMAX>(acc);

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      split_rows<DMAX>(reinterpret_cast<float*>(qb), qb, qs, ST, BQ, D);
      split_rows<DMAX>(reinterpret_cast<float*>(db), db, ds, ST, BQ, D);
    }
    const float* st = raw + (t & 1) * C::kStage;
    const int k0 = t * BK, kval = min(BK, Sk - k0);
    split_rows<DMAX>(st, kb, ks, ST, BK, D);
    split_rows<DMAX>(st + BK * ST, vb, vs, ST, BK, D);
    const int* mraw = reinterpret_cast<const int*>(st + 2 * BK * ST);
    for (int i = threadIdx.x; i < BK; i += blockDim.x)
      kok[i] = i < kval && (mrow == nullptr || mraw[i] != 0);
    __syncthreads();
    if (t + 2 < nk) issue(t + 2, t & 1);
    cp_async_commit();
    if (wr0 >= Sq || (causal && k0 > wr0 + 15)) continue;
    const bool diag = causal && k0 + BK - 1 > wr0;
    const int nt = (kval + 7) / 8;
    float s[NT][4], dp[NT][4];
    product_xyt<NDMAX, NT>(qb, qs, 16 * warp, kb, ks, ST, nd, nt, s);
    product_xyt<NDMAX, NT>(db, ds, 16 * warp, vb, vs, ST, nd, nt, dp);
    ds_rows<NT>(s, dp, nt, kok, k0, row0, diag, lse_r, delta_r, scale * kLog2e);
    product_py<NDMAX, NT>(s, kb, ks, ST, nd, nt, acc);
  }
  const float f[2] = {scale, scale};
  if (wr0 < Sq) store_rows<NDMAX>(dq + qoff * D, wr0, Sq, D, nd, acc, f);
}

template <int DMAX>
__global__ void __launch_bounds__(DkvCfg<DMAX>::kWarps * 32, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Sq, int Sk, int D, float scale,
                         int causal) {
  using C = DkvCfg<DMAX>;
  constexpr int ST = C::kST, BK = C::kBK, BQ = C::kBQ, NDMAX = DMAX / 8, NT = BQ / 8;
  extern __shared__ float4 smem4[];
  uint32_t* kb = reinterpret_cast<uint32_t*>(smem4);  // [BK][ST] each, raw until split
  uint32_t* ks = kb + BK * ST;
  uint32_t* vb = ks + BK * ST;
  uint32_t* vs = vb + BK * ST;
  float* raw = reinterpret_cast<float*>(vs + BK * ST);  // 2 x {Q, dO [BQ][ST], lse, delta [BQ]}
  uint32_t* qb = reinterpret_cast<uint32_t*>(raw + 2 * C::kStage);
  uint32_t* qs = qb + BQ * ST;
  uint32_t* db = qs + BQ * ST;
  uint32_t* ds = db + BQ * ST;
  float* lse_c = reinterpret_cast<float*>(ds + BQ * ST);
  float* delta_c = lse_c + BQ;

  const int nkt = (Sk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt;
  const int k0 = static_cast<int>(blockIdx.x % nkt) * BK;  // low k tiles: most causal work
  const int warp = threadIdx.x >> 5, nd = D / 8;
  const size_t qoff = static_cast<size_t>(bh) * Sq, koff = static_cast<size_t>(bh) * Sk;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  const int nq = (Sq + BQ - 1) / BQ;
  const int u0 = causal ? min(k0 / BQ, nq) : 0;  // the first query tile to reach k0
  const int nu = nq - u0;
  auto issue = [&](int u, int stage) {
    float* st = raw + stage * C::kStage;
    const int q0 = u * BQ, qval = min(BQ, Sq - q0);
    stage_rows<DMAX>(st, ST, q + qoff * D, q0, BQ, qval, D);
    stage_rows<DMAX>(st + BQ * ST, ST, dout + qoff * D, q0, BQ, qval, D);
    stage_words(st + 2 * BQ * ST, lse + qoff, q0, BQ, qval);
    stage_words(st + 2 * BQ * ST + BQ, delta + qoff, q0, BQ, qval);
  };
  const int kval = min(BK, Sk - k0);
  stage_rows<DMAX>(reinterpret_cast<float*>(kb), ST, k + koff * D, k0, BK, kval, D);
  stage_rows<DMAX>(reinterpret_cast<float*>(vb), ST, v + koff * D, k0, BK, kval, D);
  cp_async_commit();
  if (nu > 0) issue(u0, 0);
  cp_async_commit();
  if (nu > 1) issue(u0 + 1, 1);
  cp_async_commit();

  const int kr0 = k0 + 16 * warp, key_row0 = kr0 + lane_g();
  bool kok_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_row0 + 8 * h;
    kok_r[h] = key < Sk && (mrow == nullptr || mrow[key] != 0);
  }
  float dk_acc[NDMAX][4], dv_acc[NDMAX][4];
  zero_acc<NDMAX>(dk_acc);
  zero_acc<NDMAX>(dv_acc);

  for (int i = 0; i < nu; ++i) {
    const int q0 = (u0 + i) * BQ, qval = min(BQ, Sq - q0);
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
      split_rows<DMAX>(reinterpret_cast<float*>(kb), kb, ks, ST, BK, D);
      split_rows<DMAX>(reinterpret_cast<float*>(vb), vb, vs, ST, BK, D);
    }
    const float* st = raw + (i & 1) * C::kStage;
    split_rows<DMAX>(st, qb, qs, ST, BQ, D);
    split_rows<DMAX>(st + BQ * ST, db, ds, ST, BQ, D);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      lse_c[r] = r < qval ? st[2 * BQ * ST + r] * kLog2e : kNegInf;
      delta_c[r] = r < qval ? st[2 * BQ * ST + BQ + r] : 0.f;
    }
    __syncthreads();
    if (i + 2 < nu) issue(u0 + i + 2, i & 1);
    cp_async_commit();
    if (kr0 >= Sk || (causal && q0 + BQ - 1 < kr0)) continue;
    const bool diag = causal && q0 < kr0 + 15;
    const int nt = (qval + 7) / 8;
    float s[NT][4], dp[NT][4];
    product_xyt<NDMAX, NT>(kb, ks, 16 * warp, qb, qs, ST, nd, nt, s);
    product_xyt<NDMAX, NT>(vb, vs, 16 * warp, db, ds, ST, nd, nt, dp);
    p_ds_cols<NT>(s, dp, nt, lse_c, delta_c, q0, key_row0, diag, kok_r, scale * kLog2e);
    product_py<NDMAX, NT>(s, db, ds, ST, nd, nt, dv_acc);
    product_py<NDMAX, NT>(dp, qb, qs, ST, nd, nt, dk_acc);
  }
  if (kr0 < Sk) {
    const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
    store_rows<NDMAX>(dk + koff * D, kr0, Sk, D, nd, dk_acc, fk);
    store_rows<NDMAX>(dv + koff * D, kr0, Sk, D, nd, dv_acc, fv);
  }
}

// Short sequences: up to kShortHeads heads a block, R = max(Sq, Sk) rounded
// up to 16 rows a head; dq, dk and dv in one launch.
template <int DMAX>
__global__ void __launch_bounds__(kShortWarps * 32, 1)
    flash_bwd_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ mask,
                           const float* __restrict__ lse, const float* __restrict__ dout,
                           const float* __restrict__ delta, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int BH, int H,
                           int Sq, int Sk, int D, float scale, int causal, int hpb, int R) {
  constexpr int ST = kStride(DMAX), NDMAX = DMAX / 8, NT = 8;
  extern __shared__ float4 smem4[];
  const int rows = hpb * R;
  uint32_t* qb = reinterpret_cast<uint32_t*>(smem4);  // each [hpb·R][ST]
  uint32_t* qs = qb + rows * ST;
  uint32_t* kb = qs + rows * ST;
  uint32_t* ks = kb + rows * ST;
  uint32_t* vb = ks + rows * ST;
  uint32_t* vs = vb + rows * ST;
  uint32_t* db = vs + rows * ST;
  uint32_t* ds = db + rows * ST;
  int* kok = reinterpret_cast<int*>(ds + rows * ST);  // each [hpb·R]
  float* lse_s = reinterpret_cast<float*>(kok + rows);
  float* delta_s = lse_s + rows;

  const int h0 = blockIdx.x * hpb, nh = min(hpb, BH - h0), nd = D / 8;
  const size_t q_at = static_cast<size_t>(h0) * Sq, k_at = static_cast<size_t>(h0) * Sk;
  stage_heads<DMAX>(reinterpret_cast<float*>(qb), ST, q + q_at * D, Sq, R, nh, D);
  stage_heads<DMAX>(reinterpret_cast<float*>(db), ST, dout + q_at * D, Sq, R, nh, D);
  stage_heads<DMAX>(reinterpret_cast<float*>(kb), ST, k + k_at * D, Sk, R, nh, D);
  stage_heads<DMAX>(reinterpret_cast<float*>(vb), ST, v + k_at * D, Sk, R, nh, D);
  cp_async_commit();
  for (int i = threadIdx.x; i < nh * R; i += blockDim.x) {  // while the copies fly
    const int hh = i / R, c = i - hh * R;
    kok[i] = c < Sk && (mask == nullptr ||
                        mask[static_cast<size_t>((h0 + hh) / H) * Sk + c] != 0);
    lse_s[i] = c < Sq ? lse[q_at + static_cast<size_t>(hh) * Sq + c] * kLog2e : kNegInf;
    delta_s[i] = c < Sq ? delta[q_at + static_cast<size_t>(hh) * Sq + c] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  split_rows<DMAX>(reinterpret_cast<float*>(qb), qb, qs, ST, nh * R, D);
  split_rows<DMAX>(reinterpret_cast<float*>(db), db, ds, ST, nh * R, D);
  split_rows<DMAX>(reinterpret_cast<float*>(kb), kb, ks, ST, nh * R, D);
  split_rows<DMAX>(reinterpret_cast<float*>(vb), vb, vs, ST, nh * R, D);
  __syncthreads();

  const int nrq = (Sq + 15) / 16, nrk = (Sk + 15) / 16;
  const int ntk = (Sk + 7) / 8, ntq = (Sq + 7) / 8;
  const int g = lane_g();
  for (int item = threadIdx.x >> 5; item < nh * (nrq + nrk); item += kShortWarps) {
    float s[NT][4], dp[NT][4];
    if (item < nh * nrq) {  // dq of 16 query rows
      const int hh = item / nrq, r0 = 16 * (item - hh * nrq);
      const size_t hoff = static_cast<size_t>(hh) * R * ST;
      const float lse_r[2] = {lse_s[hh * R + r0 + g], lse_s[hh * R + r0 + g + 8]};
      const float delta_r[2] = {delta_s[hh * R + r0 + g], delta_s[hh * R + r0 + g + 8]};
      float acc[NDMAX][4];
      zero_acc<NDMAX>(acc);
      product_xyt<NDMAX, NT>(qb + hoff, qs + hoff, r0, kb + hoff, ks + hoff, ST, nd, ntk, s);
      product_xyt<NDMAX, NT>(db + hoff, ds + hoff, r0, vb + hoff, vs + hoff, ST, nd, ntk, dp);
      ds_rows<NT>(s, dp, ntk, kok + hh * R, 0, r0 + g, causal != 0, lse_r, delta_r,
                  scale * kLog2e);
      product_py<NDMAX, NT>(s, kb + hoff, ks + hoff, ST, nd, ntk, acc);
      const float f[2] = {scale, scale};
      store_rows<NDMAX>(dq + (q_at + static_cast<size_t>(hh) * Sq) * D, r0, Sq, D, nd, acc, f);
    } else {  // dk and dv of 16 key rows
      const int it = item - nh * nrq, hh = it / nrk, kr0 = 16 * (it - hh * nrk);
      const size_t hoff = static_cast<size_t>(hh) * R * ST;
      const bool kok_r[2] = {kok[hh * R + kr0 + g] != 0, kok[hh * R + kr0 + g + 8] != 0};
      float dk_acc[NDMAX][4], dv_acc[NDMAX][4];
      zero_acc<NDMAX>(dk_acc);
      zero_acc<NDMAX>(dv_acc);
      product_xyt<NDMAX, NT>(kb + hoff, ks + hoff, kr0, qb + hoff, qs + hoff, ST, nd, ntq, s);
      product_xyt<NDMAX, NT>(vb + hoff, vs + hoff, kr0, db + hoff, ds + hoff, ST, nd, ntq, dp);
      p_ds_cols<NT>(s, dp, ntq, lse_s + hh * R, delta_s + hh * R, 0, kr0 + g, causal != 0,
                    kok_r, scale * kLog2e);
      product_py<NDMAX, NT>(s, db + hoff, ds + hoff, ST, nd, ntq, dv_acc);
      product_py<NDMAX, NT>(dp, qb + hoff, qs + hoff, ST, nd, ntq, dk_acc);
      const size_t kbase = (k_at + static_cast<size_t>(hh) * Sk) * D;
      const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
      store_rows<NDMAX>(dk + kbase, kr0, Sk, D, nd, dk_acc, fk);
      store_rows<NDMAX>(dv + kbase, kr0, Sk, D, nd, dv_acc, fv);
    }
  }
}

size_t long_smem(int dmax) {
  switch (dmax) {
#define FLASH_BWD_SMEM(n) \
  case n:                 \
    return 4 * static_cast<size_t>(DqCfg<n>::kWords > DkvCfg<n>::kWords ? DqCfg<n>::kWords \
                                                                          : DkvCfg<n>::kWords);
    FLASH_BWD_SMEM(8)
    FLASH_BWD_SMEM(16)
    FLASH_BWD_SMEM(32)
    FLASH_BWD_SMEM(64)
    FLASH_BWD_SMEM(128)
#undef FLASH_BWD_SMEM
    default: return 0;
  }
}

bool use_short(int dmax, int Sq, int Sk) { return dmax <= 64 && Sq <= 64 && Sk <= 64; }

template <int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v, const int* mask,
                   const float* lse, const float* dout, const float* delta, float* dq,
                   float* dk, float* dv, int BH, int H, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t s) {
  cudaError_t e;
  if (use_short(DMAX, Sq, Sk)) {
    const int R = round_up(Sq > Sk ? Sq : Sk, 16);
    const size_t head = (8 * static_cast<size_t>(R) * kStride(DMAX) + 3 * R) * 4;
    // up to kShortHeads heads a block while that leaves 4 blocks on each
    // of the H100's 132 SMs
    int hpb = static_cast<int>(kShortSmem / head), fill = BH / (4 * 132);
    hpb = hpb < fill ? hpb : fill;
    hpb = hpb < 1 ? 1 : hpb > kShortHeads ? kShortHeads : hpb;
    const size_t smem = head * hpb;
    e = cudaFuncSetAttribute(flash_bwd_short_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const unsigned blocks = static_cast<unsigned>((BH + hpb - 1) / hpb);
    flash_bwd_short_kernel<DMAX><<<blocks, kShortWarps * 32, smem, s>>>(
        q, k, v, mask, lse, dout, delta, dq, dk, dv, BH, H, Sq, Sk, D, scale, causal, hpb, R);
    return cudaGetLastError();
  }
  using Q = DqCfg<DMAX>;
  using K = DkvCfg<DMAX>;
  const size_t smem_dq = Q::kWords * 4, smem_dkv = K::kWords * 4;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dq));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return e;
  const long long bq = static_cast<long long>(BH) * ((Sq + Q::kBQ - 1) / Q::kBQ);
  const long long bk = static_cast<long long>(BH) * ((Sk + K::kBK - 1) / K::kBK);
  flash_bwd_dq_kernel<DMAX><<<static_cast<unsigned>(bq), Q::kWarps * 32, smem_dq, s>>>(
      q, k, v, mask, lse, dout, delta, dq, H, Sq, Sk, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<DMAX><<<static_cast<unsigned>(bk), K::kWarps * 32, smem_dkv, s>>>(
      q, k, v, mask, lse, dout, delta, dk, dv, H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the larger long-sequence block for head dim D,
// or 0 when the kernels do not take D (a multiple of 8 in [8, 128]).
extern "C" long long flash_attention_bwd_smem_bytes(int D) {
  return static_cast<long long>(long_smem(flash::dmax_for(D)));
}

// q, dout, dq (BH, Sq, D); k, v, dk, dv (BH, Sk, D); lse, delta (BH, Sq);
// mask (BH / H, Sk) int32 or null; every pointer 16-byte aligned, f32.
// Launches the kernels on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* mask, const void* lse,
                                          const void* dout, const void* delta, void* dq,
                                          void* dk, void* dv, int BH, int H, int Sq, int Sk,
                                          int D, float scale, int causal, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || Sq < 1 || Sk < 1 ||
      static_cast<long long>(BH) * (((Sq > Sk ? Sq : Sk) + 31) / 32) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *lp = static_cast<const float*>(lse),
              *op = static_cast<const float*>(dout), *dp = static_cast<const float*>(delta);
  const int* mp = static_cast<const int*>(mask);
  float *dqp = static_cast<float*>(dq), *dkp = static_cast<float*>(dk),
        *dvp = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(n)                                                                 \
  case n:                                                                            \
    return launch<n>(qp, kp, vp, mp, lp, op, dp, dqp, dkp, dvp, BH, H, Sq, Sk, D, scale, \
                     causal, s)
  switch (flash::dmax_for(D)) {
    FLASH_BWD(8);
    FLASH_BWD(16);
    FLASH_BWD(32);
    FLASH_BWD(64);
    FLASH_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD
}
