// Flash-attention forward for Hopper (sm_90a), split TF32 on the tensor cores.
//
// Replaces: recsys_tpu/kernels/pallas/attention_tpu.py::flash_attention_fwd
// (body _flash_kernel).  q (BH, Sq, D), k and v (BH, Sk, D) f32, an optional
// key-padding mask (B, Sk) int32 (nonzero = attend, batch row bh / H) and an
// optional causal mask q_index >= k_index -> out (BH, Sq, D) f32 and the
// per-row logsumexp lse (BH, Sq) f32.  A query row with no key to attend
// gives 0 and lse = -1e9; key rows past Sk are excluded and read as 0.
//
// Bound on the H100.  F32-accurate products cost three TF32 products each
// (flash_tiles.cuh), so at the SASRec shape (BH = 512, S = 512, D = 32,
// causal) the 8.6 GFLOP of the two products are 25.8 GFLOP of TF32, 0.052
// ms at 495 TFLOP/s, against 134 MB, 0.040 ms at 3.35 TB/s: operations.
// At AutoInt's S = 39, D = 8 the kernel moves 4 bytes of q, k, v and out
// for about 2·39 flops each: bytes.
//
// Design, after FlashAttention-2.  Each warp owns 16 query rows; S = Q·Kᵀ
// and O += P·V are split-TF32 mma.sync.m16n8k8 products, the online softmax
// (running max, normaliser, O) stays in the accumulator registers, rows
// reduce over quads, and P feeds P·V from registers (flash_tiles.cuh).
// - Long sequences (S > 64, or D > 64): a block of 8 warps takes 128 query
//   rows of one head at D <= 32 (4 warps, 64 rows above), heaviest causal
//   tiles first.  Tiles of 32 keys stream through a two-stage cp.async ring
//   with their mask slice; the next tile is in flight while this one
//   computes.  Each staged tile is split into big/small once, for all the
//   block's warps.  Tiles past the diagonal are skipped and only tiles that
//   cross a warp's rows are masked per element.  Q is staged and split
//   once, in shared memory.  The bound is latency: 8 warps and 3 blocks an
//   SM (74 KB of shared memory, at most 85 registers) measured fastest of
//   the 4/8-warp, 32/64-key geometries tried.
// - Short sequences (Sq, Sk <= 64 and D <= 64, AutoInt's S = 39): a block
//   takes up to 4 whole heads, copied once with cp.async and split in
//   place: the key tile is Sk rounded up to 8 and a warp's rows Sq rounded
//   up to 16, and the 4 warps share out the (head, 16-row group) items, so
//   8192 heads do not each pay a block's set-up.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <int DMAX>
struct Cfg {
  static constexpr int kWarps = DMAX <= 32 ? 8 : 4;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = 32;
  // 3 blocks an SM at D <= 32 (85 registers a thread, measured faster than
  // the 2 blocks ptxas picks when free to), 1 above
  static constexpr int kMinBlocks = DMAX <= 32 ? 3 : 1;
  static constexpr int kST = kStride(DMAX);
  static constexpr int kStage = 2 * kBK * kST + kBK;  // raw K, V and mask words
  // Q big/small, two raw stages, K and V big/small, key flags
  static constexpr int kWords = 2 * kBQ * kST + 2 * kStage + 4 * kBK * kST + kBK;
};

constexpr int kShortWarps = 4;
constexpr int kShortHeads = 4;  // heads a short block takes at most
constexpr int kShortSmem = 100 * 1024;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// One key tile of the online softmax for a warp's rows g and g+8 (global
// rows row0, row0 + 8): s holds the raw scores of the nt 8-key groups from
// key key0; kok[c] says whether tile column c may be attended.  Scales and
// masks s, turns it into P and rescales the state (o by the change of max).
// It works in base 2: c2 = scale·log2(e), the running max m in log2 units,
// so each exponential is one exp2f.
template <int NDMAX, int NT>
__device__ __forceinline__ void softmax_tile(float s[NT][4], int nt, const int* kok, int key0,
                                             int row0, bool diag, float c2, float m[2],
                                             float l[2], float o[NDMAX][4]) {
  const int t = lane_t();
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    const int c = 8 * j + 2 * t;
    const int2 ok = *reinterpret_cast<const int2*>(kok + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool keep = ((e & 1) ? ok.y : ok.x) && (!diag || row0 + 8 * h >= key0 + c + (e & 1));
      s[j][e] = keep ? s[j][e] * c2 : kNegInf;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
  }
  float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(mx[h]));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked entry stays 0 even while every key so far is masked
      s[j][e] = s[j][e] > kNegInf / 2 ? exp2f(s[j][e] - m_new[e >> 1]) : 0.f;
      sum[e >> 1] += s[j][e];
    }
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    corr[h] = exp2f(m[h] - m_new[h]);
    l[h] = l[h] * corr[h] + quad_sum(sum[h]);
    m[h] = m_new[h];
  }
#pragma unroll
  for (int dt = 0; dt < NDMAX; ++dt) {
    o[dt][0] *= corr[0];
    o[dt][1] *= corr[0];
    o[dt][2] *= corr[1];
    o[dt][3] *= corr[1];
  }
}

// out rows row0 + g (+8) of head bh and their lse (natural log) from the
// softmax state (max in log2 units).
template <int NDMAX>
__device__ __forceinline__ void write_rows(float* out, float* lse, int bh, int row0, int Sq,
                                           int D, const float m[2], const float l[2],
                                           const float o[NDMAX][4]) {
  const float f[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_rows<NDMAX>(out + static_cast<size_t>(bh) * Sq * D, row0, Sq, D, D / 8, o, f);
  if (lane_t() == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + lane_g() + 8 * h;
      if (row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : kNegInf;
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(Cfg<DMAX>::kWarps * 32, Cfg<DMAX>::kMinBlocks)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                     int D, float scale, int causal) {
  using C = Cfg<DMAX>;
  constexpr int ST = C::kST, BQ = C::kBQ, BK = C::kBK, NDMAX = DMAX / 8, NT = BK / 8;
  extern __shared__ float4 smem4[];
  uint32_t* qb = reinterpret_cast<uint32_t*>(smem4);  // [BQ][ST], raw until split
  uint32_t* qs = qb + BQ * ST;
  float* raw = reinterpret_cast<float*>(qs + BQ * ST);  // 2 x {K, V [BK][ST], mask [BK]}
  uint32_t* kb = reinterpret_cast<uint32_t*>(raw + 2 * C::kStage);
  uint32_t* ks = kb + BK * ST;
  uint32_t* vb = ks + BK * ST;
  uint32_t* vs = vb + BK * ST;
  int* kok = reinterpret_cast<int*>(vs + BK * ST);

  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * BQ;
  const int warp = threadIdx.x >> 5, nd = D / 8;
  const float* kh = k + static_cast<size_t>(bh) * Sk * D;
  const float* vh = v + static_cast<size_t>(bh) * Sk * D;
  const int* mrow = mask ? mask + static_cast<size_t>(bh / H) * Sk : nullptr;

  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles that reach the diagonal
  auto issue = [&](int tile, int stage) {
    float* st = raw + stage * C::kStage;
    const int k0 = tile * BK, kval = min(BK, Sk - k0);
    stage_rows<DMAX>(st, ST, kh, k0, BK, kval, D);
    stage_rows<DMAX>(st + BK * ST, ST, vh, k0, BK, kval, D);
    if (mrow) stage_words(st + 2 * BK * ST, mrow, k0, BK, kval);
  };
  stage_rows<DMAX>(reinterpret_cast<float*>(qb), ST, q + static_cast<size_t>(bh) * Sq * D, q0, BQ,
             min(BQ, Sq - q0), D);
  cp_async_commit();
  issue(0, 0);
  cp_async_commit();
  if (nk > 1) issue(1, 1);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[NDMAX][4];
#pragma unroll
  for (int dt = 0; dt < NDMAX; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  const int wr0 = q0 + 16 * warp;  // the warp's first row
  const int row0 = wr0 + lane_g();

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<1>();  // tile t (and Q) landed; tile t + 1 may be in flight
    __syncthreads();     // visible to all, and every warp is done with tile t - 1
    if (t == 0) split_rows<DMAX>(reinterpret_cast<float*>(qb), qb, qs, ST, BQ, D);
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
    float s[NT][4];
    product_xyt<NDMAX, NT>(qb, qs, 16 * warp, kb, ks, ST, nd, nt, s);
    softmax_tile<NDMAX, NT>(s, nt, kok, k0, row0, diag, scale * kLog2e, m, l, o);
    product_py<NDMAX, NT>(s, vb, vs, ST, nd, nt, o);
  }
  if (wr0 < Sq) write_rows<NDMAX>(out, lse, bh, wr0, Sq, D, m, l, o);
}

// Short sequences: up to kShortHeads heads a block, R = max(Sq, Sk) rounded
// up to 16 rows a head.
template <int DMAX>
__global__ void __launch_bounds__(kShortWarps * 32, 1)
    flash_fwd_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ mask,
                           float* __restrict__ out, float* __restrict__ lse, int BH, int H,
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
  int* kok = reinterpret_cast<int*>(vs + rows * ST);  // [hpb·R]

  const int h0 = blockIdx.x * hpb, nh = min(hpb, BH - h0), nd = D / 8;
  stage_heads<DMAX>(reinterpret_cast<float*>(qb), ST, q + static_cast<size_t>(h0) * Sq * D, Sq,
                    R, nh, D);
  stage_heads<DMAX>(reinterpret_cast<float*>(kb), ST, k + static_cast<size_t>(h0) * Sk * D, Sk,
                    R, nh, D);
  stage_heads<DMAX>(reinterpret_cast<float*>(vb), ST, v + static_cast<size_t>(h0) * Sk * D, Sk,
                    R, nh, D);
  cp_async_commit();
  for (int i = threadIdx.x; i < nh * R; i += blockDim.x) {  // while the copies fly
    const int hh = i / R, c = i - hh * R;
    kok[i] = c < Sk && (mask == nullptr ||
                        mask[static_cast<size_t>((h0 + hh) / H) * Sk + c] != 0);
  }
  cp_async_wait<0>();
  __syncthreads();
  split_rows<DMAX>(reinterpret_cast<float*>(qb), qb, qs, ST, nh * R, D);
  split_rows<DMAX>(reinterpret_cast<float*>(kb), kb, ks, ST, nh * R, D);
  split_rows<DMAX>(reinterpret_cast<float*>(vb), vb, vs, ST, nh * R, D);
  __syncthreads();

  const int nrg = (Sq + 15) / 16, nt = (Sk + 7) / 8;
  for (int item = threadIdx.x >> 5; item < nh * nrg; item += kShortWarps) {
    const int hh = item / nrg, r0 = 16 * (item - hh * nrg);
    const size_t hoff = static_cast<size_t>(hh) * R * ST;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[NDMAX][4], s[NT][4];
#pragma unroll
    for (int dt = 0; dt < NDMAX; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    product_xyt<NDMAX, NT>(qb + hoff, qs + hoff, r0, kb + hoff, ks + hoff, ST, nd, nt, s);
    softmax_tile<NDMAX, NT>(s, nt, kok + hh * R, 0, r0 + lane_g(), causal != 0,
                            scale * kLog2e, m, l, o);
    product_py<NDMAX, NT>(s, vb + hoff, vs + hoff, ST, nd, nt, o);
    write_rows<NDMAX>(out, lse, h0 + hh, r0, Sq, D, m, l, o);
  }
}

size_t long_smem(int dmax) {
  switch (dmax) {
    case 8: return Cfg<8>::kWords * 4;
    case 16: return Cfg<16>::kWords * 4;
    case 32: return Cfg<32>::kWords * 4;
    case 64: return Cfg<64>::kWords * 4;
    case 128: return Cfg<128>::kWords * 4;
    default: return 0;
  }
}

// Words of one head in the short kernel.
size_t short_head_words(int dmax, int R) {
  return 6 * static_cast<size_t>(R) * kStride(dmax) + R;
}

bool use_short(int dmax, int Sq, int Sk) { return dmax <= 64 && Sq <= 64 && Sk <= 64; }

template <int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v, const int* mask, float* out,
                   float* lse, int BH, int H, int Sq, int Sk, int D, float scale, int causal,
                   cudaStream_t s) {
  cudaError_t e;
  if (use_short(DMAX, Sq, Sk)) {
    const int R = round_up(Sq > Sk ? Sq : Sk, 16);
    const size_t head = short_head_words(DMAX, R) * 4;
    // up to kShortHeads heads a block while that leaves 4 blocks on each
    // of the H100's 132 SMs
    int hpb = static_cast<int>(kShortSmem / head), fill = BH / (4 * 132);
    hpb = hpb < fill ? hpb : fill;
    hpb = hpb < 1 ? 1 : hpb > kShortHeads ? kShortHeads : hpb;
    const size_t smem = head * hpb;
    e = cudaFuncSetAttribute(flash_fwd_short_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const unsigned blocks = static_cast<unsigned>((BH + hpb - 1) / hpb);
    flash_fwd_short_kernel<DMAX><<<blocks, kShortWarps * 32, smem, s>>>(
        q, k, v, mask, out, lse, BH, H, Sq, Sk, D, scale, causal, hpb, R);
    return cudaGetLastError();
  }
  using C = Cfg<DMAX>;
  const size_t smem = C::kWords * 4;
  e = cudaFuncSetAttribute(flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(BH) * ((Sq + C::kBQ - 1) / C::kBQ);
  flash_fwd_kernel<DMAX><<<static_cast<unsigned>(blocks), C::kWarps * 32, smem, s>>>(
      q, k, v, mask, out, lse, H, Sq, Sk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one long-sequence block for head dim D, or 0
// when the kernel does not take D (a multiple of 8 in [8, 128]).
extern "C" long long flash_attention_fwd_smem_bytes(int D) {
  return static_cast<long long>(long_smem(flash::dmax_for(D)));
}

// q (BH, Sq, D), k/v (BH, Sk, D), mask (BH / H, Sk) int32 or null, out
// (BH, Sq, D), lse (BH, Sq); every pointer 16-byte aligned, f32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, int BH,
                                          int H, int Sq, int Sk, int D, float scale,
                                          int causal, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || Sq < 1 || Sk < 1 ||
      static_cast<long long>(BH) * ((Sq + 63) / 64) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v);
  const int* mp = static_cast<const int*>(mask);
  float *op = static_cast<float*>(out), *lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flash::dmax_for(D)) {
    case 8: return launch<8>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 16: return launch<16>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 32: return launch<32>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 64: return launch<64>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    case 128: return launch<128>(qp, kp, vp, mp, op, lp, BH, H, Sq, Sk, D, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
