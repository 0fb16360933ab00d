// Shared by mlp_fwd.cu and mlp_bwd.cu: the tile sizes of a chain of
// matrix products over a row tile, the mma.sync / ldmatrix wrappers, the
// pre-pass that rounds and packs the weights once a call, and the cluster
// pipeline that streams the packed tiles into every CTA of a thread block
// cluster.  Included inside each file's anonymous namespace, after
// <cuda_bf16.h>, <cuda_runtime.h> and <stdint.h>.
#pragma once

constexpr int kThreads = 256;  // 8 warps (the f32 chains, pre-pass, dW)
constexpr int kBN = 128;       // output columns per pass
constexpr int kBK = 32;        // weight rows per staged tile, f32 path
constexpr int kBKb = 64;       // weight rows per packed tile, bf16 path
constexpr int kBMf32 = 16;
constexpr int kBMbf16 = 32;
constexpr int kWLd = kBN + 8;  // bf16 per packed weight row (k-major)

// relu that keeps NaN, like jnp.maximum / torch.relu
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Packed weights.  A chain is a list of steps, each a product of the row
// tile with a (K x N) weight: W_i for a forward layer, W_iᵀ for a backward
// one.  The pre-pass rounds each f32 weight to bf16 once a call and writes
// it as (kBKb x kBN) tiles, k-major with rows of kWLd (the 16-byte pad
// keeps ldmatrix rows on distinct banks), rows past K and columns past N
// zero, in the order the chain consumes them: step by step; in a step,
// chunk by chunk of up to kChunk column tiles (the accumulators a
// consumer warp holds); in a chunk, k tile by k tile, and
// for each k tile its column tiles in order.  The products read whole
// tiles (the zero rows past K meet zero columns of the activations, which
// are zero up to a multiple of 64), so no mma step waits on a predicate.  Each
// row is 272 bytes, so every tile and every slice of whole rows is 16-byte
// aligned and a multiple of 16 bytes, as bulk copies need.
// kernels/mlp.py::pack_weight_tiles is its plain version.
constexpr int kTileElems = kBKb * kWLd;
constexpr int kRowBytes = kWLd * 2;
constexpr int kMaxSteps = 16;
constexpr int kChunk = 4;  // column tiles whose products share an A fragment

struct Chain {
  int n_steps;
  int K[kMaxSteps], N[kMaxSteps];
  int tile0[kMaxSteps + 1];     // first packed tile of each step
  const float* src[kMaxSteps];  // the f32 weight each step packs
  int trans[kMaxSteps];         // 1: the step's (k, n) is src[n][k]
};

__host__ __device__ __forceinline__ int k_tiles(int K) { return (K + kBKb - 1) / kBKb; }
__host__ __device__ __forceinline__ int n_tiles(int N) { return (N + kBN - 1) / kBN; }

// (k0, n0) of packed tile `local` of a step with nk k tiles and nn column
// tiles.
__device__ __forceinline__ void tile_origin(int local, int nk, int nn, int& k0, int& n0) {
  const int c = local / (nk * kChunk), rem = local - c * nk * kChunk;
  const int nc = min(kChunk, nn - c * kChunk);
  k0 = (rem / nc) * kBKb;
  n0 = (c * kChunk + rem % nc) * kBN;
}

// Appends a step to the chain (host).
inline void add_step(Chain& c, const float* w, int K, int N, int trans) {
  const int j = c.n_steps++;
  c.K[j] = K;
  c.N[j] = N;
  c.src[j] = w;
  c.trans[j] = trans;
  c.tile0[j + 1] = c.tile0[j] + k_tiles(K) * n_tiles(N);
}

// One block a tile: read its f32 values with coalesced loads (along n for
// W, along k for Wᵀ) into shared memory, then write the tile's bf16 rows.
__global__ void __launch_bounds__(kThreads)
    pack_tiles_kernel(Chain c, __nv_bfloat16* __restrict__ out) {
  __shared__ float s[kBKb][kBN + 1];
  const int t = blockIdx.x;
  int j = 0;
  while (t >= c.tile0[j + 1]) ++j;
  const int K = c.K[j], N = c.N[j];
  int k0, n0;
  tile_origin(t - c.tile0[j], k_tiles(K), n_tiles(N), k0, n0);
  const float* __restrict__ W = c.src[j];
  if (!c.trans[j]) {
    for (int i = threadIdx.x; i < kBKb * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN, k = k0 + kk, n = n0 + cc;
      s[kk][cc] = (k < K && n < N) ? W[static_cast<size_t>(k) * N + n] : 0.f;
    }
  } else {  // W is (N, K) row-major
    for (int i = threadIdx.x; i < kBKb * kBN; i += kThreads) {
      const int cc = i / kBKb, kk = i % kBKb, k = k0 + kk, n = n0 + cc;
      s[kk][cc] = (k < K && n < N) ? W[static_cast<size_t>(n) * K + k] : 0.f;
    }
  }
  __syncthreads();
  __nv_bfloat16* tile = out + static_cast<size_t>(t) * kTileElems;
  for (int i = threadIdx.x; i < kBKb * kWLd / 2; i += kThreads) {
    const int kk = i / (kWLd / 2), cc = (i % (kWLd / 2)) * 2;
    const __nv_bfloat162 v = cc < kBN ? __floats2bfloat162_rn(s[kk][cc], s[kk][cc + 1])
                                      : __floats2bfloat162_rn(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(tile + kk * kWLd + cc) = v;
  }
}

// ---------------------------------------------------------------------------
// The cluster pipeline.  The chains run in thread block clusters of
// kCluster CTAs.  Each CTA holds a ring of `stages` tile slots with
// a full and an empty mbarrier a slot.  The producers (lane 0 of each
// warp after the consumers) walk the chain's tiles: for each, one waits
// until slot s is empty in the whole cluster, expects the tile's bytes on
// its own full barrier, and copies its 1/C of the tile's rows from global memory
// into slot s of every CTA of the cluster with one multicast bulk copy; so
// each tile leaves L2 once a cluster.  The consumer warps wait on the full barrier,
// run their products, and each releases the slot with one arrive on the
// empty barrier of every CTA of the cluster (lane r to CTA r).
//
// A parity wait only tells the phase it waits for from the one before it.
// Where the chunk's column tiles do not divide the stages (3 tiles at 4
// stages, 4 at 3), consecutive uses of a slot belong to different warps, so
// a warp could reach tile g while the copy of tile g - stages into the
// same slot (another warp's, issued earlier) is still in flight, and take
// that phase for its own.  Copies need not land in the order they were
// issued, so the producers also count the tiles they have issued in
// shared memory (release), and a consumer waits for the count to pass g
// (acquire) before it waits on the slot: tile g issued means tile g -
// stages was released by all its readers, who had seen it land.
// C, the CTAs that share each packed tile: a pair reads each tile from L2
// once for 64 rows.  L2 does not bound the chains (each tile's hand-over
// does), so on the H100 one CTA alone with a plain bulk copy is no faster
// than a pair by more than 3%, while clusters of 4 fit only 30 at once,
// under the 32 of a 4096-row call, and take two waves.
constexpr int kCluster = 2;
static_assert(kBKb % kCluster == 0, "each CTA copies whole rows of a tile");
constexpr int kConsumerWarps = 16;  // MMA warps
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kProducers = 3;                      // producer warps
constexpr int kChainThreads = kConsumers + 32 * kProducers;
constexpr int kReaders = kConsumerWarps / kChunk;  // warps that read each tile
constexpr int kWarpCols = kBN / kReaders;          // columns of a tile a warp owns
constexpr int kNI = kWarpCols / 8;                 // its n8 accumulator tiles
constexpr int kMaxStages = 8;                      // a chunk's tiles of two k rows

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; also a CTA-wide barrier.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The consumer warps only (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.  A wait of more than
// 2^35 clocks (about 17 s) can only be a deadlock: it traps, so the launch
// fails with an error instead of holding the card.
constexpr long long kWaitLimit = 1LL << 35;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p))
               : "memory");
  return v;
}

// The same bytes into `dst` and `bar` at the same offsets in every CTA of
// `mask`.
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// Shared memory of a chain kernel: the ring's slots, then two (kBMbf16 x
// ld) bf16 activation buffers.  A buffer row holds round64(Dmax) values
// and 8 of padding that no product reads or epilogue writes (it spreads
// ldmatrix rows over the banks); slot s's full and empty mbarriers live in
// the padding of row s of the first buffer, and the producers' counts of
// issued tiles in that of row `stages`, so the ring costs no byte beyond
// its slots.
struct Ring {
  __nv_bfloat16* slots;  // stages x kTileElems
  uint64_t* bars;        // full(s) = bars + s * bar_stride, empty(s) one after
  int* issued;           // [p]: producer warp p's next tile (up to 4 warps)
  int bar_stride;
  int stages;
  int g = 0;    // the chain's tiles before the consumers' current k row
  __device__ __forceinline__ uint64_t* full(int i) const { return bars + i * bar_stride; }
  __device__ __forceinline__ uint64_t* empty(int i) const { return full(i) + 1; }
};

// Carve the ring and the activation buffers out of dynamic shared memory,
// initialise the barriers and make them visible to the cluster before any
// copy.  Returns the first activation buffer.
__device__ __forceinline__ __nv_bfloat16* ring_setup(Ring& r, unsigned char* smem, int stages,
                                                     int ld) {
  r.slots = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act = r.slots + static_cast<size_t>(stages) * kTileElems;
  r.bars = reinterpret_cast<uint64_t*>(act + ld - 8);
  r.bar_stride = ld / 4;  // one buffer row, in uint64
  r.issued = reinterpret_cast<int*>(r.full(stages));
  r.stages = stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), kCluster * kReaders);
    }
    for (int p = 0; p < kProducers; ++p) r.issued[p] = p;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  return act;
}

// Until tile g has been issued (see the pipeline's note).
__device__ __forceinline__ void wait_issued(const Ring& r, int g) {
  const int* next = r.issued + g % kProducers;
  if (ld_acquire(next) > g) return;
  const long long t0 = clock64();
  while (ld_acquire(next) <= g)
    if (clock64() - t0 > kWaitLimit) __trap();
}

// The producers: lane 0 of producer warp p issues the tiles g = p (mod
// kProducers) of the chain, in order, and publishes in issued[p] the next
// one it will issue.  A tile's hand-over (the wait on its slot, the
// expected bytes, the copy's issue, the count) is a chain of dependent
// operations on shared memory; one thread walking it tile by tile bounded
// the whole chain, so three walk it side by side, each in a warp of its own
// (lanes of one warp would wait in lockstep).  Before its parity wait on
// slot s for the release of tile g - stages, a producer waits until that
// tile was issued, perhaps by another warp: then the slot's barrier has
// seen the release of tile g - 2 stages, and the parity names the right
// phase.  A producer only ever waits for tiles below its own, which every
// warp has issued or will issue without waiting on it, so there is no
// cycle.
__device__ __forceinline__ void produce(const Chain& c, const __nv_bfloat16* __restrict__ tiles,
                                        const Ring& r) {
  const int p = threadIdx.x / 32 - kConsumerWarps;
  const uint32_t rank = cluster_rank();
  const uint16_t mask = static_cast<uint16_t>((1u << kCluster) - 1);
  const int rows = kBKb / kCluster;  // this CTA's share of each tile
  const size_t off = static_cast<size_t>(rank) * rows * kWLd;
  const uint32_t bytes = rows * kRowBytes;
  const int total = c.tile0[c.n_steps];
  for (int g = p; g < total; g += kProducers) {
    const int s = g % r.stages;
    if (g >= r.stages) {
      wait_issued(r, g - r.stages);
      mbar_wait(r.empty(s), ((g / r.stages) & 1) ^ 1);
    }
    mbar_expect_tx(r.full(s), kTileElems * 2);
    const __nv_bfloat16* src = tiles + static_cast<size_t>(g) * kTileElems + off;
    __nv_bfloat16* dst = r.slots + static_cast<size_t>(s) * kTileElems + off;
    bulk_copy_multicast(dst, src, bytes, r.full(s), mask);
    st_release(r.issued + p, g + kProducers);
  }
}

// One step of the chain on the consumer warps: out (32 x N) = in (32 x K,
// bf16 in shared memory, row stride ld, columns past K zero up to a
// multiple of 64) @ the step's packed weight, accumulated in f32.  The
// columns go in chunks of kChunk tiles; warp w owns tile w / kReaders of
// the chunk and kWarpCols of its columns (16 warps: 4 a tile, 32 columns
// each), so at each k tile it waits for one slot, loads its A fragments
// once and runs 32 mma.sync on 8 independent accumulators before it
// releases the slot.  (A warp whose tile lies past a narrow step's last
// column tile idles in that chunk.)  16 warps hide the latencies of
// ldmatrix, mma.sync and the slot waits better than 8 with twice the
// accumulators, and need no more than 120 registers.  epi(row, col,
// acc) is called for every row and every column of the chunk's tiles below
// ld - 8 (the buffers' padding is the barriers').  The barrier at its start
// orders the writes of `in` (the previous step's epilogue, or the staged
// input) before its reads: the only barrier of a step.
template <class Epi>
__device__ __forceinline__ void consume_step(const __nv_bfloat16* in, int ld, int K, int N,
                                             Ring& r, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int jw = warp / kReaders, col0 = (warp % kReaders) * kWarpCols;
  const int nk = k_tiles(K), nn = n_tiles(N);
  consumer_sync();
  for (int c0 = 0; c0 < nn; c0 += kChunk) {
    const int nc = min(kChunk, nn - c0);
    const bool busy = jw < nc;
    float acc[2][kNI][4] = {};  // [m16 tile][n8 tile][fragment]
    for (int i = 0; i < nk; ++i, r.g += nc) {
      if (!busy) continue;
      // the A fragments of the tile's first half are loaded before the
      // wait, those of its second half after the first half's products
      // (all four k16 steps' at once would take 16 more registers)
      uint32_t a[2][2][4];
      const __nv_bfloat16* arow = in + (lane & 15) * ld + i * kBKb + (lane >> 4) * 8;
      auto load_a = [&](int h) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(a[q][mi], arow + mi * 16 * ld + (2 * h + q) * 16);
      };
      load_a(0);
      const int g = r.g + jw, s = g % r.stages;
      const __nv_bfloat16* wt = r.slots + static_cast<size_t>(s) * kTileElems + col0;
      wait_issued(r, g);
      mbar_wait(r.full(s), (g / r.stages) & 1);
      // the lanes leave the spin loops on their own, and ldmatrix and
      // mma.sync are .aligned: they need the whole warp back together
      __syncwarp();
#pragma unroll
      for (int h = 0; h < kBKb / 32; ++h) {
        if (h > 0) load_a(h);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int nj = 0; nj < kNI / 2; ++nj) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wt + ((2 * h + q) * 16 + (lane & 15)) * kWLd + nj * 16 +
                                     (lane >> 4) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16_16816(acc[mi][2 * nj], a[q][mi], b[0], b[1]);
              mma_bf16_16816(acc[mi][2 * nj + 1], a[q][mi], b[2], b[3]);
            }
          }
      }
      __syncwarp();
      if (lane < kCluster) mbar_arrive_cluster(r.empty(s), lane);
    }
    if (busy)  // the chunk is complete: fused epilogue
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = (c0 + jw) * kBN + col0 + ni * 8 + tig * 2 + (e & 1);
            if (n < ld - 8) epi(mi * 16 + gid + (e >> 1) * 8, n, acc[mi][ni][e]);
          }
  }
}

// Dynamic shared memory of a chain kernel with `stages` ring slots and two
// (kBMbf16 x ld) bf16 activation buffers (at 2 stages the first design's).
__host__ __forceinline__ long long chain_smem(int stages, int ld) {
  return static_cast<long long>(stages) * kTileElems * 2 + 2LL * kBMbf16 * ld * 2;
}

// The most ring stages (up to kMaxStages) that fit beside the activation
// buffers in the 227 KB a block may use; 0 if not even 2 fit (2 stages are
// the first design's shared memory, so every stack it took gets 2 or more).
__host__ __forceinline__ int chain_stages(int ld) {
  for (int s = kMaxStages; s >= 2; --s)
    if (chain_smem(s, ld) <= 227LL * 1024) return s;
  return 0;
}

__host__ __forceinline__ int dims_max(const int* dims, int n_layers) {
  int dmax = 0;
  for (int l = 0; l <= n_layers; ++l) dmax = dims[l] > dmax ? dims[l] : dmax;
  return dmax;
}

// Row stride of a bf16 activation buffer.
__host__ __forceinline__ int chain_ld(const int* dims, int n_layers) {
  return ((dims_max(dims, n_layers) + 63) / 64) * 64 + 8;
}

// Launch a chain kernel in clusters of kCluster CTAs, the grid padded to a
// multiple of it (a CTA past the batch takes part in every copy and
// barrier and writes nothing).
template <class... KArgs, class... Args>
cudaError_t launch_chain(void (*kernel)(KArgs...), int B, long long smem, cudaStream_t s,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (B + kBMbf16 - 1) / kBMbf16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + kCluster - 1) / kCluster * kCluster);
  cfg.blockDim = dim3(kChainThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// How many clusters of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <class... KArgs>
int max_active_clusters(void (*kernel)(KArgs...), long long smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kChainThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
