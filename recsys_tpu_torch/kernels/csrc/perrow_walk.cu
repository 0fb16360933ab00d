// Serial per-row walk, spread over the SMs by column slices, for Hopper
// (sm_90a).
//
// Replaces: recsys_tpu/tools/stream_probe.py::_perrow_kernel, called by
// probe_perrow_vmem.  x (n, W) f32 -> out (1, W) f32, the column sums taken
// in serial row order: acc = 0, then acc += x[i] for i = 0 .. n-1.  The
// probe measures what a program pays per row when it walks rows one at a
// time out of on-chip memory, the access pattern of an in-kernel per-row
// gather or scatter.
//
// Bound on the H100: bytes, 4.19 MB at the probe's 8192 x 128, 1.25 us at
// 3.35 TB/s.  A serial walk cannot reach it: each column is a chain of n
// dependent f32 adds, about 4 cycles each, 16.5 us at 8192 rows and
// 1980 MHz.  That chain is this kernel's floor; a tree sum (x.sum(0)) is
// faster and gives other bits.
//
// Design: the TPU kernel is one program, which on a chip with one
// TensorCore is the whole chip; here the whole chip is 132 SMs.  The grid
// runs over column slices: block b owns 4 adjacent columns (32 blocks at
// W = 128), and in each block one thread walks one column in row order
// with __fadd_rn, so every column keeps the serial order and the output is
// bit-equal to the serial plain version.  A second warp stages the slice
// into shared memory: a ring of `stages` chunks of `chunk_rows` rows,
// filled with 4-byte cp.async copies that transpose the slice, so each
// column's rows lie side by side, and handed over through two mbarriers a
// stage: `full`, on which every staging lane's copies arrive when they
// land, and `empty`, on which every walker arrives when it is done with the
// chunk.  The walk starts after the first chunk's round trip and the
// staging runs ahead of it by the rest of the ring.  Each walker reads its
// column 4 rows to a 16-byte load and loads 64 rows into registers while
// it adds the 64 before them, across chunk boundaries too, so its adds
// wait on little but the add before.  The wrapper's plan
// (dispatch.perrow_plan) chooses the chunk rows and the stages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 4;    // columns a block
constexpr int kGroup = 64;  // rows a walker loads ahead of its adds

// Floats a column takes in a stage: its rows, rounded up to whole 16-byte
// loads, and 4 more so the 4 columns' loads fall in different banks.
__host__ __device__ constexpr int pitch_of(int chunk_rows) {
  return (chunk_rows + 3) / 4 * 4 + 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// The arrival of this thread's earlier cp.async copies, once they land;
// counts as one of the barrier's expected arrivals (.noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A walker's view of the ring: the address of its column in the next rows,
// entering the next chunk when the current one is used up (the chunk read
// so far goes back to the staging warp, and the walk waits for the next).
struct Reader {
  uint64_t* full;
  uint64_t* empty;
  const float* col;  // the walker's column in stage 0
  int stage_floats, chunk_rows, stages;
  int s = -1, phase = 0, left = 0;
  const float* src = nullptr;

  // The next `rows` rows, which lie in one chunk.
  __device__ __forceinline__ const float* next(int rows) {
    if (left == 0) {
      if (s >= 0) mbar_arrive(empty + s);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
      mbar_wait(full + s, phase);
      src = col + s * stage_floats;
      left = chunk_rows;
    }
    const float* const p = src;
    src += rows;
    left -= rows;
    return p;
  }
};

__device__ __forceinline__ void load_group(float (&dst)[kGroup], const float* p) {
#pragma unroll
  for (int u = 0; u < kGroup; u += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + u);
    dst[u] = q.x;
    dst[u + 1] = q.y;
    dst[u + 2] = q.z;
    dst[u + 3] = q.w;
  }
}

__device__ __forceinline__ float add_group(float acc, const float (&src)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) acc = __fadd_rn(acc, src[u]);
  return acc;
}

// Adds the group in `src` while the next group loads into `dst`, a load
// beside every four adds, so the loads issue in the adds' shadow.
__device__ __forceinline__ float add_load_group(float acc, const float (&src)[kGroup],
                                                float (&dst)[kGroup], const float* p) {
#pragma unroll
  for (int u = 0; u < kGroup; u += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + u);
    dst[u] = q.x;
    dst[u + 1] = q.y;
    dst[u + 2] = q.z;
    dst[u + 3] = q.w;
    acc = __fadd_rn(acc, src[u]);
    acc = __fadd_rn(acc, src[u + 1]);
    acc = __fadd_rn(acc, src[u + 2]);
    acc = __fadd_rn(acc, src[u + 3]);
  }
  return acc;
}

// Block b: columns [b·kCols, b·kCols + mine) of x; threads 0 .. mine-1
// walk, warp 1 stages.  Shared memory: full[stages], empty[stages], then
// the ring: stages × kCols columns of pitch_of(chunk_rows) floats.
__global__ void __launch_bounds__(2 * kWarp)
    perrow_walk_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int W,
                       int chunk_rows, int stages) {
  extern __shared__ uint64_t smem[];
  uint64_t* const full = smem;
  uint64_t* const empty = smem + stages;
  float* const ring = reinterpret_cast<float*>(smem + 2 * stages);
  const int c0 = blockIdx.x * kCols;
  const int mine = W - c0 < kCols ? W - c0 : kCols;
  const int chunks = (n + chunk_rows - 1) / chunk_rows;
  const int pitch = pitch_of(chunk_rows);
  const int stage_floats = pitch * kCols;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kWarp);
      mbar_init(empty + s, mine);
    }
  }
  __syncthreads();

  if (threadIdx.x >= kWarp) {  // the staging warp: 8 rows of 4 columns a copy
    const int lane = threadIdx.x - kWarp, c = lane % kCols;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages;
      if (k >= stages) mbar_wait(empty + s, ((k / stages) - 1) & 1);
      float* const buf = ring + s * stage_floats + c * pitch;
      const long long r0 = static_cast<long long>(k) * chunk_rows;
      const int rows = n - r0 < chunk_rows ? static_cast<int>(n - r0) : chunk_rows;
      if (c < mine) {
        const float* const src = x + r0 * W + c0 + c;
        for (int r = lane / kCols; r < rows; r += kWarp / kCols)
          cp_async4(buf + r, src + r * static_cast<long long>(W));
      }
      mbar_arrive_on_copies(full + s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int c = threadIdx.x;
  if (c >= mine) return;
  Reader rd{full, empty, ring + c * pitch, stage_floats, chunk_rows, stages};
  float a[kGroup], b[kGroup], acc = 0.f;
  const int groups = n / kGroup;
  if (groups > 0) {
    load_group(a, rd.next(kGroup));
    int g = 1;
    for (; g + 1 < groups; g += 2) {  // groups g and g + 1 exist
      acc = add_load_group(acc, a, b, rd.next(kGroup));
      acc = add_load_group(acc, b, a, rd.next(kGroup));
    }
    if (g < groups) {
      acc = add_load_group(acc, a, b, rd.next(kGroup));
      acc = add_group(acc, b);
    } else {
      acc = add_group(acc, a);
    }
  }
  for (int r = groups * kGroup; r < n; ++r) acc = __fadd_rn(acc, *rd.next(1));
  out[c0 + c] = acc;
}

// The floor the walk is held to, measured: one thread adds n values (a
// multiple of kGroup) in one dependent __fadd_rn chain, as a walker does,
// and writes the SM cycles the chain took (clock64) to *cycles.
__global__ void add_chain_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 long long* __restrict__ cycles, int n) {
  float v[kGroup], acc = 0.f;
  load_group(v, in);
  const long long t0 = clock64();
  for (int r = 0; r < n; r += kGroup) acc = add_group(acc, v);
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

}  // namespace

// x (n, W) f32 -> out (W) f32, the serial column sums; 1 <= W <= 1024, x
// 4-byte aligned.  The plan (dispatch.perrow_plan) chooses a ring of
// `stages` chunks of `chunk_rows` rows (a multiple of 64, or all n rows);
// the grid of kCols-column blocks and the shared bytes follow from it here.
// Launches on `stream` and returns cudaGetLastError(); a plan beyond the
// kernel or the card's shared memory is cudaErrorInvalidValue.
extern "C" int perrow_walk_launch(const void* x, void* out, int n, int W, int chunk_rows,
                                  int stages, void* stream) {
  const long long smem = 16ll * stages + 4ll * stages * kCols * pitch_of(chunk_rows);
  if (n < 0 || W < 1 || W > 1024 || chunk_rows < 1 || stages < 1 ||
      (chunk_rows % kGroup != 0 && chunk_rows < n) || smem > 232448)
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(perrow_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  perrow_walk_kernel<<<(W + kCols - 1) / kCols, 2 * kWarp, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, W, chunk_rows, stages);
  return static_cast<int>(cudaGetLastError());
}

// The SM cycles of a chain of n dependent f32 adds (n a multiple of 64) on
// one thread, into cycles (int64); in: 64 f32, 16-byte aligned; out: 1 f32.
extern "C" int perrow_add_chain_cycles(const void* in, void* out, void* cycles, int n,
                                       void* stream) {
  if (n < kGroup || n % kGroup != 0) return cudaErrorInvalidValue;
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<long long*>(cycles),
      n);
  return static_cast<int>(cudaGetLastError());
}
