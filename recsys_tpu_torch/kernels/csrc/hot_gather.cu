// Gather from a hot-row buffer, for Hopper (sm_90a).
//
// Replaces: recsys_tpu/tools/gather_split_probe.py::hot_gather_pallas (body
// _hot_gather_kernel).  hot (H, pack·d) f32, the staged hot rows of a
// table; ids (n) int32 hot slot ids, slot·pack + sub -> out (n, d) f32,
// out[r] = hot[id / pack, (id % pack)·d : +d], and a zero row for an id
// outside [0, H·pack) (the probe pads each 256-id chunk with the sentinel
// H·pack).  A (H, pack·d) row-major buffer is the (H·pack, d) table of its
// logical rows, so the row of id is simply rows id·d .. id·d + d of it.
//
// Bound on the H100: bytes (no arithmetic): the hot buffer read once, the
// ids read and the rows written once.  At the probe's H = 1024, d = 16,
// pack 1 and ~12,800 hot ids of a Zipf(1.1) batch that is under 1 MB,
// 0.28 us at 3.35 TB/s, below what a launch costs: the kernel is bound by
// its launch and by two dependent loads (the id, then the row).
//
// Design: the TPU kernel gathered by a one-hot matmul on the MXU (bf16 by
// default) and compressed lanes with a second matmul, because Mosaic has
// no per-row dynamic gather from VMEM.  Here every output row is cut into
// pieces, 16 bytes each where d % 4 == 0 and the buffer and output are
// 16-byte aligned (else one value each), and a thread takes one piece:
// it loads its row's id once, then its piece, and stores it.  A row's
// pieces are neighbouring threads, so the stores coalesce, and the rows
// spread over every SM: 204 blocks of 256 threads at the probe's 13,056
// ids (hot_gather_grid).  Two or four pieces a thread, a grid apart, ran
// no faster at 13,056, 300,001 or 3,000,000 ids on the H100.  The rows
// are read straight from the buffer through L1 and L2: it was just
// written by index_select and sits in L2, where a copy staged into each
// block's shared memory (the first design) read it 132 times to serve it
// once.  The result is the exact f32 row, the JAX function with
// mm_bf16=False.  The buffer is on-chip by contract, as the TPU kernel's
// VMEM buffer was: above the card's opt-in shared-memory limit (227 KB on
// the H100) the launch refuses it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// piece i is piece i % pieces of output row i / pieces; VEC: a piece is a
// float4
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    hot_gather_kernel(const float* __restrict__ hot, const int* __restrict__ ids,
                      float* __restrict__ out, int rows, int pieces, int items) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int id = __ldg(ids + i / pieces);
  const bool hit = id >= 0 && id < rows;
  const int at = id * pieces + i % pieces;
  if constexpr (VEC) {
    reinterpret_cast<float4*>(out)[i] =
        hit ? __ldg(reinterpret_cast<const float4*>(hot) + at) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    out[i] = hit ? __ldg(hot + at) : 0.f;
  }
}

__global__ void empty_kernel() {}

bool vec_pieces(const void* hot, const void* out, int d) {
  return d % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(hot) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

}  // namespace

// The most dynamic shared memory one block may opt in to on the current
// device, in bytes (232,448 on the H100); read once a device.
extern "C" int hot_gather_smem_limit() {
  static int cached[kMaxDevices] = {};
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && cached[dev]) return cached[dev];
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev >= 0 && dev < kMaxDevices) cached[dev] = v;
  return v;
}

// Blocks of 256 threads the gather of n rows of width d launches: one a
// 256 pieces, 16-byte pieces where vec.  -1 past what an int indexes.
extern "C" int hot_gather_grid(int n, int d, int vec) {
  const long long items = static_cast<long long>(n) * (vec ? d / 4 : d);
  if (n < 0 || d < 1 || items >= (1LL << 31) - kThreads) return -1;
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

// hot (H, pack·d) f32; ids (n) int32; out (n, d) f32.  H·pack·d·4 bytes
// must fit the opt-in limit.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hot_gather_launch(const void* hot, const void* ids, void* out, int H, int pack,
                                 int d, int n, void* stream) {
  if (H < 1 || pack < 1 || d < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long rows = static_cast<long long>(H) * pack;
  if (rows * d * static_cast<long long>(sizeof(float)) > hot_gather_smem_limit())
    return cudaErrorInvalidValue;
  const bool vec = vec_pieces(hot, out, d);
  const int grid = hot_gather_grid(n, d, vec);
  if (grid < 0) return cudaErrorInvalidValue;
  const int pieces = vec ? d / 4 : d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    hot_gather_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hot), static_cast<const int*>(ids), static_cast<float*>(out),
        static_cast<int>(rows), pieces, n * pieces);
  else
    hot_gather_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(hot), static_cast<const int*>(ids), static_cast<float*>(out),
        static_cast<int>(rows), pieces, n * pieces);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `grid` blocks of 256 threads: timed beside the gather
// at its own grid, the floor that any launch of that geometry costs.
extern "C" int hot_gather_floor(int grid, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  empty_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
