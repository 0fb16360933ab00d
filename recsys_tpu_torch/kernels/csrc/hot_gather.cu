// Gather from a hot-row buffer held in shared memory, for Hopper (sm_90a).
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
// pack 1 and ~13,300 hot ids of a Zipf(1.1) batch that is under 1 MB,
// 0.29 us at 3.35 TB/s, so the kernel is bound by its launch.
//
// Design: the TPU kernel gathered by a one-hot matmul on the MXU (bf16 by
// default) and compressed lanes with a second matmul, because Mosaic has
// no per-row dynamic gather from VMEM.  Shared memory has one: each block
// copies the whole hot buffer into shared memory once (16-byte loads where
// d % 4 == 0 and the pointers are aligned), then takes 256-id chunks in a
// grid-stride loop, at least 4 chunks a block where there are that many,
// so the staging is not paid per chunk.  Thread e of a chunk writes one
// 16-byte piece (or one value) of one output row; a row's pieces are
// neighbouring threads, so the stores coalesce.  The result is the exact
// f32 row, the JAX function with mm_bf16=False.  A buffer above 48 KB
// needs the opt-in dynamic shared memory; above the card's opt-in limit
// (227 KB on the H100) the wrapper refuses it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;           // ids per chunk, the TPU kernel's CH
constexpr int kMinChunksPerBlock = 4;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    hot_gather_kernel(const float* __restrict__ hot, const int* __restrict__ ids,
                      float* __restrict__ out, int rows, int d, int n, int chunks) {
  extern __shared__ float4 smem4[];
  float* const buf = reinterpret_cast<float*>(smem4);
  const int total = rows * d;
  if constexpr (VEC) {
    const float4* h4 = reinterpret_cast<const float4*>(hot);
    for (int i = threadIdx.x; i < total / 4; i += kThreads) smem4[i] = __ldg(h4 + i);
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) buf[i] = __ldg(hot + i);
  }
  __syncthreads();
  const int per_row = VEC ? d / 4 : d;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int base = ch * kChunk;
    const int in_chunk = n - base < kChunk ? n - base : kChunk;
    for (int e = threadIdx.x; e < in_chunk * per_row; e += kThreads) {
      const int r = e / per_row, q = e - r * per_row;
      const int id = __ldg(ids + base + r);
      const bool hit = id >= 0 && id < rows;
      const size_t o = static_cast<size_t>(base + r) * per_row + q;
      if constexpr (VEC) {
        reinterpret_cast<float4*>(out)[o] =
            hit ? smem4[id * per_row + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        out[o] = hit ? buf[id * d + q] : 0.f;
      }
    }
  }
}

int device_attr(cudaDeviceAttr a) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, a, dev);
  return v;
}

}  // namespace

// The most dynamic shared memory one block may opt in to on the current
// device, in bytes (232,448 on the H100).
extern "C" int hot_gather_smem_limit() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// hot (H, pack·d) f32; ids (n) int32; out (n, d) f32.  H·pack·d·4 bytes
// must fit the opt-in limit.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hot_gather_launch(const void* hot, const void* ids, void* out, int H, int pack,
                                 int d, int n, void* stream) {
  if (H < 1 || pack < 1 || d < 1 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long rows = static_cast<long long>(H) * pack;
  const size_t smem = static_cast<size_t>(rows) * d * sizeof(float);
  if (smem > static_cast<size_t>(hot_gather_smem_limit())) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (n + kChunk - 1) / kChunk;
  int grid = (chunks + kMinChunksPerBlock - 1) / kMinChunksPerBlock;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (grid > sms) grid = sms;
  const bool vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(hot) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    cudaFuncSetAttribute(hot_gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    hot_gather_kernel<true><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(hot), static_cast<const int*>(ids), static_cast<float*>(out),
        static_cast<int>(rows), d, n, chunks);
  } else {
    cudaFuncSetAttribute(hot_gather_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    hot_gather_kernel<false><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(hot), static_cast<const int*>(ids), static_cast<float*>(out),
        static_cast<int>(rows), d, n, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
