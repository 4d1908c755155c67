// gather_chunked: for C int32 planes of one SMALL table (s <= 16384 entries)
// and one index array of any length,
// out[p][i] = plane[p][clamp(idx[i], 0, s - 1)].
//
// Replaces the TPU kernel `_gather_chunked_i32` / wrapper
// `gather_chunked_planes` of lingodb_tpu/ops/pgather.py, which has no
// addressable gather wider than one vector register and therefore compares
// every index against every 128-entry chunk of the table. On an NVIDIA GPU
// shared memory is addressable per thread, so the table is simply loaded
// into it once per block and indexed.
//
// Layout: blockIdx.y selects the plane (a 16384-entry plane is 64 KB; eight
// of them would not fit one block's 227 KB), blockIdx.x walks the index
// tiles grid-stride, so a block loads its plane ONCE and then streams many
// tiles of indices through it. Index loads and output stores are coalesced
// (thread t handles rows t, t + 256, ...).
//
// Bound on this card: bytes - the indices are read once per plane (4 x C
// bytes per row; the re-reads of a 6M-row index array mostly come from L2)
// and 4 x C bytes per row are written; the table itself is negligible.
// Random indices cost shared-memory bank conflicts, not device-memory
// traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kMaxPlanes = 8;
constexpr int kMaxEntries = 16384;

struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
  int64_t in_stride[kMaxPlanes];
  int64_t out_stride[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
gather_chunked_kernel(Planes pl, const int* __restrict__ idx, int64_t n,
                      int s) {
  extern __shared__ int table[];
  const int p = blockIdx.y;
  const int* __restrict__ src = pl.in[p];
  const int64_t in_stride = pl.in_stride[p];
  for (int e = threadIdx.x; e < s; e += kThreads) {
    table[e] = src[(int64_t)e * in_stride];
  }
  __syncthreads();
  int* __restrict__ dst = pl.out[p];
  const int64_t out_stride = pl.out_stride[p];
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  for (int64_t tile = (int64_t)blockIdx.x * per_block; tile < n;
       tile += (int64_t)gridDim.x * per_block) {
    int v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t row = tile + (int64_t)j * kThreads + threadIdx.x;
      v[j] = row < n ? idx[row] : 0;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t row = tile + (int64_t)j * kThreads + threadIdx.x;
      if (row < n) dst[row * out_stride] = table[min(max(v[j], 0), s - 1)];
    }
  }
}

}  // namespace

// planes/outs: arrays of C device pointers (int32 data); strides in int32
// elements. 1 <= s <= 16384, n >= 1, 1 <= C <= 8. `max_blocks` caps
// gridDim.x (the caller passes a small multiple of the SM count).
// Returns the CUDA error of the attribute call or the launch.
extern "C" int ldb_gather_chunked(const void* const* planes,
                                  const int64_t* plane_strides,
                                  void* const* outs,
                                  const int64_t* out_strides, int num_planes,
                                  int64_t s, const void* idx, int64_t n,
                                  int max_blocks, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes) return -1;
  if (s < 1 || s > kMaxEntries) return -2;
  Planes pl = {};
  for (int p = 0; p < num_planes; ++p) {
    pl.in[p] = static_cast<const int*>(planes[p]);
    pl.out[p] = static_cast<int*>(outs[p]);
    pl.in_stride[p] = plane_strides[p];
    pl.out_stride[p] = out_strides[p];
  }
  const size_t smem = (size_t)s * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gather_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxEntries * (int)sizeof(int));
  if (err != cudaSuccess) return (int)err;
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  int64_t tiles = (n + per_block - 1) / per_block;
  if (tiles > max_blocks) tiles = max_blocks;
  dim3 grid((unsigned)tiles, (unsigned)num_planes);
  gather_chunked_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pl, static_cast<const int*>(idx), n, (int)s);
  return (int)cudaGetLastError();
}
