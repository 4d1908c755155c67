// gather_sorted: for C equal-length int32 planes and ONE index array,
// out[p][i] = plane[p][clamp(idx[i], 0, s - 1)].
//
// Replaces the TPU kernel `_gather_sorted_i32` / wrapper
// `gather_sorted_planes` of lingodb_tpu/ops/pgather.py. The TPU cannot read
// scattered addresses of its device memory from inside a kernel, so that
// kernel copies an aligned window of the table per index tile into on-chip
// memory and walks it chunk by chunk; an index outside its tile's window
// cannot be served and is counted in an overflow output (`d_chunks`,
// `t_rows` and `conservative` size that window). A GPU thread can load any
// address, so here every index is served straight from global memory and no
// window exists: the overflow output and the window parameters are dropped
// from the port, and the wrapper returns the values alone.
//
// What the sorted contract still buys: with nondecreasing indices the 32
// lanes of a warp touch neighbouring 32-byte sectors (often the same one), so
// the loads coalesce and every fetched sector is used by the lanes that asked
// for it. Unsorted indices are served just as correctly, only with one
// sector per lane.
//
// Bound on this card: bytes - 4 per index read, 4 x C per index written, and
// of the planes the 32-byte sectors that hold a requested entry. The index is
// loaded and clamped ONCE per row and reused for all C planes; staging the
// span through shared memory would fetch the same sectors from device memory
// (more, when the gap is wide) and is therefore not done.
//
// Planes and outputs carry an element stride so that the two int32 limbs of
// a 64-bit column are read from, and written into, the column's own storage
// without a de-interleaving copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxPlanes = 8;

struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
  int64_t in_stride[kMaxPlanes];
  int64_t out_stride[kMaxPlanes];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
gather_sorted_kernel(Planes pl, const int* __restrict__ idx, int64_t n,
                     int s) {
  const int64_t tile = (int64_t)blockIdx.x * (kThreads * kPerThread);
  int64_t row[kPerThread];
  int src[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    row[j] = tile + (int64_t)j * kThreads + threadIdx.x;
    int v = row[j] < n ? idx[row[j]] : 0;
    src[j] = min(max(v, 0), s - 1);
  }
#pragma unroll
  for (int p = 0; p < C; ++p) {
    int val[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      val[j] = row[j] < n ? __ldg(pl.in[p] + (int64_t)src[j] * pl.in_stride[p])
                          : 0;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (row[j] < n) pl.out[p][row[j] * pl.out_stride[p]] = val[j];
    }
  }
}

template <int C>
int launch(const Planes& pl, const int* idx, int64_t n, int s,
           cudaStream_t st) {
  const int64_t per_block = kThreads * kPerThread;
  const int64_t blocks = (n + per_block - 1) / per_block;
  gather_sorted_kernel<C><<<(unsigned)blocks, kThreads, 0, st>>>(pl, idx, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// planes/outs: arrays of C device pointers (int32 data); strides in int32
// elements. s >= 1, n >= 1, 1 <= C <= 8. Returns the CUDA launch error.
extern "C" int ldb_gather_sorted(const void* const* planes,
                                 const int64_t* plane_strides,
                                 void* const* outs, const int64_t* out_strides,
                                 int num_planes, int64_t s, const void* idx,
                                 int64_t n, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes) return -1;
  Planes pl = {};
  for (int p = 0; p < num_planes; ++p) {
    pl.in[p] = static_cast<const int*>(planes[p]);
    pl.out[p] = static_cast<int*>(outs[p]);
    pl.in_stride[p] = plane_strides[p];
    pl.out_stride[p] = out_strides[p];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const int si = (int)s;
  switch (num_planes) {
    case 1: return launch<1>(pl, ix, n, si, st);
    case 2: return launch<2>(pl, ix, n, si, st);
    case 3: return launch<3>(pl, ix, n, si, st);
    case 4: return launch<4>(pl, ix, n, si, st);
    case 5: return launch<5>(pl, ix, n, si, st);
    case 6: return launch<6>(pl, ix, n, si, st);
    case 7: return launch<7>(pl, ix, n, si, st);
    default: return launch<8>(pl, ix, n, si, st);
  }
}
