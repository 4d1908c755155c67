// compact_positions: ascending int32 positions of a mask's set bytes, plus the
// exact count of set bytes.
//
// Replaces the TPU kernel `_compact_positions_kernel` / wrapper
// `compact_positions` of lingodb_tpu/ops/pgather.py. That kernel walks its
// grid in order and carries the running output offset in on-chip scratch from
// one grid step to the next. Thread blocks on an NVIDIA GPU run in no order,
// so nothing can be carried; the work is split into three launches instead:
//
//   1. count   : every block counts the set bytes of its 4096-byte tile.
//   2. scan    : ONE block turns the per-tile counts into exclusive offsets
//                (in place) and writes the grand total - the exact count,
//                also when it exceeds the output capacity k.
//   3. scatter : every block recomputes the ranks inside its tile and writes
//                position p to out[offset + rank] where that slot is < k;
//                slots in [count, k) are filled with the sentinel, so the
//                output is nondecreasing over its whole length.
//
// No atomics: the output is bit-equal to numpy.flatnonzero for every run.
//
// Bound on this card: bytes. The mask (1 byte a row) is read twice (passes 1
// and 3; the second read of a 6M-row mask comes from the 50 MB L2) and
// 4 bytes are written per set byte. Each thread loads its 16 mask bytes with
// one 16-byte load, so a warp reads 512 contiguous bytes per instruction; a
// thread's 16 rows are consecutive, so ranks inside a tile are an exclusive
// scan over per-thread popcounts (warp shuffles, one shared-memory hop). The
// scatter pass stages a tile's positions in shared memory (16 KB) so that its
// stores to device memory coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4096 mask bytes per block
constexpr int kScanThreads = 1024;
constexpr int kSentinel = 2147483646;

// 16 flag bits (bit j set iff mask[base + j] != 0) for one thread's rows.
__device__ __forceinline__ uint32_t load_flags(const uint8_t* __restrict__ mask,
                                               int64_t base, int64_t n) {
  uint32_t bits = 0;
  if (base + kPerThread <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if ((w[q] >> (8 * b)) & 0xffu) bits |= 1u << (q * 4 + b);
      }
    }
  } else {
    for (int j = 0; j < kPerThread; ++j) {
      if (base + j < n && mask[base + j]) bits |= 1u << j;
    }
  }
  return bits;
}

// Exclusive prefix sum of `v` over the block's threads; `total` gets the
// block-wide sum. `warp_sums` is shared scratch of NWARPS ints (NWARPS <= 32).
template <int NWARPS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NWARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < NWARPS) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[NWARPS - 1];
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n,
             int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kThreads / 32];
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
  const int c = base < n ? __popc(load_flags(mask, base, n)) : 0;
  int total;
  block_exclusive_scan<kThreads / 32>(c, warp_sums, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: tile_counts -> exclusive offsets in place, *count = grand total.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ tile_counts, int num_tiles,
            int* __restrict__ count) {
  __shared__ int warp_sums[kScanThreads / 32];
  int carry = 0;
  for (int c0 = 0; c0 < num_tiles; c0 += kScanThreads) {
    const int i = c0 + threadIdx.x;
    const int v = i < num_tiles ? tile_counts[i] : 0;
    int total;
    const int excl =
        block_exclusive_scan<kScanThreads / 32>(v, warp_sums, &total);
    if (i < num_tiles) tile_counts[i] = carry + excl;
    carry += total;
    __syncthreads();  // warp_sums is reused by the next chunk
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
               const int* __restrict__ tile_offsets,
               const int* __restrict__ count, int* __restrict__ out,
               int64_t k) {
  __shared__ int warp_sums[kThreads / 32];
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
  const uint32_t bits = base < n ? load_flags(mask, base, n) : 0u;
  int total;
  const int excl =
      block_exclusive_scan<kThreads / 32>(__popc(bits), warp_sums, &total);
  // ranks are dense inside the tile: stage the tile's positions in shared
  // memory, then store them with consecutive threads on consecutive slots
  __shared__ int staged[kTile];
  int r = excl;
  uint32_t rest = bits;
  while (rest) {
    const int j = __ffs(rest) - 1;
    rest &= rest - 1;
    staged[r++] = (int)(base + j);
  }
  __syncthreads();
  const int64_t first = tile_offsets[blockIdx.x];
  for (int i = threadIdx.x; i < total; i += kThreads) {
    if (first + i < k) out[first + i] = staged[i];
  }
  // sentinel tail [count, k): shared out among all threads of the grid
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t s = (int64_t)(*count) + (int64_t)blockIdx.x * kThreads +
                   threadIdx.x;
       s < k; s += stride) {
    out[s] = kSentinel;
  }
}

}  // namespace

// scratch: ceil(n / ldb_compact_tile()) ints. mask must be 16-byte aligned,
// n >= 1.
// Returns the first CUDA launch error (0 = none).
extern "C" int ldb_compact_positions(const void* mask, int64_t n, void* scratch,
                                     void* count, void* out, int64_t k,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int num_tiles = (int)((n + kTile - 1) / kTile);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* tiles = static_cast<int*>(scratch);
  int* cnt = static_cast<int*>(count);
  count_kernel<<<num_tiles, kThreads, 0, st>>>(m, n, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, st>>>(tiles, num_tiles, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<num_tiles, kThreads, 0, st>>>(m, n, tiles, cnt,
                                                 static_cast<int*>(out), k);
  return (int)cudaGetLastError();
}

// Mask bytes per block: the wrapper sizes `scratch` from it.
extern "C" int ldb_compact_tile() { return kTile; }
