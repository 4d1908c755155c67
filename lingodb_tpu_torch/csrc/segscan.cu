// segscan: segmented inclusive sum of W int32 planes over a sorted int32 key.
//
//   out[w][i] = vals[w][s] + ... + vals[w][i], s the first row of the run of
//   equal gid that holds row i; sums wrap in int32.
//
// Replaces the TPU kernel `_segscan_kernel` / wrapper `segscan_i32` of
// lingodb_tpu/ops/pgather.py. That kernel runs a Hillis-Steele shift-add
// over (64, 128) tiles and walks its grid in order, carrying the last run's
// running sum in on-chip scratch from one grid step to the next. Thread
// blocks on an NVIDIA GPU run in no order, so nothing is carried between
// them; the work is split into three launches, as in compact_positions.cu:
//
//   1. reduce : every block scans its 2048-row tile with a carry of 0 and
//               writes the tile's aggregate under the segmented operator,
//               (any run head in the tile, sum of the tile's last run).
//   2. scan   : ONE block scans the tile aggregates under the same operator
//               and writes, per tile, the inclusive value: the running sum
//               that the next tile's leading rows continue. A run that spans
//               any number of tiles is carried through all of them.
//   3. apply  : every block scans its tile again, starting from the value
//               the scan pass left for the tile before it, and writes out.
//
// The segmented operator is (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va + vb)
// with f the run-head flag, gid[i] != gid[i - 1] (row 0 is a head). For a
// nondecreasing gid that is the reference's "same gid" test; the kernel is
// correct for sorted gid only, which is the contract, and is tested on
// sorted input only. The first tile starts from a carry of 0, so the
// reference's first-tile sentinel gid (-2147483647) has no counterpart: a
// leading run of that id picks up nothing, as there.
//
// Sums are taken in uint32 (signed overflow is undefined in C++) and read
// back as int32, which is the reference's wrapping int32 add.
//
// Bound on this card: bytes - 4 per row of gid and 4 x W per row of values
// read, 4 x W per row written. Passes 1 and 3 both read gid and the values
// (the second read of a 6M-row input mostly comes from the 50 MB L2). Inside
// a block, each chunk of 256 rows is one row per thread, so every load and
// store coalesces, and the scan inside the chunk is five __shfl_up_sync
// steps per warp plus one shared-memory hop across the eight warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 8;
constexpr int kTile = kThreads * kChunks;  // rows per block
constexpr int kScanThreads = 1024;
constexpr int kMaxPlanes = 8;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int64_t in_stride[kMaxPlanes];
  int64_t out_stride[kMaxPlanes];
};

// Segmented inclusive scan of one (flag, value) per thread, in thread order.
// Returns the value; *f_incl gets whether a head lies at or before this
// thread in the block. The caller adds its carry where *f_incl is 0.
// sh_f / sh_v: shared scratch of NWARPS entries each.
template <int NWARPS>
__device__ __forceinline__ uint32_t block_segscan(int f, uint32_t v,
                                                  int* f_incl, int* sh_f,
                                                  uint32_t* sh_v) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t uv = __shfl_up_sync(0xffffffffu, v, d);
    const int uf = __shfl_up_sync(0xffffffffu, f, d);
    if (lane >= d) {
      if (!f) v += uv;
      f |= uf;
    }
  }
  if (lane == 31) {
    sh_f[warp] = f;
    sh_v[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    // lanes >= NWARPS only ever receive from lower lanes: their contents
    // never reach the lanes that are stored
    int wf = lane < NWARPS ? sh_f[lane] : 1;
    uint32_t wv = lane < NWARPS ? sh_v[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t uv = __shfl_up_sync(0xffffffffu, wv, d);
      const int uf = __shfl_up_sync(0xffffffffu, wf, d);
      if (lane >= d) {
        if (!wf) wv += uv;
        wf |= uf;
      }
    }
    if (lane < NWARPS) {
      sh_f[lane] = wf;
      sh_v[lane] = wv;
    }
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v += sh_v[warp - 1];
    f |= sh_f[warp - 1];
  }
  *f_incl = f;
  __syncthreads();  // sh_f / sh_v are rewritten by the next call
  return v;
}

// Scan one tile of every plane, starting from carry[w] (the running sum the
// tile's leading rows continue). On return carry[w] is the value at the
// tile's last row and *any_head whether a run starts inside the tile.
template <int W, bool kWrite>
__device__ __forceinline__ void scan_tile(const Planes& pl,
                                          const int* __restrict__ gid,
                                          int64_t n, int64_t tile0,
                                          uint32_t (&carry)[W], int* any_head) {
  __shared__ int sh_f[kThreads / 32];
  __shared__ uint32_t sh_v[kThreads / 32];
  __shared__ uint32_t sh_c[kMaxPlanes];
  int head = 0;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t i = tile0 + (int64_t)c * kThreads + threadIdx.x;
    const bool live = i < n;
    // rows past the end open a run of their own: they never feed a live row
    const int f = live ? (i == 0 || gid[i] != gid[i - 1]) : 1;
    head |= __syncthreads_or(live && f);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t v = live ? pl.in[w][i * pl.in_stride[w]] : 0u;
      int fi;
      const uint32_t s =
          block_segscan<kThreads / 32>(f, v, &fi, sh_f, sh_v);
      const uint32_t o = fi ? s : carry[w] + s;
      if (kWrite && live) pl.out[w][i * pl.out_stride[w]] = o;
      if (threadIdx.x == kThreads - 1) sh_c[w] = o;
      __syncthreads();
      carry[w] = sh_c[w];
    }
  }
  *any_head = head;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
segscan_reduce_kernel(Planes pl, const int* __restrict__ gid, int64_t n,
              int* __restrict__ tile_head, uint32_t* __restrict__ tile_sum,
              int num_tiles) {
  uint32_t carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w) carry[w] = 0u;
  int head;
  scan_tile<W, false>(pl, gid, n, (int64_t)blockIdx.x * kTile, carry, &head);
  if (threadIdx.x == 0) {
    tile_head[blockIdx.x] = head;
#pragma unroll
    for (int w = 0; w < W; ++w)
      tile_sum[(int64_t)w * num_tiles + blockIdx.x] = carry[w];
  }
}

// One block: tile aggregates -> per tile, the inclusive value under the
// segmented operator (what the next tile's leading rows continue).
template <int W>
__global__ void __launch_bounds__(kScanThreads)
segscan_scan_kernel(const int* __restrict__ tile_head,
            const uint32_t* __restrict__ tile_sum,
            uint32_t* __restrict__ tile_incl, int num_tiles) {
  __shared__ int sh_f[kScanThreads / 32];
  __shared__ uint32_t sh_v[kScanThreads / 32];
  __shared__ uint32_t sh_c[kMaxPlanes];
  uint32_t carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w) carry[w] = 0u;
  for (int c0 = 0; c0 < num_tiles; c0 += kScanThreads) {
    const int t = c0 + threadIdx.x;
    const bool live = t < num_tiles;
    const int f = live ? tile_head[t] : 1;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t v = live ? tile_sum[(int64_t)w * num_tiles + t] : 0u;
      int fi;
      const uint32_t s =
          block_segscan<kScanThreads / 32>(f, v, &fi, sh_f, sh_v);
      const uint32_t o = fi ? s : carry[w] + s;
      if (live) tile_incl[(int64_t)w * num_tiles + t] = o;
      if (threadIdx.x == kScanThreads - 1) sh_c[w] = o;
      __syncthreads();
      carry[w] = sh_c[w];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
segscan_apply_kernel(Planes pl, const int* __restrict__ gid, int64_t n,
             const uint32_t* __restrict__ tile_incl, int num_tiles) {
  uint32_t carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    carry[w] = blockIdx.x > 0
                   ? tile_incl[(int64_t)w * num_tiles + blockIdx.x - 1]
                   : 0u;
  int head;
  scan_tile<W, true>(pl, gid, n, (int64_t)blockIdx.x * kTile, carry, &head);
}

template <int W>
int launch(const Planes& pl, const int* gid, int64_t n, int* scratch,
           cudaStream_t st) {
  const int num_tiles = (int)((n + kTile - 1) / kTile);
  int* head = scratch;
  uint32_t* sum = reinterpret_cast<uint32_t*>(scratch + num_tiles);
  uint32_t* incl = sum + (int64_t)W * num_tiles;
  segscan_reduce_kernel<W><<<num_tiles, kThreads, 0, st>>>(pl, gid, n, head,
                                                           sum, num_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segscan_scan_kernel<W><<<1, kScanThreads, 0, st>>>(head, sum, incl,
                                                     num_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segscan_apply_kernel<W><<<num_tiles, kThreads, 0, st>>>(pl, gid, n, incl,
                                                          num_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// gid: n int32 (nondecreasing), n >= 1. vals/outs: arrays of W device
// pointers to int32 data with element strides, 1 <= W <= 8. scratch:
// ceil(n / ldb_segscan_tile()) * (1 + 2 W) int32. Returns the first CUDA
// launch error (0 = none).
extern "C" int ldb_segscan(const void* gid, int64_t n,
                           const void* const* vals, const int64_t* val_strides,
                           void* const* outs, const int64_t* out_strides,
                           int num_planes, void* scratch, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes) return -1;
  Planes pl = {};
  for (int p = 0; p < num_planes; ++p) {
    pl.in[p] = static_cast<const uint32_t*>(vals[p]);
    pl.out[p] = static_cast<uint32_t*>(outs[p]);
    pl.in_stride[p] = val_strides[p];
    pl.out_stride[p] = out_strides[p];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  int* s = static_cast<int*>(scratch);
  switch (num_planes) {
    case 1: return launch<1>(pl, g, n, s, st);
    case 2: return launch<2>(pl, g, n, s, st);
    case 3: return launch<3>(pl, g, n, s, st);
    case 4: return launch<4>(pl, g, n, s, st);
    case 5: return launch<5>(pl, g, n, s, st);
    case 6: return launch<6>(pl, g, n, s, st);
    case 7: return launch<7>(pl, g, n, s, st);
    default: return launch<8>(pl, g, n, s, st);
  }
}

// Rows per block: the wrapper sizes `scratch` from it.
extern "C" int ldb_segscan_tile() { return kTile; }
