// segscan: segmented inclusive sum of W int32 planes over a sorted int32 key.
//
//   out[w][i] = vals[w][s] + ... + vals[w][i], s the first row of the run of
//   equal gid that holds row i; sums wrap in int32.
//
// Replaces the TPU kernel `_segscan_kernel` / wrapper `segscan_i32` of
// lingodb_tpu/ops/pgather.py. That kernel runs a Hillis-Steele shift-add
// over (64, 128) tiles and walks its grid in order, carrying the last run's
// running sum in on-chip scratch from one grid step to the next. Thread
// blocks on an NVIDIA GPU run in no order, so the carry goes through device
// memory instead: one pass with decoupled look-back.
//
//   - A block takes its tile number from an atomic counter, not from
//     blockIdx: every tile before it has then already started, so every
//     tile it waits for is resident and makes progress.
//   - Each warp loads its 32 x ITEMS rows of gid and of every plane with
//     coalesced 4-byte loads (planes may be strided), all in flight
//     together, and turns them through shared memory (__syncwarp only) so
//     that each thread holds ITEMS consecutive rows. It scans them
//     sequentially in registers.
//   - One warp scan (__shfl_up_sync) and one block step over the 8 warp
//     totals in shared memory scan the threads' aggregates.
//   - The segmented operator is (fa, va) + (fb, vb) = (fa | fb, fb ? vb :
//     va + vb), f the run-head flag gid[i] != gid[i - 1] (row 0 is a head).
//     The block publishes its tile aggregate: a tile that holds a run head
//     publishes it as its inclusive prefix at once (its last run begins
//     inside it); any other tile publishes it as an aggregate, looks back,
//     and then publishes its inclusive prefix.
//   - Only the rows before the tile's first head take the prefix of the
//     tiles before it. Every other row is final once the block has scanned,
//     and is written before the look-back, so that the block's stores drain
//     while warp 0 waits. A tile whose first row is a head looks back not
//     at all.
//   - Warp 0 looks back over 32 predecessors at a time, plane by plane,
//     until it meets an inclusive prefix, adding the aggregates of the
//     tiles before it. At runs of 4 every tile holds a head and the
//     look-back is one tile deep; a single run over the whole array is the
//     worst case.
//   - Each plane of each tile has one 64-bit status word, (status << 32) |
//     uint32 value, status 0 not ready, 1 aggregate, 2 inclusive, stored
//     and read whole (st/ld.relaxed.gpu): a reader sees each plane's value
//     together with its status, and needs no fence. A look-back step has
//     its 32 x W loads in flight together. The words and the tile
//     counter come zeroed from the caller (one memset a call), so nothing
//     of an earlier call is read as ready.
// Rows past n open a run of their own and never feed a live row. A warp's
// first row compares its gid with gid[start - 1]. For a nondecreasing gid
// the head flag is the reference's "same gid" test; the kernel is correct
// for sorted gid only, which is the contract, and is tested on sorted input
// only. The first tile starts from a carry of 0, so the reference's
// first-tile sentinel gid (-2147483647) has no counterpart: a leading run
// of that id picks up nothing, as there.
//
// Sums are taken in uint32 (signed overflow is undefined in C++) and read
// back as int32, which is the reference's wrapping int32 add.
//
// Bound on this card: bytes - 4 per row of gid and 4 x W per row of values
// read once, 4 x W per row written once. ITEMS rows a thread: 16 for W <= 2,
// 8 above (the registers of W + 1 arrays of ITEMS values), so a tile is
// 4096 or 2048 rows. Three __syncthreads per tile, whatever W (two when the
// tile's first row is a head): the tile number, the warp totals, the
// look-back's prefix. The design it replaces (three launches: tile
// aggregates, one block scanning them, apply) read gid and every plane
// twice and ran one row a thread with three __syncthreads per plane per
// 256-row chunk: 4.2x its bound at 6M rows. What is left between this
// kernel and its bound is mostly the look-back: blocks that start together
// reach it together, and each waits one L2 round trip or more for its
// predecessor's word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 8;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// rows a thread, by the number of planes
__host__ __device__ constexpr int items_for(int planes) {
  return planes <= 2 ? 16 : 8;
}

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int64_t in_stride[kMaxPlanes];
  int64_t out_stride[kMaxPlanes];
};

// A status word is read and written whole, relaxed at device scope: it
// carries its own value, so no order with any other access is needed.
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// (f, v) <- (f, v) + (g, u) under the segmented operator
template <int W>
__device__ __forceinline__ void combine(int& f, uint32_t (&v)[W], int g,
                                        const uint32_t* u) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = g ? u[w] : v[w] + u[w];
  f |= g;
}

// striped (row k * 32 + lane of the warp's rows) -> blocked (row lane *
// ITEMS + k), through the warp's shared buffer of 33 x ITEMS words
template <int ITEMS>
__device__ __forceinline__ void to_blocked(uint32_t (&a)[ITEMS], uint32_t* sh,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) sh[k * 33 + lane] = a[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = lane * ITEMS + k;
    a[k] = sh[j + (j >> 5)];
  }
  __syncwarp();
}

template <int ITEMS>
__device__ __forceinline__ void to_striped(uint32_t (&a)[ITEMS], uint32_t* sh,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = lane * ITEMS + k;
    sh[j + (j >> 5)] = a[k];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) a[k] = sh[k * 33 + lane];
  __syncwarp();
}

// Warp 0: the exclusive prefix of `tile` under the segmented operator, per
// plane, from the status words of the tiles before it. Every lane returns
// the same values.
template <int W>
__device__ __forceinline__ void look_back(const unsigned long long* state,
                                          int64_t tile, int lane,
                                          uint32_t (&prefix)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) prefix[w] = 0u;
  unsigned done = 0;  // planes whose inclusive prefix was met
  for (int64_t top = tile - 1; done != (1u << W) - 1; top -= 32) {
    const int64_t t = top - lane;
    // the W words of tile t, all in flight together, until all are ready
    unsigned long long word[W];
    bool ready;
    do {
#pragma unroll
      for (int w = 0; w < W; ++w)  // before tile 0: the identity, inclusive
        word[w] = t < 0 ? kInclusive : load_word(state + t * W + w);
      ready = true;
#pragma unroll
      for (int w = 0; w < W; ++w) ready &= (word[w] >> 32) != 0;
    } while (!ready);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (done >> w & 1u) continue;
      const unsigned inc =
          __ballot_sync(0xffffffffu, (word[w] >> 32) == (kInclusive >> 32));
      uint32_t v = (uint32_t)word[w];
      if (inc) {
        // the nearest inclusive prefix, and the aggregates after it
        if (lane > __ffs(inc) - 1) v = 0u;
        done |= 1u << w;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      prefix[w] += v;
    }
  }
}

// Above 4 planes the kernel would take more than 128 registers a thread,
// one block an SM; capped at 128 (a few bytes spill), two blocks share an
// SM and overlap.
template <int W>
__global__ void __launch_bounds__(kThreads, W > 4 ? 2 : 1)
segscan_kernel(Planes pl, const int* __restrict__ gid, int64_t n,
               unsigned long long* __restrict__ state,
               unsigned* __restrict__ counter) {
  constexpr int ITEMS = items_for(W);
  constexpr int kWarpRows = 32 * ITEMS;
  constexpr int kTile = kWarps * kWarpRows;
  __shared__ uint32_t sh_t[kWarps][33 * ITEMS];
  __shared__ int sh_tile;
  __shared__ int sh_wf[kWarps];
  __shared__ uint32_t sh_wv[kWarps][W];
  __shared__ uint32_t sh_prefix[W];
  __shared__ int sh_first[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* sh = sh_t[warp];

  if (threadIdx.x == 0) sh_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = sh_tile;
  const int64_t wbase = tile * kTile + (int64_t)warp * kWarpRows;

  // every load of the warp's rows in flight at once, striped
  uint32_t g[ITEMS];
  uint32_t v[W][ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = wbase + k * 32 + lane;
    const bool live = i < n;
    g[k] = live ? (uint32_t)__ldg(gid + i) : 0u;
#pragma unroll
    for (int w = 0; w < W; ++w)
      v[w][k] = live ? __ldg(pl.in[w] + i * pl.in_stride[w]) : 0u;
  }
  const uint32_t g_before =
      lane == 0 && wbase > 0 && wbase < n ? (uint32_t)__ldg(gid + wbase - 1) : 0u;

  to_blocked<ITEMS>(g, sh, lane);
#pragma unroll
  for (int w = 0; w < W; ++w) to_blocked<ITEMS>(v[w], sh, lane);

  // head flags of the thread's rows wbase + lane * ITEMS + k
  const int64_t row0 = wbase + (int64_t)lane * ITEMS;
  const uint32_t g_prev_lane = __shfl_up_sync(0xffffffffu, g[ITEMS - 1], 1);
  uint32_t heads = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = row0 + k;
    const uint32_t prev = k ? g[k - 1] : (lane ? g_prev_lane : g_before);
    if (i >= n || i == 0 || g[k] != prev) heads |= 1u << k;
  }
  // the tile's first head row, by warp: the rows before it are the only
  // ones whose sums take the prefix of the tiles before this one
  const int first = __reduce_min_sync(
      0xffffffffu, heads ? warp * kWarpRows + lane * ITEMS + __ffs(heads) - 1
                         : kTile);
  if (lane == 0) sh_first[warp] = first;

  // the thread's aggregate, then the warp's inclusive scan of them
  int f = heads != 0;
  uint32_t s[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) acc = (heads >> k & 1u) ? v[w][k] : acc + v[w][k];
    s[w] = acc;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int uf = __shfl_up_sync(0xffffffffu, f, d);
    uint32_t u[W];
#pragma unroll
    for (int w = 0; w < W; ++w) u[w] = __shfl_up_sync(0xffffffffu, s[w], d);
    if (lane >= d) {
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] = f ? s[w] : u[w] + s[w];
      f |= uf;
    }
  }
  if (lane == 31) {
    sh_wf[warp] = f;
#pragma unroll
    for (int w = 0; w < W; ++w) sh_wv[warp][w] = s[w];
  }
  // the thread's exclusive prefix within the warp
  int xf = __shfl_up_sync(0xffffffffu, f, 1);
  uint32_t xv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) xv[w] = __shfl_up_sync(0xffffffffu, s[w], 1);
  if (lane == 0) {
    xf = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) xv[w] = 0u;
  }
  __syncthreads();

  // the warp's exclusive prefix within the block
  int bf = 0;
  uint32_t bv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) bv[w] = 0u;
  for (int j = 0; j < warp; ++j) combine<W>(bf, bv, sh_wf[j], sh_wv[j]);

  int head_row = kTile;  // the tile's first head row
#pragma unroll
  for (int j = 0; j < kWarps; ++j) head_row = min(head_row, sh_first[j]);

  // warp 0: the tile's aggregate, published at once
  int tf = 0;
  uint32_t tv[W];
  unsigned long long* mine = state + tile * W;
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) tv[w] = 0u;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) combine<W>(tf, tv, sh_wf[j], sh_wv[j]);
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (lane == w)
        store_word(mine + w, (tf ? kInclusive : kAggregate) | tv[w]);
  }

  // the thread's rows without the tile's prefix, turned striped; the rows
  // from the tile's first head on are final and written before the
  // look-back, so that their stores drain while it waits
  const int64_t sbase = wbase + lane;
  const int jbase = warp * kWarpRows + lane;  // the striped row k is jbase + 32k
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t c = bv[w];
    c = xf ? xv[w] : c + xv[w];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      c = (heads >> k & 1u) ? v[w][k] : c + v[w][k];
      v[w][k] = c;
    }
    to_striped<ITEMS>(v[w], sh, lane);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = sbase + k * 32;
      if (jbase + k * 32 >= head_row && i < n)
        pl.out[w][i * pl.out_stride[w]] = v[w][k];
    }
  }

  if (warp == 0 && head_row > 0) {
    // look back (not from tile 0: row 0 is a head); a tile without a head
    // then publishes its inclusive prefix
    uint32_t prefix[W];
    look_back<W>(state, tile, lane, prefix);
    if (!tf) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (lane == w) store_word(mine + w, kInclusive | (prefix[w] + tv[w]));
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) sh_prefix[w] = prefix[w];
    }
  }
  if (head_row == 0) return;  // the tile's first row is a head: all written
  __syncthreads();

  // the rows before the tile's first head take its prefix
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = sbase + k * 32;
      if (jbase + k * 32 < head_row && i < n)
        pl.out[w][i * pl.out_stride[w]] = v[w][k] + sh_prefix[w];
    }
  }
}

template <int W>
int launch(const Planes& pl, const int* gid, int64_t n,
           unsigned long long* scratch, cudaStream_t st) {
  constexpr int kTile = kThreads * items_for(W);
  const int64_t tiles = (n + kTile - 1) / kTile;
  // scratch[0]: the tile counter; then tiles x W status words
  segscan_kernel<W><<<(unsigned)tiles, kThreads, 0, st>>>(
      pl, gid, n, scratch + 1, reinterpret_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

// gid: n int32 (nondecreasing), 1 <= n < 2^31. vals/outs: arrays of W
// device pointers to int32 data with element strides, 1 <= W <= 8.
// scratch: 1 + ceil(n / ldb_segscan_tile(W)) * W zeroed 64-bit words. One
// kernel launch. Returns its CUDA error (0 = none), or a negative code for
// arguments it does not take.
extern "C" int ldb_segscan(const void* gid, int64_t n,
                           const void* const* vals, const int64_t* val_strides,
                           void* const* outs, const int64_t* out_strides,
                           int num_planes, void* scratch, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes) return -1;
  if (n < 1 || n > 2147483647) return -2;
  Planes pl = {};
  for (int p = 0; p < num_planes; ++p) {
    pl.in[p] = static_cast<const uint32_t*>(vals[p]);
    pl.out[p] = static_cast<uint32_t*>(outs[p]);
    pl.in_stride[p] = val_strides[p];
    pl.out_stride[p] = out_strides[p];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  auto* s = static_cast<unsigned long long*>(scratch);
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

// Rows per tile for W planes: the wrapper sizes `scratch` from it.
extern "C" int ldb_segscan_tile(int num_planes) {
  return kThreads * items_for(num_planes);
}
