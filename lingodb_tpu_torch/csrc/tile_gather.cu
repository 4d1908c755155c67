// tile_gather: gathers inside (rows, 128) int32 arrays, along either axis.
//
//   lane_gather     out[r, j] = d[r, l[r, j]]          (along the 128 lanes)
//   sublane_gather  out[i, j] = tab[rows[i, j], j]     (along the rows of an
//                                                       (R, 128) table)
//
// Replaces the two gather probes of benchtools/tools_kbench.py:
//
//   k_lane (:76, pallas_call :79)  take_along_axis(axis=1) on (1024, 128)
//       tiles: the TPU's lane gather.
//   k_sub  (:97, pallas_call :101) take_along_axis(axis=0) of an (R, 128)
//       tile of row indices into an (R, 128) table held in VMEM for the
//       whole grid, R = 8 ... 16,384: the TPU's sublane gather.
//
// Both compute a function of the whole array that does not depend on the
// TPU's tiling; the port computes that function. For sublane_gather the
// row index points into the table, not into the tile: `rows` may have any
// number of rows, the table has R. Contracts, as the reference generates:
// 0 <= l < 128 and 0 <= rows < R. Out of them, l is taken modulo 128 and a
// row index is clamped to [0, R - 1], so that no read leaves its row or the
// table (the reference leaves them undefined).
//
// Bound on this card: bytes - for lane_gather, d and l read once and out
// written once (12 bytes an element); for sublane_gather, rows read and out
// written (8 bytes an element) and the table read once. Every array but the
// table is streamed once under the streaming cache hint. lane_gather gives
// each 128-wide row to one warp: each lane loads four values of d (16-byte
// loads and stores) into a 512-byte row buffer in shared memory (the card's
// counterpart of a vector register's lanes), and each lane then reads its
// four outputs from the buffer by l.
//
// sublane_gather works in column bands. out[:, j] reads only tab[:, j], so
// a block that owns a band of W columns needs only R x W x 4 bytes of the
// table: it stages them in dynamic shared memory once ([R][W]), then serves
// every element of the band over a range of output rows from there. W is
// the widest power of two, at least 8 (a 32-byte sector of a row), whose
// slice fits the 227 KB that a block may have: the whole table (W = 128)
// up to R = 454, W = 64 up to 908, 32 up to 1,816, 16 up to 3,632 and 8 up
// to 7,264 (ldb_sublane_band_edges gives these edges). Against a 128 KB
// budget, which takes the next narrower band at each of those edges
// (tools/design_sweep.py, H100): 3 % slower at R = 454, 3 and 8 % faster
// at 908 and 1,816, 10 % slower at 3,632, and 0.25 against 0.39 ms at
// 7,264, where the 128 KB budget needs the partial band.
// Blocks are numbered band first, so the blocks of all bands that share a
// row range run at the same time and walk the same rows of `rows` and
// `out` together, and each load of `rows` asks L2 for the 256 bytes around
// it (ld.global.L2::256B), so that a row's bytes come from device memory
// in whole pieces however narrow the band. Enough row ranges are made to
// fill the card once (the resident blocks), but never fewer than
// max(R, 64) rows a block, so that staging the band costs at most about as
// much as one block's share of the stream. For W >= 32 a lane loads and stores four neighbouring columns
// with 16-byte accesses and serves them in a rotated order (lane l takes
// column (c + l / 8) mod 4 of its four at step c), so that the 32 lanes of
// a warp read 32 different banks of the band whatever the rows. For W = 8
// and 16 a lane takes one 4-byte element a step, 16 in flight, the lanes of
// a warp covering 32 / W rows: whole sectors of `rows` and `out`, and a
// few ways of bank conflict, since the lanes of one column fall on 32 / W
// banks picked by random rows.
//
// A table too tall for a band of 8 columns (R > 7,264) takes a partial
// band while at least two fifths of it fit (R <= 18,160): the band's
// first rows in shared memory, an element of a later row read from L2
// (__ldcg), one 32-byte sector an element. At R = 16,384 44 % of the
// lookups are served from shared memory. With less of the table resident
// the partial band reads slower than the direct form, and so it does when
// `rows` is too short to give every SM's block as many rows as it stages
// (at R = 16,384, fewer than about 60,000 rows).
//
// The direct form serves tables of at most 64 rows (32 KB, which L1 holds:
// there it reads 1.2x its bound, as fast as the bands) and tables taller
// than 18,160 rows: each thread serves four neighbouring columns of one
// output row through the read-only path (__ldg) from L2; those four reads
// lie in four table rows and do not coalesce, so every element pulls its
// own 32-byte L2 sector. Tried for tall tables on an H100 SXM and not
// kept, each slower than or level with the direct form: a band of 2 or 4
// columns (each block then writes a quarter or half of every 32-byte
// sector of `out`), and a band spread over a cluster of up to 8 blocks
// through distributed shared memory (random 4-byte reads of another
// block's shared memory were slower than the L2 sectors they save).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const int* __restrict__ d, const int* __restrict__ l,
                   int64_t rows, int* __restrict__ out) {
  __shared__ __align__(16) int row_buf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* buf = row_buf[warp];
  // the row loop is the same for every lane of a warp, so __syncwarp is
  // reached by all of them
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < rows;
       r += (int64_t)gridDim.x * kWarps) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(d + r * kLanes) + lane);
    const int4 li = __ldcs(reinterpret_cast<const int4*>(l + r * kLanes) + lane);
    reinterpret_cast<int4*>(buf)[lane] = v;
    __syncwarp();
    int4 o;
    o.x = buf[li.x & (kLanes - 1)];
    o.y = buf[li.y & (kLanes - 1)];
    o.z = buf[li.z & (kLanes - 1)];
    o.w = buf[li.w & (kLanes - 1)];
    __stcs(reinterpret_cast<int4*>(out + r * kLanes) + lane, o);
    __syncwarp();  // the buffer is overwritten by the warp's next row
  }
}

__device__ __forceinline__ int64_t table_row(int i, int r_tab) {
  return (int64_t)min(max(i, 0), r_tab - 1) * kLanes;
}

__global__ void __launch_bounds__(kThreads)
sublane_direct_kernel(const int* __restrict__ tab, int r_tab,
                      const int* __restrict__ rows, int64_t quads,
                      int* __restrict__ out) {
  // quad q covers elements 4q .. 4q + 3 of the row-major array: columns
  // j .. j + 3 of one row, j = 4q mod 128
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < quads;
       q += (int64_t)gridDim.x * kThreads) {
    const int4 ri = __ldcs(reinterpret_cast<const int4*>(rows) + q);
    const int j = (int)(q & (kLanes / 4 - 1)) * 4;
    int4 o;
    o.x = __ldg(tab + table_row(ri.x, r_tab) + j);
    o.y = __ldg(tab + table_row(ri.y, r_tab) + j + 1);
    o.z = __ldg(tab + table_row(ri.z, r_tab) + j + 2);
    o.w = __ldg(tab + table_row(ri.w, r_tab) + j + 3);
    __stcs(reinterpret_cast<int4*>(out) + q, o);
  }
}

constexpr int kBandThreads = 512;
constexpr int kScalarSteps = 16;  // elements a thread has in flight, W < 32
constexpr int kQuadSteps = 4;     // 16-byte pieces in flight, W >= 32
constexpr int kMaxSmem = 232448;
constexpr int kDirectRows = 64;   // a table of 32 KB: L1 holds it
constexpr int kMinBand = 8;       // columns: a 32-byte sector of a row
// the tallest table whose slice of w columns fits a block's shared memory
constexpr int band_rows(int w) { return kMaxSmem / (4 * w); }
// a partial band of kMinBand columns holds the table's first kHeldRows
// rows, and serves tables while at least two fifths of them fit
constexpr int kHeldRows = band_rows(kMinBand);
constexpr int kPartialRows = kHeldRows * 5 / 2;


// Streamed loads of `rows` that ask L2 to fetch the 256 bytes around them
// from device memory: the blocks of the neighbouring bands read the rest of
// those bytes at about the same time, and find them in L2.
__device__ __forceinline__ int load_wide(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int4 load_wide4(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int pick(const int4& v, int x) {
  return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(int4& v, int x, int val) {
  v.x = x == 0 ? val : v.x;
  v.y = x == 1 ? val : v.y;
  v.z = x == 2 ? val : v.z;
  v.w = x == 3 ? val : v.w;
}

// Block (split s, band b) = blockIdx.x: band b holds columns [b W, b W + W)
// of the table's first `held` rows in shared memory (kPartial: the rest is
// read from L2; else held = r_tab), split s serves the output rows
// [m s / splits, m (s + 1) / splits).
template <int W, bool kPartial>
__global__ void __launch_bounds__(kBandThreads)
sublane_band_kernel(const int* __restrict__ tab, int r_tab, int held,
                    const int* __restrict__ rows, int64_t m,
                    int* __restrict__ out, int splits) {
  extern __shared__ __align__(16) int band[];  // [held][W]
  constexpr int kBands = kLanes / W;
  constexpr int kQuads = W / 4;  // 16-byte pieces of a row of the band
  const int b = blockIdx.x % kBands;
  const int s = blockIdx.x / kBands;
  const int j0 = b * W;
  for (int q = threadIdx.x; q < held * kQuads; q += kBandThreads) {
    const int64_t at = (int64_t)(q / kQuads) * kLanes + j0 + (q % kQuads) * 4;
    reinterpret_cast<int4*>(band)[q] =
        __ldg(reinterpret_cast<const int4*>(tab + at));
  }
  __syncthreads();
  const int64_t i0 = m * s / splits;
  const int nrows = (int)(m * (s + 1) / splits - i0);
  const int* src = rows + i0 * kLanes + j0;
  int* dst = out + i0 * kLanes + j0;
  const int* far = tab + j0;
  const int rmax = r_tab - 1;
  auto lookup = [&](int idx, int c) {
    const int r = min(max(idx, 0), rmax);
    if constexpr (kPartial) {
      if (r >= held) return __ldcg(far + (int64_t)r * kLanes + c);
    }
    return band[r * W + c];
  };
  if constexpr (W >= 32) {
    // 16-byte loads and stores: a lane holds four neighbouring columns and
    // at step c serves the one at (c + rot) & 3, so that the 32 lanes of a
    // warp read 32 different banks of the band
    const int rot = (threadIdx.x >> 3) & 3;
    const int total = nrows * kQuads;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBandThreads * kQuadSteps) {
      int4 v[kQuadSteps];
#pragma unroll
      for (int u = 0; u < kQuadSteps; ++u) {
        const int e = e0 + u * kBandThreads;
        if (e < total)
          v[u] = load_wide4(src + (int64_t)(e / kQuads) * kLanes +
                            4 * (e % kQuads));
      }
#pragma unroll
      for (int u = 0; u < kQuadSteps; ++u) {
        const int e = e0 + u * kBandThreads;
        if (e >= total) continue;
        const int c0 = (e % kQuads) * 4;
        int4 o = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int x = (c + rot) & 3;
          put(o, x, lookup(pick(v[u], x), c0 + x));
        }
        __stcs(reinterpret_cast<int4*>(dst + (int64_t)(e / kQuads) * kLanes) +
                   e % kQuads, o);
      }
    }
  } else {
    // 4-byte elements: the lanes of a warp cover 32 / W rows, W columns
    // each, whole sectors of `rows` and `out`
    const int total = nrows * W;
    for (int e0 = threadIdx.x; e0 < total;
         e0 += kBandThreads * kScalarSteps) {
      int v[kScalarSteps];
#pragma unroll
      for (int u = 0; u < kScalarSteps; ++u) {
        const int e = e0 + u * kBandThreads;
        v[u] = e < total ? load_wide(src + (int64_t)(e / W) * kLanes + e % W)
                         : 0;
      }
#pragma unroll
      for (int u = 0; u < kScalarSteps; ++u) {
        const int e = e0 + u * kBandThreads;
        if (e < total)
          __stcs(dst + (int64_t)(e / W) * kLanes + e % W, lookup(v[u], e % W));
      }
    }
  }
}

template <int W, bool kPartial = false>
int launch_band(const int* tab, int r_tab, int held, const int* rows,
                int64_t m, int* out, int sms, cudaStream_t st) {
  static bool attr_set = false;
  static int last_smem = -1, last_per_sm = 1;
  const int smem = held * W * 4;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sublane_band_kernel<W, kPartial>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (smem != last_smem) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sublane_band_kernel<W, kPartial>, kBandThreads, smem);
    if (err != cudaSuccess) return (int)err;
    last_per_sm = per_sm > 0 ? per_sm : 1;
    last_smem = smem;
  }
  constexpr int kBands = kLanes / W;
  // the resident blocks, but never fewer rows a block than it stages, nor
  // than 64; and few enough that a block's elements fit an int
  const int64_t min_rows = held > 64 ? held : 64;
  int64_t splits = (int64_t)last_per_sm * sms / kBands;
  const int64_t by_rows = (m + min_rows - 1) / min_rows;
  if (splits > by_rows) splits = by_rows;
  const int64_t by_int = (m * W >> 30) + 1;
  if (splits < by_int) splits = by_int;
  if (splits < 1) splits = 1;
  sublane_band_kernel<W, kPartial><<<(unsigned)(splits * kBands), kBandThreads, smem,
                           st>>>(tab, r_tab, held, rows, m, out, (int)splits);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

}  // namespace

// d, l, out: (rows, 128) int32, row-major, 16-byte aligned device pointers.
// Returns the CUDA error of the launch, or a negative code for arguments the
// kernel does not take.
extern "C" int ldb_lane_gather(const void* d, const void* l, int64_t rows,
                               void* out, int max_blocks, void* stream) {
  if (rows < 1 || max_blocks < 1) return -1;
  if (!aligned16(d, l, out)) return -3;
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > max_blocks) blocks = max_blocks;
  lane_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d), static_cast<const int*>(l), rows,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// tab: (r_tab, 128) int32; rows, out: (m, 128) int32; all row-major and
// 16-byte aligned. sms: the card's multiprocessor count. One kernel
// launch. Same return codes as ldb_lane_gather.
extern "C" int ldb_sublane_gather(const void* tab, int64_t r_tab,
                                  const void* rows, int64_t m, void* out,
                                  int sms, void* stream) {
  if (r_tab < 1 || r_tab > INT32_MAX / kLanes) return -1;
  if (m < 1 || sms < 1) return -2;
  if (!aligned16(tab, rows, out)) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tab);
  const int* r = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  const int r32 = (int)r_tab;
  // the widest power-of-two band of at least kMinBand columns whose
  // (R, W) slice fits a block's shared memory
  int w = kLanes;
  while (w > kMinBand && r_tab > band_rows(w)) w >>= 1;
  if (r_tab > kDirectRows && r_tab <= band_rows(w)) {
    switch (w) {
      case 128: return launch_band<128>(t, r32, r32, r, m, o, sms, st);
      case 64: return launch_band<64>(t, r32, r32, r, m, o, sms, st);
      case 32: return launch_band<32>(t, r32, r32, r, m, o, sms, st);
      case 16: return launch_band<16>(t, r32, r32, r, m, o, sms, st);
      default: return launch_band<8>(t, r32, r32, r, m, o, sms, st);
    }
  }
  // too tall for a band of kMinBand columns: the band's first rows, the
  // rest read from L2, while at least two fifths of the table fit and
  // there are rows enough to give each SM's block (one, at this size) as
  // many rows as it stages
  if (r_tab > kDirectRows && r_tab <= kPartialRows &&
      m * (kLanes / kMinBand) >= (int64_t)sms * kHeldRows)
    return launch_band<kMinBand, true>(t, r32, kHeldRows, r, m, o, sms, st);
  // a table that L1 holds, or too tall for a band: the direct form
  const int64_t quads = m * (kLanes / 4);
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  sublane_direct_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(t, r32, r,
                                                              quads, o);
  return (int)cudaGetLastError();
}

// The tallest table of each form of ldb_sublane_gather, in order: the
// direct form of small tables, whole bands of 128, 64, 32, 16 and 8
// columns, then the partial band of 8 (given rows enough to fill the card;
// it holds as many rows as the band of 8 does). Taller tables take the
// direct form. Writes min(cap, 7) of them to `edges` and returns 7.
extern "C" int ldb_sublane_band_edges(int64_t* edges, int cap) {
  const int64_t all[] = {kDirectRows,   band_rows(128), band_rows(64),
                         band_rows(32), band_rows(16),  band_rows(8),
                         kPartialRows};
  constexpr int kForms = sizeof(all) / sizeof(all[0]);
  for (int i = 0; i < kForms && i < cap; ++i) edges[i] = all[i];
  return kForms;
}
