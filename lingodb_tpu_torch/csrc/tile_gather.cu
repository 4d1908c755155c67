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
// table is streamed once with 16-byte loads and stores under the streaming
// cache hint. lane_gather gives each 128-wide row to one warp: each lane
// loads four values of d into a 512-byte row buffer in shared memory (the
// card's counterpart of a vector register's lanes), and each lane then
// reads its four outputs from the buffer by l. sublane_gather reads the
// table through the read-only path (__ldg) and lets L2 hold it: 4 KB at
// R = 8, 8 MB at R = 16,384, both well inside the 50 MB L2. The four
// neighbouring columns a thread serves lie in four different table rows,
// so those reads do not coalesce; that is where it can lose to the bound.

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
sublane_gather_kernel(const int* __restrict__ tab, int r_tab,
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

// tab: (r_tab, 128) int32; rows, out: (m, 128) int32; all row-major,
// rows and out 16-byte aligned. Same return codes as ldb_lane_gather.
extern "C" int ldb_sublane_gather(const void* tab, int64_t r_tab,
                                  const void* rows, int64_t m, void* out,
                                  int max_blocks, void* stream) {
  if (r_tab < 1 || r_tab > INT32_MAX / kLanes) return -1;
  if (m < 1 || max_blocks < 1) return -2;
  if (!aligned16(tab, rows, out)) return -3;
  const int64_t quads = m * (kLanes / 4);
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  sublane_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), (int)r_tab, static_cast<const int*>(rows),
      quads, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
