// onehot_compact: per tile of 256 rows of two (tiles x 256, 128) int32
// arrays x and m,
//
//   out[a, j] = sum of x[p, j] * m[p, j] over the rows p of the tile with
//               c[p] = a,   a = 0 .. 255,
//
// where c is the inclusive running sum of lane 0 of m down the tile. A slot
// that no row reaches is 0; rows with c[p] = 256 (lane 0 set in all 256 rows
// of the tile, the last row) reach no slot and are dropped; rows before
// lane 0's first set bit have c[p] = 0 and go to slot 0.
//
// Replaces the probe k_mm of benchtools/tools_kbench.py (:209, pallas_call
// :220), a within-tile compaction written as a matrix product for the TPU's
// matrix unit: it forms the one-hot (256 x 256) fp32 matrix P[a, p] =
// (c[p] = a) and multiplies it with x * m. Domain, as the reference
// generates: m in {0, 1} and 0 <= x < 2^15. There every sum of at most 256
// products is below 2^23, so the fp32 product is exact, and int32
// arithmetic here gives the reference's result bit for bit. Not routed
// through tensor cores: TF32 keeps 10 mantissa bits and would round x.
//
// Because c is nondecreasing, the product is a segmented column sum: the
// rows of one slot are consecutive. One block per tile (grid-stride over
// tiles) with one thread per column:
//   1. the 128 threads load lane 0 of the tile's 256 rows (two each) and
//      scan them (warp __shfl_up_sync steps, one shared-memory hop across
//      the four warps) into c[] in shared memory;
//   2. thread j walks the 256 rows down column j, coalesced across the
//      block, adds x * m as uint32_t, and at the end of each run of equal
//      slot writes the sum at that slot and zeros at the slots it skipped.
// The run boundaries depend on the row only, so every thread of the block
// branches alike.
//
// Bound on this card: bytes - x and m read once, out written once (12 bytes
// an element); the operations (one multiply-add an element) are far below
// the card's integer rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;
constexpr int kLanes = 128;
constexpr int kThreads = kLanes;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
onehot_compact_kernel(const int* __restrict__ x, const int* __restrict__ m,
                      int64_t tiles, int* __restrict__ out) {
  __shared__ int slot[kTileRows];
  __shared__ int warp_total[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * kTileRows * kLanes;
    // 1. c[p] for rows 2t and 2t + 1
    const int m0 = __ldg(m + base + (int64_t)(2 * t) * kLanes);
    const int m1 = __ldg(m + base + (int64_t)(2 * t + 1) * kLanes);
    int incl = m0 + m1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
    const int excl = before + incl - m0 - m1;
    slot[2 * t] = excl + m0;
    slot[2 * t + 1] = excl + m0 + m1;
    __syncthreads();
    // 2. column t, run by run
    const int* xc = x + base + t;
    const int* mc = m + base + t;
    int* oc = out + base + t;
    uint32_t acc = 0;
    int next = 0;  // the lowest slot not yet written
    for (int p = 0; p < kTileRows; ++p) {
      acc += (uint32_t)__ldcs(xc + p * kLanes) * (uint32_t)__ldcs(mc + p * kLanes);
      const int a = slot[p];
      if (p == kTileRows - 1 || slot[p + 1] != a) {
        for (; next < a && next < kTileRows; ++next) __stcs(oc + next * kLanes, 0);
        if (a >= 0 && a < kTileRows) {
          __stcs(oc + a * kLanes, (int)acc);
          next = a + 1;
        }
        acc = 0;
      }
    }
    for (; next < kTileRows; ++next) __stcs(oc + next * kLanes, 0);
    __syncthreads();  // slot[] and warp_total[] are rewritten for the next tile
  }
}

}  // namespace

// x, m, out: (tiles * 256, 128) int32, row-major device pointers. Returns
// the CUDA error of the launch, or a negative code for arguments the kernel
// does not take.
extern "C" int ldb_onehot_compact(const void* x, const void* m, int64_t tiles,
                                  void* out, int max_blocks, void* stream) {
  if (tiles < 1 || max_blocks < 1) return -1;
  int64_t blocks = tiles < max_blocks ? tiles : max_blocks;
  onehot_compact_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(m), tiles,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
