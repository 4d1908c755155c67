// lane_rotsum: for an (R, 128) int32 array t,
//
//   out[r, j] = t[r, 0] + t[r, 1] + ... + t[r, 127]   for every j,
//
// the sum of the 128 lane rotations of t, which is each row's total in
// every column. Sums wrap in int32.
//
// Replaces two probes of benchtools/tools_kbench.py that compute this one
// function and differ only in the TPU instruction they exercise:
//
//   k_roll  (:118, pallas_call :127)  128 rotations built by concatenation
//   k_roll2 (:141, pallas_call :148)  the same through pltpu.roll
//
// Whichever way a rotation turns, the sum over all 128 of them is the row
// total, so one kernel serves both. The reference's grid of 8 recomputes
// the same output block eight times to lengthen the timing; the port
// computes the function once per call.
//
// Bound on this card: bytes - the array read once and written once (2 MB
// each at R = 4096). That is about 1.3 us of device-memory time, below the
// cost of a launch, so at the reference's shape the kernel is launch-bound.
// One warp per row: each lane loads four values (16 bytes), the lanes
// reduce with five __shfl_xor_sync steps, and each lane writes the total to
// its four columns. Adds are uint32_t (signed overflow is undefined in C++)
// and the total is read back as int32, which is the wrapping int32 add of
// the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
lane_rotsum_kernel(const int* __restrict__ t, int64_t rows,
                   int* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the row loop is the same for every lane of a warp, so the full-mask
  // shuffles are reached by all of them
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < rows;
       r += (int64_t)gridDim.x * kWarps) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(t + r * kLanes) + lane);
    uint32_t s = (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    const int total = (int)s;
    __stcs(reinterpret_cast<int4*>(out + r * kLanes) + lane,
           make_int4(total, total, total, total));
  }
}

}  // namespace

// t, out: (rows, 128) int32, row-major, 16-byte aligned device pointers.
// Returns the CUDA error of the launch, or a negative code for arguments the
// kernel does not take.
extern "C" int ldb_lane_rotsum(const void* t, int64_t rows, void* out,
                               int max_blocks, void* stream) {
  if (rows < 1 || max_blocks < 1) return -1;
  if (((reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    return -3;
  }
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > max_blocks) blocks = max_blocks;
  lane_rotsum_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), rows, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
