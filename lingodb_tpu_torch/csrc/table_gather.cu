// table_gather: out[i] = table[idx[i]] for one int32 table and an int32
// index array of any length n. Two kernels, one per table size:
//
//   gather_shift  any table up to 2^31 - 1 entries, read from device memory
//   gather_small  tables of at most 4096 entries, staged in shared memory
//
// Replaces the TPU kernels of benchtools/tools_pallas_gather.py:
//
//   pallas_gather_shift (:42, pallas_call :75)  The TPU's vector unit can
//       gather only along one axis of an equal-shaped tile, so the kernel
//       keeps the whole table (padded to a multiple of 1024) in VMEM as
//       (S/128, 128) rows and makes 128 rolled row gathers per tile, keeping
//       for each element the one whose lane matches.
//   pallas_gather_small (:89, pallas_call :120)  One lane gather per
//       128-entry chunk of the table, selected by the index's high bits.
//
// A GPU thread addresses memory element by element, so neither trick is
// needed: each thread reads table[idx] itself. Neither output is padded: it
// has exactly n entries. The contract is 0 <= idx < S, as both reference
// scripts generate; an index outside it is clamped to [0, S - 1] so that no
// read leaves the table (the reference leaves such indices undefined).
//
// Bound on this card: bytes - 4 per index read, 4 per output written, and
// the table read once (8 MB at S = 2^21). The index stream and the output
// are touched once, so they are loaded and stored with the streaming
// (evict-first) cache hint and 16 bytes a thread where both are 16-byte
// aligned; that leaves the 50 MB L2 to the table. gather_shift reads the
// table through the read-only path (__ldg): at S = 2^21 it is far over the
// 227 KB of shared memory a block may hold, and random indices then cost
// L2 hits (or device-memory sectors, where the table falls out of L2)
// rather than coalesced bytes. gather_small copies its table (16 KB at
// most) into shared memory once per block and serves every index of the
// block's grid-stride walk from there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallMax = 4096;

__device__ __forceinline__ int clamp_index(int i, int s) {
  return min(max(i, 0), s - 1);
}

struct GlobalTable {
  const int* t;
  int s;
  __device__ __forceinline__ int operator()(int i) const {
    return __ldg(t + clamp_index(i, s));
  }
};

struct SharedTable {
  const int* t;
  int s;
  __device__ __forceinline__ int operator()(int i) const {
    return t[clamp_index(i, s)];
  }
};

// Grid-stride walk over the index stream: four indices a thread per step
// through int4 loads and stores where `vec`, then the ragged tail (and
// everything, where not `vec`) one index a thread.
template <class Table>
__device__ __forceinline__ void gather_stream(const Table& tab,
                                              const int* __restrict__ idx,
                                              int64_t n, int* __restrict__ out,
                                              bool vec) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      const int4 v = __ldcs(idx4 + i);
      int4 r;
      r.x = tab(v.x);
      r.y = tab(v.y);
      r.z = tab(v.z);
      r.w = tab(v.w);
      __stcs(out4 + i, r);
    }
    done = n4 << 2;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    __stcs(out + i, tab(__ldcs(idx + i)));
  }
}

__global__ void __launch_bounds__(kThreads)
gather_shift_kernel(const int* __restrict__ table, int s,
                    const int* __restrict__ idx, int64_t n,
                    int* __restrict__ out, bool vec) {
  gather_stream(GlobalTable{table, s}, idx, n, out, vec);
}

__global__ void __launch_bounds__(kThreads)
gather_small_kernel(const int* __restrict__ table, int s,
                    const int* __restrict__ idx, int64_t n,
                    int* __restrict__ out, bool vec) {
  __shared__ int staged[kSmallMax];
  for (int e = threadIdx.x; e < s; e += kThreads) staged[e] = table[e];
  __syncthreads();
  gather_stream(SharedTable{staged, s}, idx, n, out, vec);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

unsigned grid_for(int64_t n, bool vec, int max_blocks) {
  const int64_t items = vec ? (n + 3) / 4 : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return (unsigned)blocks;
}

}  // namespace

// table: s int32 entries; idx, out: n int32 entries (device pointers).
// `max_blocks` caps the grid (the caller passes a small multiple of the SM
// count). Returns the CUDA error of the launch, or a negative code for
// arguments the kernel does not take.
extern "C" int ldb_gather_shift(const void* table, int64_t s, const void* idx,
                                int64_t n, void* out, int max_blocks,
                                void* stream) {
  if (s < 1 || s > INT32_MAX) return -1;
  if (n < 1 || max_blocks < 1) return -2;
  const bool vec = aligned16(idx, out);
  gather_shift_kernel<<<grid_for(n, vec, max_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), (int)s, static_cast<const int*>(idx), n,
      static_cast<int*>(out), vec);
  return (int)cudaGetLastError();
}

// As ldb_gather_shift, for 1 <= s <= 4096.
extern "C" int ldb_gather_small(const void* table, int64_t s, const void* idx,
                                int64_t n, void* out, int max_blocks,
                                void* stream) {
  if (s < 1 || s > kSmallMax) return -1;
  if (n < 1 || max_blocks < 1) return -2;
  const bool vec = aligned16(idx, out);
  gather_small_kernel<<<grid_for(n, vec, max_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), (int)s, static_cast<const int*>(idx), n,
      static_cast<int*>(out), vec);
  return (int)cudaGetLastError();
}
