// compact_positions: ascending int32 positions of a mask's set bytes, plus the
// exact count of set bytes.
//
// Replaces the TPU kernel `_compact_positions_kernel` / wrapper
// `compact_positions` of lingodb_tpu/ops/pgather.py. That kernel walks its
// grid in order and carries the running output offset in on-chip scratch from
// one grid step to the next. Thread blocks on an NVIDIA GPU run in no order,
// so the carry goes through device memory instead: one pass over the mask
// with decoupled look-back, the scheme of segscan.cu.
//
//   - Tiles of 4096 V mask bytes, 16 V a thread read with V 16-byte loads:
//     V = 1 below 2^20 rows, 2 below 2^22, 4 from there (larger tiles where
//     there are enough of them to fill the card; fewer tiles, fewer
//     look-back steps). A block takes its tile number from an atomic
//     counter, not from blockIdx, and loops until the tiles run out: every
//     tile it waits for was taken by a block that is running, and that block
//     waits only for tiles before its own, so the look-back always makes
//     progress, whatever the grid size and however many blocks are resident.
//     The grid is sized to the blocks the card holds at once.
//   - A block takes its next tile and issues that tile's loads before it
//     looks back for the current one, so the loads are in flight while it
//     waits. Ranks inside the tile are a block exclusive scan over per-thread
//     popcounts (warp shuffles, one shared-memory hop).
//   - Each tile has one 64-bit status word, (epoch << 34) | (status << 32)
//     | count, status 1 aggregate (the tile's own count), 2 inclusive (the
//     count of every tile up to and including it), stored and read whole,
//     relaxed at device scope (st/ld.relaxed.gpu): a word carries its own
//     value, so no order with any other access is needed. A word reads as
//     ready only with this call's epoch and a status. A block publishes its
//     aggregate at once, stages the tile's positions in shared memory, then
//     all its threads look back over 256 predecessors a step (a warp's 32 a
//     step left the first wave of blocks walking back one L2 round trip per
//     32 tiles) until they meet an inclusive word, and it publishes the
//     tile's inclusive word. The staged positions then go to out[prefix +
//     rank] with 16-byte stores; slots at or past k are dropped. Rank i is
//     staged at i + i / 32: a thread's ranks are consecutive, so without the
//     gap the lanes of a warp whose rows are half set store to one bank.
//   - The block that holds the last tile writes the exact count, also when
//     it exceeds k.
//   - The sentinel tail [count, k) needs the total, which only the last tile
//     knows. Of the three ways (a second launch over k that reads the count;
//     a persistent grid whose blocks wait for the last tile's word; another
//     way) this takes the second: when a block finds no tile left, every
//     tile has been taken by a running block, so the last tile's inclusive
//     word will come; the block waits for it and fills its share of the
//     tail with 16-byte stores. No second launch, and no deadlock with a
//     grid larger than what is resident, since nothing waits for the total
//     before the tile counter has run out.
//   - No status word of an earlier call may read as ready, and the tile
//     counter must start at zero. Both live in a scratch buffer that the
//     caller keeps for each stream and thread (or a CUDA graph keeps for
//     its replays): word 0 holds the call number (the epoch, from 1, below
//     2^30) in its low half and the tile counter in its high half, then one
//     status word a tile. The numbering is the card's own: each call is a
//     one-thread-block prologue launch, then the main launch, on one stream.
//     The prologue bumps the call number and zeroes the tile counter; the
//     main kernel reads its epoch from the word. A word of an earlier call
//     carries an earlier epoch. When the number wraps (2^30 - 1 calls) the
//     prologue zeroes every status word first, since a word that old could
//     carry any number. Nothing is counted on the host, so a CUDA graph can
//     hold both launches: each replay runs the prologue again and gets a
//     new number and a zeroed counter. A buffer is zeroed when it is made
//     (number 0); a call that fails leaves it consistent, since the next
//     prologue numbers and zeroes again. The prologue is a launch of its
//     own (about a kernel's launch gap on the card, PERF.md) rather than a
//     clean-up by the last block to finish, which would need a fence and an
//     atomic at the end of every block.
//
// No atomics on the data: the output is bit-equal to numpy.flatnonzero for
// every run.
//
// Bound on this card: bytes - the mask (1 byte a row) read once, 4 bytes
// written per output slot. What is left to it is not the writes: on an
// H100 (tools/design_sweep.py) a call with k = 0, which writes no
// position, takes 0.0102 of the 0.0119 ms at 6M rows and half of them set,
// and at 60M rows the writes add about their own bound to a read, count
// and look-back phase that runs at about a quarter of the memory's rate.
// The tile sizes (kMidRows, kWideRows) are the fastest of 4, 8 and 16 KB
// at each mask length that sweep times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 2147483646;
constexpr uint32_t kAggregate = 1u;  // the status in a word's low 2 bits
constexpr uint32_t kInclusive = 2u;  // of its upper half, above them the epoch
constexpr int64_t kMidRows = 1 << 20;  // from here tiles of 8192 bytes
constexpr int64_t kWideRows = 4 << 20;  // from here tiles of 16384 bytes

// V 16-byte mask loads a thread: 16 V rows, at most 64 (one flag bit a
// row), and a tile of 4096 V mask bytes.
template <int V>
struct Tile {
  static constexpr int kPerThread = 16 * V;
  static constexpr int kBytes = kThreads * kPerThread;
  // a tile's positions, staged at i + i / 32 (see compact_kernel)
  static constexpr int kStagedBytes = 4 * (kBytes + kBytes / 32);
};

// One thread's mask bytes, as loaded.
template <int V>
struct Raw {
  uint4 v[V];
};

template <int V>
__device__ __forceinline__ void load_raw(const uint8_t* __restrict__ mask,
                                         int64_t base, int64_t n, Raw<V>& raw) {
  constexpr int kPer = Tile<V>::kPerThread;
  if (base + kPer <= n) {
#pragma unroll
    for (int x = 0; x < V; ++x)
      raw.v[x] = __ldcs(reinterpret_cast<const uint4*>(mask + base) + x);
  } else {  // the ragged end of the mask
    uint32_t* w = reinterpret_cast<uint32_t*>(raw.v);
    for (int q = 0; q < 4 * V; ++q) w[q] = 0u;
    for (int j = 0; j < kPer && base + j < n; ++j)
      w[j >> 2] |= (uint32_t)(mask[base + j] != 0) << (8 * (j & 3));
  }
}

// bit j set iff byte j of the thread's rows is not 0: per 32-bit word,
// one bit a byte (0x01 where the byte is not 0), gathered into the top
// nibble by one multiply (the products' other terms land below bit 24)
template <int V>
__device__ __forceinline__ uint64_t flags(const Raw<V>& raw) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(raw.v);
  uint64_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4 * V; ++q) {
    const uint32_t ones = __vcmpne4(w[q], 0u) & 0x01010101u;
    bits |= (uint64_t)((ones * 0x10204080u) >> 28) << (4 * q);
  }
  return bits;
}

// Exclusive prefix sum of `v` over the block's threads; `total` gets the
// block-wide sum. `warp_sums` is shared scratch of kWarps ints.
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
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  return before + incl - v;
}

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

// A status word: (epoch << 34) | (status << 32) | count.
__device__ __forceinline__ unsigned long long make_word(uint32_t epoch,
                                                        uint32_t status,
                                                        uint32_t value) {
  return ((unsigned long long)((epoch << 2) | status) << 32) | value;
}

// The status of a word written in this call (0: not yet, or an earlier
// call's).
__device__ __forceinline__ uint32_t status_of(unsigned long long word,
                                              uint32_t epoch) {
  const uint32_t hi = (uint32_t)(word >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : 0u;
}

// All threads: the count of set bytes in the tiles before `tile`, from
// their status words, kThreads predecessors a step: thread j reads the word
// of tile top - j. Every thread returns the same value.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* state,
                                              int tile, uint32_t epoch,
                                              int* sh_near, uint32_t* sh_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t prefix = 0u;
  for (int top = tile - 1;; top -= kThreads) {
    const int t = top - (int)threadIdx.x;
    uint32_t status = kInclusive, value = 0u;  // before tile 0: the identity
    if (t >= 0) {
      unsigned long long word;
      do {
        word = load_word(state + t);
        status = status_of(word, epoch);
      } while (status == 0u);
      value = (uint32_t)word;
    }
    const unsigned inc = __ballot_sync(0xffffffffu, status == kInclusive);
    if (lane == 0) sh_near[warp] = inc ? warp * 32 + __ffs(inc) - 1 : kThreads;
    __syncthreads();
    int nearest = kThreads;  // the nearest inclusive word of this step
#pragma unroll
    for (int w = 0; w < kWarps; ++w) nearest = min(nearest, sh_near[w]);
    // the nearest inclusive word, and the aggregates after it
    uint32_t v = (int)threadIdx.x <= nearest ? value : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (lane == 0) sh_sum[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) prefix += sh_sum[w];
    if (nearest < kThreads) return prefix;
  }
}

// The number of a call wraps to 1 after kEpochs - 1: it fits the 30 bits a
// status word keeps above its status.
constexpr uint32_t kEpochs = 1u << 30;

// The prologue of a call, one block launched just before compact_kernel on
// the same stream: the next call number into scratch word 0's low half, the
// tile counter (its high half) zeroed, and, when the number wraps, every
// one of the `words` status words zeroed first (a word written 2^30 - 1
// calls ago may carry any number). A new buffer is all zero: number 0.
__global__ void __launch_bounds__(kThreads)
compact_prologue(unsigned* __restrict__ scratch, int64_t words) {
  const uint32_t last = scratch[0];  // read by every thread before the write
  const uint32_t epoch = last % (kEpochs - 1u) + 1u;
  if (epoch == 1u && last != 0u) {
    auto* state = reinterpret_cast<unsigned long long*>(scratch + 2);
    for (int64_t w = threadIdx.x; w < words; w += kThreads) state[w] = 0ull;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    scratch[0] = epoch;
    scratch[1] = 0u;
  }
}

// scratch: the call number and the tile counter (both set by the
// prologue), then one status word a tile. The status words carry the
// number, so a word of an earlier call never reads as ready.
template <int V>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask, int64_t n, int num_tiles,
               int* __restrict__ out, int64_t k, int* __restrict__ count,
               unsigned* __restrict__ scratch) {
  constexpr int kPer = Tile<V>::kPerThread;
  constexpr int kTile = Tile<V>::kBytes;
  extern __shared__ int staged[];
  __shared__ int warp_sums[kWarps];
  __shared__ int sh_near[kWarps];
  __shared__ uint32_t sh_sum[kWarps];
  __shared__ int sh_next;
  __shared__ int64_t sh_total;  // the exact count, once this block knows it
  const uint32_t epoch = scratch[0];
  unsigned* counter = scratch + 1;
  auto* state = reinterpret_cast<unsigned long long*>(scratch + 2);
  const bool solo = gridDim.x == 1;  // walks the tiles in order by itself
  if (threadIdx.x == 0) {
    sh_total = -1;
    sh_next = solo ? 0 : (int)atomicAdd(counter, 1u);
  }
  __syncthreads();
  int tile = sh_next;
  Raw<V> raw;
  if (tile < num_tiles)
    load_raw<V>(mask, (int64_t)tile * kTile + threadIdx.x * kPer, n, raw);

  while (tile < num_tiles) {
    // the next tile is taken now, and its loads are issued before this
    // tile's look-back, so that they are in flight while it waits
    if (threadIdx.x == 0) sh_next = solo ? tile + 1 : (int)atomicAdd(counter, 1u);
    const int64_t base = (int64_t)tile * kTile + threadIdx.x * kPer;
    const uint64_t bits = flags<V>(raw);
    int total;
    const int excl = block_exclusive_scan(__popcll(bits), warp_sums, &total);
    const int next = sh_next;  // the scan's barriers published it
    if (next < num_tiles)
      load_raw<V>(mask, (int64_t)next * kTile + threadIdx.x * kPer, n, raw);
    unsigned long long* mine = state + tile;
    if (threadIdx.x == 0 && tile > 0)
      store_word(mine, make_word(epoch, kAggregate, (uint32_t)total));
    // ranks are dense inside the tile: stage the tile's positions in shared
    // memory before the look-back. Rank i goes to i + i / 32: a thread's
    // ranks are consecutive, so unpadded, the lanes of a warp whose rows
    // are half set would all store to one bank at each step
    int r = excl;
    uint64_t rest = bits;
    while (rest) {
      const int j = __ffsll(rest) - 1;
      rest &= rest - 1;
      staged[r + (r >> 5)] = (int)(base + j);
      ++r;
    }
    // the look-back's barriers also order the staging before the writes
    const uint32_t prefix =
        tile > 0 ? look_back(state, tile, epoch, sh_near, sh_sum) : 0u;
    if (threadIdx.x == 0) {
      store_word(mine, make_word(epoch, kInclusive, prefix + (uint32_t)total));
      if (tile == num_tiles - 1) {
        sh_total = (int64_t)prefix + total;
        *count = (int)(prefix + (uint32_t)total);
      }
    }
    if (tile == 0) __syncthreads();  // no look-back: order the staging
    // the tile's positions to out[prefix, prefix + total): the slots before
    // the first 16-byte boundary one by one, then four at a time
    const int64_t first = prefix;
    const int head = min((int)((4 - (first & 3)) & 3), total);
    if ((int)threadIdx.x < head && first + threadIdx.x < k)
      out[first + threadIdx.x] = staged[threadIdx.x];
    for (int i = head + 4 * (int)threadIdx.x; i < total; i += 4 * kThreads) {
      const int64_t s = first + i;
      if (i + 3 < total && s + 3 < k) {
        const int4 q = make_int4(staged[i + (i >> 5)],
                                 staged[i + 1 + ((i + 1) >> 5)],
                                 staged[i + 2 + ((i + 2) >> 5)],
                                 staged[i + 3 + ((i + 3) >> 5)]);
        *reinterpret_cast<int4*>(out + s) = q;
      } else {
        for (int c = 0; c < 4 && i + c < total && s + c < k; ++c)
          out[s + c] = staged[i + c + ((i + c) >> 5)];
      }
    }
    tile = next;
  }

  // the sentinel tail [count, k): every tile has been taken, so the last
  // tile's inclusive word will come
  if (threadIdx.x == 0 && sh_total < 0) {
    unsigned long long word;
    do {
      word = load_word(state + num_tiles - 1);
    } while (status_of(word, epoch) != kInclusive);
    sh_total = (uint32_t)word;
  }
  __syncthreads();
  const int64_t start = sh_total;
  if (start >= k) return;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t q0 = (start + 3) >> 2, q1 = k >> 2;  // whole quads of slots
  if (q0 >= q1) {
    for (int64_t s = start + gtid; s < k; s += stride) out[s] = kSentinel;
    return;
  }
  if (gtid < 4 * q0 - start) out[start + gtid] = kSentinel;
  if (gtid < k - 4 * q1) out[4 * q1 + gtid] = kSentinel;
  const int4 fill = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
  for (int64_t q = q0 + gtid; q < q1; q += stride)
    reinterpret_cast<int4*>(out)[q] = fill;
}

// The blocks the card holds at once (0 on an error).
template <int V>
int resident_blocks() {
  static int per_sm = 0;
  if (!per_sm) {
    if (cudaFuncSetAttribute(compact_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<V>::kStagedBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, compact_kernel<V>, kThreads,
            Tile<V>::kStagedBytes) != cudaSuccess)
      return 0;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <int V>
int launch(const uint8_t* mask, int64_t n, int* out, int64_t k, int* count,
           unsigned* scratch, int64_t words, cudaStream_t st) {
  const int num_tiles = (int)((n + Tile<V>::kBytes - 1) / Tile<V>::kBytes);
  int grid = resident_blocks<V>();
  if (grid < 1) return -4;
  if (grid > num_tiles) grid = num_tiles;
  compact_prologue<<<1, kThreads, 0, st>>>(scratch, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_kernel<V><<<grid, kThreads, Tile<V>::kStagedBytes, st>>>(
      mask, n, num_tiles, out, k, count, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// mask: n bytes, 16-byte aligned, 1 <= n < 2^31 - 1. out: k int32 slots,
// 16-byte aligned. count: one int32, always written. scratch:
// scratch_bytes >= 8 + 8 * ceil(n / ldb_compact_tile()), 8-byte aligned,
// zeroed when it was made, and used by one stream at a time: calls in
// order, each a prologue launch and the main launch, nothing counted on
// the host (a CUDA graph may hold both launches). Returns the CUDA error
// (0 = none), or a negative code for arguments it does not take.
extern "C" int ldb_compact_positions(const void* mask, int64_t n, void* out,
                                     int64_t k, void* count, void* scratch,
                                     int64_t scratch_bytes, void* stream) {
  if (n < 1 || n >= 2147483647 || k < 0) return -1;
  if ((reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return -2;
  const int64_t tiles = (n + Tile<1>::kBytes - 1) / Tile<1>::kBytes;
  if ((reinterpret_cast<uintptr_t>(scratch) & 7) ||
      scratch_bytes < 8 + 8 * tiles)
    return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned*>(scratch);
  const int64_t status_words = scratch_bytes / 8 - 1;
  const auto* m = static_cast<const uint8_t*>(mask);
  int* o = static_cast<int*>(out);
  int* c = static_cast<int*>(count);
  // larger tiles where there are enough of them to fill the card
  if (n >= kWideRows) return launch<4>(m, n, o, k, c, words, status_words, st);
  if (n >= kMidRows) return launch<2>(m, n, o, k, c, words, status_words, st);
  return launch<1>(m, n, o, k, c, words, status_words, st);
}

// Mask bytes per tile of the smallest tile: the caller sizes `scratch`
// from it.
extern "C" int ldb_compact_tile() { return Tile<1>::kBytes; }
