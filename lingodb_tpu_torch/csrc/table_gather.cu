// table_gather: out[i] = table[idx[i]] for one int32 table and an int32
// index array of any length n. Two entry points:
//
//   gather_shift  any table up to 2^31 - 1 entries, in one of two forms
//                 chosen by the table's size (below)
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
// aligned; that leaves the 50 MB L2 to the table. gather_small copies its
// table (16 KB at most) into shared memory once per block and serves every
// index of the block's grid-stride walk from there.
//
// gather_shift holds as much of the table in shared memory as a block can:
// a random 4-byte lookup served from L2 costs a whole 32-byte sector, one
// served from shared memory a bank access. Its forms, by the table's size
// S alone (ldb_gather_shift_edges gives the edges, ldb_gather_shift_plan
// the launch):
//
//   staged   S <= 232,432 (kStagedMaxEntries: at least a quarter of the
//            table held). Every block stages the table's first
//            min(S, 58,108) entries (kPartMax: 227 KB less 16 bytes for the
//            staging barrier) in its dynamic shared memory and serves its
//            grid-stride walk from there; a lookup past them is read
//            through the read-only path (__ldg) from L2. Up to 58,108
//            entries the whole table is held: gather_small's form for
//            tables up to a block's whole shared memory. At S = 2^16, 89 %
//            of the lookups are served from shared memory.
//   L2       larger tables (S = 2^21 is 8 MB): every lookup read through
//            the read-only path, four a thread a step.
//
// The staged form launches a persistent grid, as many blocks of 1024
// threads as the card holds at once, so that each block stages once,
// whatever n. A thread loads its first indices before it stages, so the
// index stream is on its way while the table is, and loads each step's
// indices while it serves the last step's. A block stages with
// cp.async.bulk copies into shared memory on an mbarrier where the table
// is 16-byte aligned (kStageBulk), else with 4-byte loads. On an H100
// (tools/design_sweep.py): at S = 2^16 the staged form reads 0.019 ms at
// n = 6M and 0.18 at 60M against 0.035 and 0.32 from L2; at S = 2^18 it
// is level with the L2 form, past it slower. Staging alone costs 0.004 ms
// a call (n = 4,096; 16-byte loads 0.005), about what the L2 form saves on
// 700K lookups at S = 2^16.
//
// Tried and not kept (times from tools/design_sweep.py on an H100; the
// source of these forms is gone):
//   - The table split over a thread block cluster of C = 2, 4 or 8 blocks,
//     each block staging 1/C of it, each lookup read from the owning block
//     through distributed shared memory (mapa, ld.shared::cluster), with
//     cluster.sync() after staging and before exit. Random 4-byte reads of
//     another block's shared memory are slower than the L2 sectors they
//     save: at S = 2^16, 6M, 0.046 ms on clusters of 2 and 0.085 on 4 or
//     8, against 0.035 from L2.
//   - Eight or sixteen lookups a thread a step in the L2 form, and eight in
//     the staged form: no faster than four.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallMax = 4096;

// gather_shift's design constants (tools/design_sweep.py rewrites them)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
constexpr int kPartMax = (kMaxSmem - 16) / 16 * 4;  // entries a block stages
constexpr int kStagedMaxEntries = 4 * kPartMax;  // the staged form's tallest
constexpr int kStagedThreads = 1024;
constexpr bool kStageBulk = true;  // stage by cp.async.bulk, else by loads
constexpr int kBulkChunk = 16384;  // bytes a bulk copy

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

// The table's first `held` entries in shared memory, the rest read through
// the read-only path (none where held == s).
struct StagedTable {
  const int* staged;
  int held;
  const int* t;
  int s;
  __device__ __forceinline__ int operator()(int i) const {
    const int j = clamp_index(i, s);
    return j < held ? staged[j] : __ldg(t + j);
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

// int4 i of the index stream, or zeros past its n4 int4
__device__ __forceinline__ int4 load_vec(const int4* __restrict__ idx4,
                                         int64_t i, int64_t n4) {
  return i < n4 ? __ldcs(idx4 + i) : make_int4(0, 0, 0, 0);
}

// gather_stream with the next step's indices loaded while this step's are
// served; `v` holds the first step's (loaded by the caller where `vec`).
template <class Table>
__device__ __forceinline__ void gather_walk(const Table& tab, int4 v,
                                            const int* __restrict__ idx,
                                            int64_t n, int* __restrict__ out,
                                            bool vec, int64_t first,
                                            int64_t stride) {
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      const int4 next = load_vec(idx4, i + stride, n4);
      int4 r;
      r.x = tab(v.x);
      r.y = tab(v.y);
      r.z = tab(v.z);
      r.w = tab(v.w);
      __stcs(out4 + i, r);
      v = next;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    __stcs(out + i, tab(__ldcs(idx + i)));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `count` entries of src into shared dst: by cp.async.bulk copies that
// thread 0 issues on the barrier at `bar` where `bulk` (src and dst 16-byte
// aligned), else by loads, 16 bytes a thread where `aligned`. On return
// the block's threads may read all of dst.
__device__ __forceinline__ void stage_part(int* dst, const int* __restrict__ src,
                                           int count, bool bulk, bool aligned,
                                           uint64_t* bar) {
  int done = 0;
  const uint32_t b = smem_addr(bar);
  if (bulk) {
    done = count & ~3;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(b), "r"(done * 4) : "memory");
      for (int e = 0; e < done; e += kBulkChunk / 4) {
        const int len = min(kBulkChunk / 4, done - e);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            ::"r"(smem_addr(dst + e)),
              "l"(reinterpret_cast<uint64_t>(src + e)), "r"(len * 4), "r"(b)
            : "memory");
      }
    }
  } else if (aligned) {
    const int q = count >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int e = threadIdx.x; e < q; e += 4 * kStagedThreads) {
      int4 t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u * kStagedThreads < q) t[u] = __ldcg(s4 + e + u * kStagedThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u * kStagedThreads < q) d4[e + u * kStagedThreads] = t[u];
    }
    done = q << 2;
  }
  for (int e = done + threadIdx.x; e < count; e += kStagedThreads)
    dst[e] = __ldcg(src + e);
  if (bulk) {
    __syncthreads();  // the barrier is initialised before anyone waits on it
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(b) : "memory");
  }
}

// The L2 form: the table read through the read-only path.
__global__ void __launch_bounds__(kThreads)
gather_shift_kernel(const int* __restrict__ table, int s,
                    const int* __restrict__ idx, int64_t n,
                    int* __restrict__ out, bool vec) {
  gather_stream(GlobalTable{table, s}, idx, n, out, vec);
}

// The staged form: each block stages the table's first `held` entries into
// dynamic shared memory, the staging barrier after them, then walks the
// index stream.
__global__ void __launch_bounds__(kStagedThreads)
gather_staged_kernel(const int* __restrict__ table, int s, int held,
                     const int* __restrict__ idx, int64_t n,
                     int* __restrict__ out, bool vec) {
  extern __shared__ __align__(16) int staged[];
  const int64_t first = (int64_t)blockIdx.x * kStagedThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kStagedThreads;
  // the first indices are on their way while the table is staged
  const int4 v = load_vec(reinterpret_cast<const int4*>(idx), first,
                          vec ? n >> 2 : 0);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  stage_part(staged, table, held, kStageBulk && aligned, aligned,
             reinterpret_cast<uint64_t*>(staged + ((held + 3) & ~3)));
  __syncthreads();
  gather_walk(StagedTable{staged, held, table, s}, v, idx, n, out, vec, first,
              stride);
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

// gather_shift's launch for one call
struct Plan {
  int form;    // 1 staged, 2 L2
  int held;    // entries a block stages (0 in the L2 form)
  int smem;    // dynamic shared memory a block, bytes
  int blocks;  // the grid
};

// The launch for a table of s entries and n indices: the form by s alone;
// the staged form's grid is as many blocks as the current device holds at
// once, asked of the runtime at every call (its shared-memory attribute is
// set on the current device first).
int make_plan(int64_t s, int64_t n, bool vec, int max_blocks, Plan* p) {
  if (s > kStagedMaxEntries) {
    *p = Plan{2, 0, 0, (int)grid_for(n, vec, max_blocks)};
    return 0;
  }
  const int held = s < kPartMax ? (int)s : kPartMax;
  *p = Plan{1, held, ((held + 3) & ~3) * 4 + 16, 0};  // entries, barrier
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      gather_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_staged_kernel, kStagedThreads, p->smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p->blocks = per_sm * sms;
  return 0;
}

}  // namespace

// table: s int32 entries; idx, out: n int32 entries (device pointers).
// `max_blocks` caps the grid of the L2 form (the caller passes a small
// multiple of the SM count). One kernel launch, in the form that s selects.
// Returns the CUDA error of the launch (or of the occupancy query before
// it), or a negative code for arguments the kernel does not take.
extern "C" int ldb_gather_shift(const void* table, int64_t s, const void* idx,
                                int64_t n, void* out, int max_blocks,
                                void* stream) {
  if (s < 1 || s > INT32_MAX) return -1;
  if (n < 1 || max_blocks < 1) return -2;
  const bool vec = aligned16(idx, out);
  Plan p;
  const int err = make_plan(s, n, vec, max_blocks, &p);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* i = static_cast<const int*>(idx);
  int* o = static_cast<int*>(out);
  if (p.form == 1) {
    gather_staged_kernel<<<(unsigned)p.blocks, kStagedThreads, p.smem, st>>>(
        t, (int)s, p.held, i, n, o, vec);
  } else {
    gather_shift_kernel<<<(unsigned)p.blocks, kThreads, 0, st>>>(
        t, (int)s, i, n, o, vec);
  }
  return (int)cudaGetLastError();
}

// The edges of ldb_gather_shift's forms: edges[0] the tallest table the
// staged form holds whole, edges[1] the tallest it takes; taller tables
// take the L2 form. Writes min(cap, 2) of them and returns 2.
extern "C" int ldb_gather_shift_edges(int64_t* edges, int cap) {
  const int64_t all[2] = {kPartMax, kStagedMaxEntries};
  for (int i = 0; i < 2 && i < cap; ++i) edges[i] = all[i];
  return 2;
}

// The launch that ldb_gather_shift makes for s and n with 16-byte aligned
// idx and out: info[0] the form (1 staged, 2 L2), info[1] entries a block
// stages, info[2] blocks in the grid, info[3] dynamic shared memory a block
// in bytes, info[4] threads a block. Returns as ldb_gather_shift.
extern "C" int ldb_gather_shift_plan(int64_t s, int64_t n, int max_blocks,
                                     int64_t* info) {
  if (s < 1 || s > INT32_MAX) return -1;
  if (n < 1 || max_blocks < 1) return -2;
  Plan p;
  const int err = make_plan(s, n, true, max_blocks, &p);
  if (err) return err;
  info[0] = p.form;
  info[1] = p.held;
  info[2] = p.blocks;
  info[3] = p.smem;
  info[4] = p.form == 1 ? kStagedThreads : kThreads;
  return 0;
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
