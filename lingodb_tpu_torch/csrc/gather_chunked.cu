// gather_chunked (K1): up to 8 planes of one SMALL table (s <= 16,384
// entries) gathered at one index array of any length and order:
// out[p][i] = plane[p][clamp(idx[i], 0, s - 1)], planes of 1, 2, 4 or 8
// bytes each (csrc/gather_planes.cuh).
//
// Replaces the TPU kernel `_gather_chunked_i32` / wrapper
// `gather_chunked_planes` of lingodb_tpu/ops/pgather.py, which has no
// addressable gather wider than one vector register and therefore compares
// every index against every 128-entry chunk of the table. On an NVIDIA GPU
// shared memory is addressable per thread, so the table is loaded into it
// once per block and indexed.
//
// Bound on this card: bytes - 4 per index read and the planes' widths per
// row written; the tables (at most 16,384 x 8 x 8 bytes) are read once.
// Random indices cost shared-memory bank conflicts, not device memory. Two
// forms, chosen on the host from the call's shape:
//
//   staged  A persistent grid, as many blocks of kStagedThreads as the
//           current device holds at once (its SM count and the blocks a SM
//           takes at the call's shared memory, each asked of the runtime
//           once a device and size), blockIdx.y the plane group. Each block
//           stages its group's tables into dynamic shared memory once, by
//           cp.async.bulk on an mbarrier where a table is contiguous and
//           16-byte aligned (its whole 16-byte multiple; the rest by
//           loads), then walks the index grid-stride a quad of rows a
//           thread: one 16-byte index load serves every plane of the
//           group, and the next quad's indices are loaded while this one's
//           are served (the first ones while the tables are staged). The
//           planes' tables fill groups of at most 227 KB in order, so the
//           index is read once where they all fit (every call of 4-byte
//           planes up to C = 3 at s = 16,384).
//   direct  gather_planes.cuh's direct form: every requested entry read
//           through the read-only path. Taken where the tables come to at
//           most 64 KB (kDirectTableBytes: L1, which a block without
//           shared memory leaves whole, holds them, and nothing is staged),
//           and where staging moves more bytes from L2 into the blocks
//           (blocks x the tables' bytes) than the direct form would read (a
//           32-byte sector per row and plane): few rows against the table,
//           such as q3's 10 rows of an 11,268-entry table, where the staged
//           form would stage 270 KB to serve 10 rows.
//
// The constants were chosen by tools/design_sweep.py --only gathers at
// chip_smoke.py phase 3's shapes (PERF.md section 6; NVIDIA H100 80GB
// HBM3, 700.00 W): one int32 plane of 10,000 entries at 5,997,593 rows
// reads 0.0151-0.0152 ms on the card through the direct form against
// 0.0163-0.0165 staged; two (80 KB) 0.0254-0.0258 staged by blocks of
// 1,024 threads against 0.0280 by 512 and 0.0290 direct.

#include "gather_planes.cuh"

namespace {

constexpr int kMaxEntries = 16384;
constexpr int kStagedThreads = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
constexpr int kBarrierBytes = 16;  // the staging barrier, before the tables
constexpr int kBulkChunk = 16384;  // bytes a bulk copy
constexpr int kSmemSizes = kMaxSmem / 1024 + 1;  // kept occupancies a device
// the rule between the forms: the direct form's L2 bytes a row and plane,
// and the tables it takes at any n (read through L1, which holds them)
constexpr int64_t kDirectRowBytes = 32;
constexpr int64_t kDirectTableBytes = 65536;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t smem_elem(const unsigned char* t, int j,
                                              int lw) {
  switch (lw) {
    case 0: return t[j];
    case 1: return reinterpret_cast<const unsigned short*>(t)[j];
    case 2: return reinterpret_cast<const unsigned int*>(t)[j];
    default: return reinterpret_cast<const unsigned long long*>(t)[j];
  }
}

__device__ __forceinline__ void smem_put(unsigned char* t, int j, int lw,
                                         uint64_t v) {
  switch (lw) {
    case 0: t[j] = (unsigned char)v; break;
    case 1: reinterpret_cast<unsigned short*>(t)[j] = (unsigned short)v; break;
    case 2: reinterpret_cast<unsigned int*>(t)[j] = (unsigned int)v; break;
    default: reinterpret_cast<unsigned long long*>(t)[j] = v;
  }
}

// Stage the tables of planes [p0, p1) into `smem` (the barrier in its first
// 16 bytes): thread 0 issues the bulk copies, expecting exactly their bytes
// on the barrier, and every thread loads the elements past them. On return
// the block may read every table.
__device__ __forceinline__ void stage_group(const Planes& pl, int p0, int p1,
                                            unsigned char* smem, int s) {
  int bulk = 0;
  for (int p = p0; p < p1; ++p) bulk += pl.p[p].bulk_bytes;
  const uint32_t bar = smem_addr(smem);
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bulk) : "memory");
    for (int p = p0; p < p1; ++p) {
      const Plane& q = pl.p[p];
      for (int e = 0; e < q.bulk_bytes; e += kBulkChunk) {
        const int len = min(kBulkChunk, q.bulk_bytes - e);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            ::"r"(smem_addr(smem + q.smem_off + e)),
              "l"(reinterpret_cast<uint64_t>(
                  static_cast<const unsigned char*>(q.in) + e)),
              "r"(len), "r"(bar)
            : "memory");
      }
    }
  }
  for (int p = p0; p < p1; ++p) {
    const Plane& q = pl.p[p];
    for (int e = (q.bulk_bytes >> q.lw) + threadIdx.x; e < s;
         e += kStagedThreads)
      smem_put(smem + q.smem_off, e, q.lw,
               load_elem(q.in, (int64_t)e * q.in_stride, q.lw));
  }
  __syncthreads();  // the loads' stores land; the barrier is initialised
  if (bulk) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred P1;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], 0;\n"
          "selp.u32 %0, 1, 0, P1;\n"
          "}\n"
          : "=r"(done) : "r"(bar) : "memory");
    }
  }
}

__global__ void __launch_bounds__(kStagedThreads)
gather_chunked_kernel(const __grid_constant__ Planes pl,
                      const int* __restrict__ idx, int64_t n, int s,
                      bool vec_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = pl.first[blockIdx.y];
  const int p1 = pl.first[blockIdx.y + 1];
  const int64_t quads = (n + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * kStagedThreads;
  int64_t q = (int64_t)blockIdx.x * kStagedThreads + threadIdx.x;
  // the first indices are on their way while the tables are staged
  int4 cur = q < quads ? load_quad(idx, n, q * 4, vec_idx)
                       : make_int4(0, 0, 0, 0);
  stage_group(pl, p0, p1, smem, s);
  for (; q < quads; q += stride) {
    const int4 next = q + stride < quads
                          ? load_quad(idx, n, (q + stride) * 4, vec_idx)
                          : make_int4(0, 0, 0, 0);
    int j[4];
    clamp_quad(cur, s, j);
    const int64_t r0 = q * 4;
    const int cnt = (int)min((int64_t)4, n - r0);
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (p0 + k < p1) {
        const Plane& pp = pl.p[p0 + k];
        const unsigned char* t = smem + pp.smem_off;
        uint64_t v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = smem_elem(t, j[r], pp.lw);
        store_quad(pp, r0, cnt, v);
      }
    }
    cur = next;
  }
}

// Blocks of the staged kernel a SM of `dev` holds at `smem` bytes of
// dynamic shared memory, into *per_sm; the kernel's shared-memory attribute
// is set on the device first. Both are asked of the runtime once a device
// (and size, by the KB). Returns 0 or a negative CUDA error.
int staged_blocks_per_sm(int dev, int smem, int* per_sm) {
  static std::atomic<int> attr_set[kMaxDevices];
  static std::atomic<int> kept[kMaxDevices][kSmemSizes];
  const bool keep = dev >= 0 && dev < kMaxDevices;
  const int kb = (smem + 1023) / 1024;
  int v = keep ? kept[dev][kb].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    cudaError_t err = cudaSuccess;
    if (!keep || !attr_set[dev].load(std::memory_order_relaxed)) {
      err = cudaFuncSetAttribute(gather_chunked_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return -(int)err;
      if (keep) attr_set[dev].store(1, std::memory_order_relaxed);
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, gather_chunked_kernel, kStagedThreads, min(kb * 1024, kMaxSmem));
    if (err != cudaSuccess) return -(int)err;
    if (v < 1) return -(int)cudaErrorInvalidConfiguration;
    if (keep) kept[dev][kb].store(v, std::memory_order_relaxed);
  }
  *per_sm = v;
  return 0;
}

}  // namespace

// desc: the call, packed as gather_planes.cuh describes, with s <= 16,384.
// One kernel launch, in the form the call's shape selects.
extern "C" int ldb_gather_chunked(const int64_t* desc) {
  Call c;
  const int bad = parse(desc, &c);
  if (bad) return bad;
  if (c.s > kMaxEntries) return kBadArgs - 5;
  DeviceGuard guard(c.device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  const int captured = capturing(c.stream);
  if (captured < 0) return captured;
  // plane groups: the tables in order, each group's within kMaxSmem
  int groups = 0, off = 0, most = 0;
  int64_t table_bytes = 0;
  for (int p = 0; p < c.pl.count; ++p) {
    Plane& q = c.pl.p[p];
    const int bytes = c.s << q.lw;
    const int held = (bytes + 15) & ~15;
    if (p == 0 || off + held > kMaxSmem) {
      c.pl.first[groups++] = p;
      off = kBarrierBytes;
    }
    q.smem_off = off;
    const bool bulk_ok = q.in_stride == 1 &&
                         (reinterpret_cast<uintptr_t>(q.in) & 15) == 0;
    q.bulk_bytes = bulk_ok ? bytes & ~15 : 0;
    off += held;
    most = max(most, off);
    table_bytes += bytes;
  }
  c.pl.first[groups] = c.pl.count;
  int per_sm = 0;
  const int err = staged_blocks_per_sm(c.device, most, &per_sm);
  if (err) return err;
  const int64_t quads = (c.n + 3) / 4;
  int64_t blocks = (quads + kStagedThreads - 1) / kStagedThreads;
  const int64_t resident = (int64_t)per_sm * sm_count(c.device) / groups;
  if (blocks > resident) blocks = resident > 0 ? resident : 1;
  if (table_bytes <= kDirectTableBytes ||
      c.n * kDirectRowBytes * c.pl.count < blocks * table_bytes) {
    launch_direct(c);
  } else {
    gather_chunked_kernel<<<dim3((unsigned)blocks, (unsigned)groups),
                            kStagedThreads, most, c.stream>>>(
        c.pl, c.idx, c.n, c.s, c.vec_idx);
  }
  return launched(captured);
}
