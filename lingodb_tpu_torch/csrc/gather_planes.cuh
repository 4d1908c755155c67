// gather_planes.cuh: what the engine's two gathers share
// (csrc/gather_sorted.cu, K2, and csrc/gather_chunked.cu, K1): the call's
// descriptor, loads and stores of elements of any width, and the direct
// form, which reads every requested entry from global memory.
//
// A call gathers up to 8 planes at one index array:
// out[p][i] = plane[p][clamp(idx[i], 0, s - 1)]. A plane is a 1-D array of
// s elements of 1, 2, 4 or 8 bytes (its own width, with an element stride);
// its output has the plane's width. Elements are copied as bits, so any
// type of those widths is gathered exactly: a bool stays a 0/1 byte, a
// float keeps its NaN payload.
//
// The wrapper (ops/pgather.py) packs the call into one array of int64
// words, read here on the host before the launch:
//   [0] planes C (1..8), [1] n >= 1, [2] s in 1..2^31 - 1, [3] idx (int32,
//   device pointer), [4] the stream, [5] the device,
//   then for each plane: in, out (device pointers), in stride, out stride
//   (elements), log2 of the element's bytes (0..3).
// Everything the kernel needs goes into a struct passed by value, so a CUDA
// graph that captures the launch keeps its own copy.
//
// A thread serves 4 rows: a quad, 4i .. 4i + 3, with one 16-byte load of
// the index where idx is 16-byte aligned and one store of the quad's 4
// elements (4, 8, 16 or 2 x 16 bytes) where the output plane is contiguous
// and aligned to that store, else element by element; or, in the direct
// form's kernel of one plane a thread, 4 rows strided by the block, each
// load and store a warp-wide one of 32 neighbouring rows. A row's store is
// one thread's, so neighbouring threads never write the same word.
//
// The entry points return 0 after a launch, 1 after a launch into a stream
// being captured (the wrapper counts it in the capture's tally), a negative
// CUDA error code, or kBadArgs - k for arguments the kernels do not take.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kHeader = 6;    // int64 words before the planes
constexpr int kPerPlane = 5;  // int64 words a plane
constexpr int kBadArgs = -10000;
constexpr int kMaxDevices = 64;  // devices whose attributes are kept
constexpr int kDirectThreads = 128;
// the direct form serves every plane of a quad in one thread where the
// grid of quads alone has at least this many blocks a SM; below it (few
// rows: the survivors of a filter) it launches a block a (quads, plane), so
// that the card has enough warps, each with its loads in flight
constexpr int kSplitBlocksPerSM = 8;
// the direct form's rows a thread: 4 rows kDirectThreads apart (true: each
// warp-wide load of the index or of a plane covers 32 neighbouring rows),
// else a quad (one 16-byte index load, one store of the quad), in the
// kernel of one plane a thread (the split grid, and C = 1) and in that of
// every plane a thread
constexpr bool kStridedOne = true;
constexpr bool kStridedAll = false;

struct Plane {
  const void* in;
  void* out;
  int64_t in_stride;   // elements
  int64_t out_stride;  // elements
  int lw;              // log2 of the element's bytes
  int vec_out;         // a quad is one store: stride 1, aligned to it
  int smem_off;        // K1's staged form: the table's bytes in shared memory
  int bulk_bytes;      // K1's staged form: its bytes staged by cp.async.bulk
};

struct Planes {
  Plane p[kMaxPlanes];
  int count;
  int first[kMaxPlanes + 1];  // K1's staged form: plane groups
};

struct Call {
  Planes pl;
  const int* idx;
  int64_t n;
  int s;
  cudaStream_t stream;
  int device;
  bool vec_idx;
};

inline int parse(const int64_t* d, Call* c) {
  const int64_t count = d[0];
  if (count < 1 || count > kMaxPlanes) return kBadArgs - 1;
  if (d[1] < 1) return kBadArgs - 2;
  if (d[2] < 1 || d[2] > INT32_MAX) return kBadArgs - 3;
  *c = Call{};
  c->pl.count = (int)count;
  c->n = d[1];
  c->s = (int)d[2];
  c->idx = reinterpret_cast<const int*>(d[3]);
  c->vec_idx = (d[3] & 15) == 0;
  c->stream = reinterpret_cast<cudaStream_t>(d[4]);
  c->device = (int)d[5];
  for (int p = 0; p < count; ++p) {
    const int64_t* e = d + kHeader + kPerPlane * p;
    if (e[4] < 0 || e[4] > 3) return kBadArgs - 4;
    Plane& q = c->pl.p[p];
    q.in = reinterpret_cast<const void*>(e[0]);
    q.out = reinterpret_cast<void*>(e[1]);
    q.in_stride = e[2];
    q.out_stride = e[3];
    q.lw = (int)e[4];
    const int64_t quad = (int64_t)4 << q.lw;
    q.vec_out = e[3] == 1 && e[1] % (quad < 16 ? quad : 16) == 0;
  }
  return 0;
}

// Makes the call's device current for the launch, and the caller's current
// again after it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) {
      err = cudaSetDevice(dev);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// The SM count of `dev`, asked of the runtime once a device.
inline int sm_count(int dev) {
  static std::atomic<int> kept[kMaxDevices];
  int v = dev >= 0 && dev < kMaxDevices
              ? kept[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess || v < 1)
      v = 1;
    if (dev >= 0 && dev < kMaxDevices)
      kept[dev].store(v, std::memory_order_relaxed);
  }
  return v;
}

// 1 where `stream` is being captured, 0 where not, a negative CUDA error.
inline int capturing(cudaStream_t stream) {
  cudaStreamCaptureStatus st = cudaStreamCaptureStatusNone;
  const cudaError_t err = cudaStreamIsCapturing(stream, &st);
  if (err != cudaSuccess) return -(int)err;
  return st == cudaStreamCaptureStatusActive ? 1 : 0;
}

// What an entry point returns after its launch.
inline int launched(int captured) {
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? -(int)err : captured;
}

__device__ __forceinline__ uint64_t load_elem(const void* base, int64_t i,
                                              int lw) {
  switch (lw) {
    case 0: return __ldg(static_cast<const unsigned char*>(base) + i);
    case 1: return __ldg(static_cast<const unsigned short*>(base) + i);
    case 2: return __ldg(static_cast<const unsigned int*>(base) + i);
    default: return __ldg(static_cast<const unsigned long long*>(base) + i);
  }
}

__device__ __forceinline__ void store_elem(void* base, int64_t i, int lw,
                                           uint64_t v) {
  switch (lw) {
    case 0: static_cast<unsigned char*>(base)[i] = (unsigned char)v; break;
    case 1: static_cast<unsigned short*>(base)[i] = (unsigned short)v; break;
    case 2: static_cast<unsigned int*>(base)[i] = (unsigned int)v; break;
    default: static_cast<unsigned long long*>(base)[i] = v;
  }
}

// Rows r0 .. r0 + cnt - 1 (cnt <= 4) of plane q's output.
__device__ __forceinline__ void store_quad(const Plane& q, int64_t r0,
                                           int cnt, const uint64_t (&v)[4]) {
  if (q.vec_out && cnt == 4) {
    char* b = static_cast<char*>(q.out);
    switch (q.lw) {
      case 0:
        *reinterpret_cast<uint32_t*>(b + r0) =
            (uint32_t)(v[0] & 0xff) | (uint32_t)(v[1] & 0xff) << 8 |
            (uint32_t)(v[2] & 0xff) << 16 | (uint32_t)(v[3] & 0xff) << 24;
        break;
      case 1:
        *reinterpret_cast<uint2*>(b + 2 * r0) = make_uint2(
            (uint32_t)(v[0] & 0xffff) | (uint32_t)(v[1] & 0xffff) << 16,
            (uint32_t)(v[2] & 0xffff) | (uint32_t)(v[3] & 0xffff) << 16);
        break;
      case 2:
        *reinterpret_cast<uint4*>(b + 4 * r0) =
            make_uint4((uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2],
                       (uint32_t)v[3]);
        break;
      default: {
        ulonglong2* o = reinterpret_cast<ulonglong2*>(b + 8 * r0);
        o[0] = make_ulonglong2(v[0], v[1]);
        o[1] = make_ulonglong2(v[2], v[3]);
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < cnt) store_elem(q.out, (r0 + k) * q.out_stride, q.lw, v[k]);
}

// The raw indices of the quad at row r0 (zeros past n).
__device__ __forceinline__ int4 load_quad(const int* __restrict__ idx,
                                          int64_t n, int64_t r0, bool vec) {
  if (vec && r0 + 4 <= n) return __ldg(reinterpret_cast<const int4*>(idx + r0));
  int4 v = make_int4(0, 0, 0, 0);
  if (r0 < n) v.x = __ldg(idx + r0);
  if (r0 + 1 < n) v.y = __ldg(idx + r0 + 1);
  if (r0 + 2 < n) v.z = __ldg(idx + r0 + 2);
  if (r0 + 3 < n) v.w = __ldg(idx + r0 + 3);
  return v;
}

__device__ __forceinline__ void clamp_quad(int4 v, int s, int (&j)[4]) {
  j[0] = min(max(v.x, 0), s - 1);
  j[1] = min(max(v.y, 0), s - 1);
  j[2] = min(max(v.z, 0), s - 1);
  j[3] = min(max(v.w, 0), s - 1);
}

// The direct form: a thread 4 rows, for kP planes (all of them where kP ==
// kMaxPlanes, else plane blockIdx.y), every load issued before the first
// store so that all of its entries are in flight at once.
template <int kP>
__global__ void __launch_bounds__(kDirectThreads)
gather_direct_kernel(const __grid_constant__ Planes pl,
                     const int* __restrict__ idx, int64_t n, int s,
                     bool vec_idx) {
  constexpr bool kRowsStrided = kP == 1 ? kStridedOne : kStridedAll;
  const int64_t tile = (int64_t)blockIdx.x * kDirectThreads * 4;
  const int64_t r0 = kRowsStrided ? tile + threadIdx.x
                                  : tile + 4 * (int64_t)threadIdx.x;
  if (r0 >= n) return;
  int j[4];
  if (kRowsStrided) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = r0 + (int64_t)r * kDirectThreads;
      j[r] = min(max(row < n ? __ldg(idx + row) : 0, 0), s - 1);
    }
  } else {
    clamp_quad(load_quad(idx, n, r0, vec_idx), s, j);
  }
  const int p0 = kP == kMaxPlanes ? 0 : (int)blockIdx.y;
  const int np = kP == kMaxPlanes ? pl.count : 1;
  uint64_t v[kP][4];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    if (k < np) {
      const Plane& q = pl.p[p0 + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[k][r] = load_elem(q.in, (int64_t)j[r] * q.in_stride, q.lw);
    }
  }
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    if (k >= np) continue;
    const Plane& q = pl.p[p0 + k];
    if (kRowsStrided) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t row = r0 + (int64_t)r * kDirectThreads;
        if (row < n) store_elem(q.out, row * q.out_stride, q.lw, v[k][r]);
      }
    } else {
      store_quad(q, r0, (int)min((int64_t)4, n - r0), v[k]);
    }
  }
}

// Launches the direct form for a parsed call on its stream.
inline void launch_direct(const Call& c) {
  const int64_t quads = (c.n + 3) / 4;
  const int64_t blocks = (quads + kDirectThreads - 1) / kDirectThreads;
  if (c.pl.count == 1 ||
      blocks < (int64_t)kSplitBlocksPerSM * sm_count(c.device)) {
    gather_direct_kernel<1>
        <<<dim3((unsigned)blocks, (unsigned)c.pl.count), kDirectThreads, 0,
           c.stream>>>(c.pl, c.idx, c.n, c.s, c.vec_idx);
  } else {
    gather_direct_kernel<kMaxPlanes>
        <<<dim3((unsigned)blocks), kDirectThreads, 0, c.stream>>>(
            c.pl, c.idx, c.n, c.s, c.vec_idx);
  }
}

}  // namespace
