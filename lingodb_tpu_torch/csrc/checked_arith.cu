// checked_arith: integer and decimal +, -, * and casts, each row's exact
// result and its error code in one pass.
//
// For row i (x[i], y[i] int32 or int64; a 0-dim operand has stride 0 and
// is read at every row):
//
//   add, sub   R = rescale(x, sx, s) +- rescale(y, sy, s)
//   mul        R = rescale(x * y, sx + sy, s)
//   cast       R = rescale(x, sx, s)
//
// rescale multiplies by 10^k up and divides by 10^k down, rounding half
// away from zero. R is computed in __int128: with every shift at most 18
// (and mul never scaling up, which the wrapper checks) |R| and every
// intermediate stay below 10^38 < 2^127. A row is bad where prec > 0 and
// |R| >= 10^prec, or where R lies outside [lo, hi]; it then holds 0 and,
// where valid[i] (or where there is no validity), code_prec or code_range;
// every other row holds R and code 0.
//
// No Pallas kernel stands behind this one: in the JAX package XLA fuses an
// operator's value and its checks into one loop, which eager PyTorch
// cannot. Bound on the card: bytes (two operands, the validity, the value
// and the code once each); the int128 division of a rescale is the only
// long operation. A grid-stride loop, one row a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __int128 i128;

__device__ __forceinline__ i128 load_int(const void* p, int width,
                                         int64_t stride, int64_t i) {
  const int64_t at = i * stride;
  if (width == 8) return (i128) static_cast<const int64_t*>(p)[at];
  return (i128) static_cast<const int32_t*>(p)[at];
}

__device__ __forceinline__ i128 pow10(int k) {
  i128 v = 1;
  for (int j = 0; j < k; ++j) v *= 10;
  return v;
}

// v / 10^k rounded half away from zero (k >= 1)
__device__ __forceinline__ i128 div_round(i128 v, i128 d) {
  const unsigned __int128 a = (unsigned __int128)(v < 0 ? -v : v);
  const unsigned __int128 ud = (unsigned __int128)d;
  const i128 q = (i128)((a + ud / 2) / ud);
  return v < 0 ? -q : q;
}

__device__ __forceinline__ i128 rescale(i128 v, int from, int to) {
  if (to >= from) return v * pow10(to - from);
  return div_round(v, pow10(from - to));
}

__global__ void checked_arith_kernel(
    int op, int64_t n, const void* x, int xw, int64_t xs, const void* y,
    int yw, int64_t ys, const uint8_t* valid, int64_t vs, int sx, int sy,
    int s, int64_t lo, int64_t hi, int code_range, int prec, int code_prec,
    void* out, int ow, int32_t* code) {
  const i128 limit = prec > 0 ? pow10(prec) : 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const i128 a = load_int(x, xw, xs, i);
    i128 r;
    if (op == 3) {
      r = rescale(a, sx, s);
    } else if (op == 2) {
      r = rescale(a * load_int(y, yw, ys, i), sx + sy, s);
    } else {
      const i128 b = rescale(load_int(y, yw, ys, i), sy, s);
      r = rescale(a, sx, s);
      r = op == 0 ? r + b : r - b;
    }
    int c = 0;
    if (prec > 0 && (r >= limit || r <= -limit)) {
      c = code_prec;
    } else if (r < (i128)lo || r > (i128)hi) {
      c = code_range;
    }
    const int64_t v = c ? 0 : (int64_t)r;
    if (ow == 8) {
      static_cast<int64_t*>(out)[i] = v;
    } else {
      static_cast<int32_t*>(out)[i] = (int32_t)v;
    }
    const bool live = valid == nullptr || valid[i * vs] != 0;
    code[i] = live ? c : 0;
  }
}

}  // namespace

// op: 0 add, 1 sub, 2 mul, 3 cast (y unused). x, y: device pointers of
// int32 (width 4) or int64 (width 8) elements, stride 1 (a column) or 0 (a
// scalar). valid: bool bytes or null, stride 1 or 0. out: n elements of
// width ow (4 or 8); code: n int32. Returns the CUDA error of the launch,
// or a negative code for arguments the kernel does not take.
extern "C" int ldb_checked_arith(int op, int64_t n, const void* x, int xw,
                                 int64_t xs, const void* y, int yw,
                                 int64_t ys, const void* valid, int64_t vs,
                                 int sx, int sy, int s, int64_t lo,
                                 int64_t hi, int code_range, int prec,
                                 int code_prec, void* out, int ow,
                                 void* code, int max_blocks, void* stream) {
  if (n < 1 || max_blocks < 1 || op < 0 || op > 3) return -1;
  if ((xw != 4 && xw != 8) || (op != 3 && yw != 4 && yw != 8) ||
      (ow != 4 && ow != 8)) {
    return -2;
  }
  if (x == nullptr || (op != 3 && y == nullptr) || out == nullptr ||
      code == nullptr) {
    return -3;
  }
  if (prec < 0 || prec > 38 || sx < 0 || sy < 0 || s < 0) return -4;
  const int k1 = s - sx, k2 = s - sy, km = sx + sy - s;
  if (op == 2 ? (km < 0 || km > 18)
              : (k1 < -18 || k1 > 18 || (op != 3 && (k2 < -18 || k2 > 18)))) {
    return -5;
  }
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  checked_arith_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      op, n, x, xw, xs, y, yw, ys, static_cast<const uint8_t*>(valid), vs, sx,
      sy, s, lo, hi, code_range, prec, code_prec, out, ow,
      static_cast<int32_t*>(code));
  return (int)cudaGetLastError();
}
