// checked_arith: integer and decimal +, -, *, %, casts, and casts from a
// float to DECIMAL, each row's exact result and its error code in one pass.
//
// For row i (x[i], y[i] int32 or int64; a 0-dim operand has stride 0 and
// is read at every row):
//
//   add, sub   R = rescale(x, sx, s) +- rescale(y, sy, s)
//   mul        R = rescale(x * y, sx + sy, s)
//   cast       R = rescale(x, sx, s)
//   mod        R = rescale(x, sx, s) % rescale(y, sy, s), truncated (the
//              dividend's sign); 0 where the divisor is 0 (the caller makes
//              such a row NULL)
//   cast_f     x float32 or float64: |x| rounded to `digits` significant
//              digits (round half even on its exact binary value, as
//              printf("%.*g") does: PostgreSQL's float8_numeric with
//              DBL_DIG = 15, float4_numeric with FLT_DIG = 6), then to
//              scale s half away from zero, x's sign; NaN and infinities
//              are bad at the precision (the engine's decimals hold neither)
//
// rescale multiplies by 10^k up and divides by 10^k down, rounding half
// away from zero. R is computed in __int128: with every shift at most 18
// (mul never scaling up, mod never scaling down, which the wrapper checks)
// |R| and every intermediate stay below 10^38 < 2^127. A row is bad where
// prec > 0 and |R| >= 10^prec, or where R lies outside [lo, hi]; it then
// holds 0 and, where valid[i] (or where there is no validity), code_prec or
// code_range; every other row holds R and code 0.
//
// cast_f takes the float's own answer, |x| * 10^s rounded, where the
// digits' rounding cannot reach the nearest half (most doubles); up to 12
// digits (a real's six) it rounds v = |x| * 10^(d-1-E) in a double where v
// is clear of a half; elsewhere it computes the digits exactly: x = m *
// 2^k (m < 2^53), E the decimal exponent of |x| (log10, corrected by one
// until |x| * 10^(d-1-E) lies in [10^(d-1), 10^d)), D =
// round_half_even(|x| * 10^(d-1-E)): m * 10^a in three 64-bit limbs (a <=
// 36: m * 10^a < 2^173) shifted right by -k where a >= 0, else (m * 2^k or
// m) over (10^-a or 10^-a * 2^-k) in 128 bits. A row |x| < 0.4 * 10^-s is
// 0 (no 15-digit rounding reaches half a unit there), one |x| >= 2^127 is
// past any precision.
//
// No Pallas kernel stands behind this one: in the JAX package XLA fuses an
// operator's value and its checks into one loop, which eager PyTorch
// cannot. Bound on the card: bytes (two operands, the validity, the value
// and the code once each); the int128 division of a rescale, the 128-bit
// % and cast_f's digits are the long operations. A grid-stride loop, one
// row a thread, one kernel an op (each with the registers of its own path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __int128 i128;
typedef unsigned __int128 u128;

enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_CAST = 3, OP_MOD = 4,
       OP_CAST_F = 5 };

__device__ __forceinline__ i128 load_int(const void* p, int width,
                                         int64_t stride, int64_t i) {
  const int64_t at = i * stride;
  if (width == 8) return (i128) static_cast<const int64_t*>(p)[at];
  return (i128) static_cast<const int32_t*>(p)[at];
}

__device__ __forceinline__ double load_float(const void* p, int width,
                                             int64_t stride, int64_t i) {
  const int64_t at = i * stride;
  if (width == 8) return static_cast<const double*>(p)[at];
  return (double) static_cast<const float*>(p)[at];
}

__device__ const uint64_t kPow10[20] = {
    1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull, 1000000ull,
    10000000ull, 100000000ull, 1000000000ull, 10000000000ull,
    100000000000ull, 1000000000000ull, 10000000000000ull,
    100000000000000ull, 1000000000000000ull, 10000000000000000ull,
    100000000000000000ull, 1000000000000000000ull,
    10000000000000000000ull};

// 10^k, 0 <= k <= 38
__device__ __forceinline__ u128 pow10(int k) {
  if (k <= 19) return kPow10[k];
  return (u128)kPow10[19] * kPow10[k - 19];
}

// n / d in 64 bits where both fit (the 128-bit division is software)
__device__ __forceinline__ u128 udiv(u128 n, u128 d) {
  if ((n >> 64) == 0 && (d >> 64) == 0) return (uint64_t)n / (uint64_t)d;
  return n / d;
}

// v / 10^k rounded half away from zero (k >= 1)
__device__ __forceinline__ i128 div_round(i128 v, u128 d) {
  const u128 a = (u128)(v < 0 ? -v : v);
  const i128 q = (i128)udiv(a + d / 2, d);
  return v < 0 ? -q : q;
}

__device__ __forceinline__ i128 rescale(i128 v, int from, int to) {
  if (to >= from) return v * (i128)pow10(to - from);
  return div_round(v, pow10(from - to));
}

// n / d truncated; *up where rounding half to even adds one
__device__ __forceinline__ u128 div_half_even(u128 n, u128 d, bool* up) {
  const u128 q = udiv(n, d);
  const u128 twice = (n - q * d) << 1;  // d < 2^127: no overflow
  *up = twice > d || (twice == d && (q & 1));
  return q;
}

// 64 bits of the 192-bit limbs l (least significant first) from bit `at`
__device__ __forceinline__ uint64_t bits64(const uint64_t* l, int at) {
  const int w = at >> 6, b = at & 63;
  const uint64_t lo = w < 3 ? l[w] >> b : 0;
  const uint64_t hi = (b != 0 && w + 1 < 3) ? l[w + 1] << (64 - b) : 0;
  return lo | hi;
}

// m * 10^a / 2^sh truncated (m < 2^53, 0 <= a <= 36, 1 <= sh < 192; the
// quotient fits 64 bits); *up where rounding half to even adds one
__device__ __forceinline__ uint64_t shr_half_even(uint64_t m, int a, int sh,
                                                  bool* up) {
  const u128 t = pow10(a);
  const u128 p0 = (u128)m * (uint64_t)t;
  const u128 mid = (p0 >> 64) + (u128)m * (uint64_t)(t >> 64);
  const uint64_t l[3] = {(uint64_t)p0, (uint64_t)mid, (uint64_t)(mid >> 64)};
  const uint64_t q = bits64(l, sh);
  const int hb = sh - 1;  // the bit worth half a unit of q
  const bool half = (l[hb >> 6] >> (hb & 63)) & 1;
  bool below = false;  // any bit under it
  for (int w = 0; w <= (hb >> 6); ++w) {
    const uint64_t mask =
        w < (hb >> 6) ? ~0ull : ((1ull << (hb & 63)) - 1);
    below |= (l[w] & mask) != 0;
  }
  *up = half && (below || (q & 1));
  return q;
}

// d * 10^(e - digits + 1) (|x| to `digits` digits, d <= 10^digits) at
// scale s, rounded half away from zero; 10^38 for anything past 10^38
__device__ __forceinline__ u128 digits_at_scale(uint64_t d, int e,
                                                int digits, int s) {
  const int t = e - digits + 1 + s;
  if (t >= 0) {  // d >= 10^(digits-1): past 38 digits is past 10^38
    if (t + digits > 38) return pow10(38);
    return (u128)d * pow10(t);
  }
  if (-t > 19) return 0;  // d < 10^17 < half of 10^19
  const uint64_t p = kPow10[-t];
  return (d + p / 2) / p;
}

// |x| (finite) rounded to `digits` significant digits, then to scale s
// half away from zero: the magnitude, at most 10^38 (anything past 10^38 is
// 10^38, past every precision)
__device__ __forceinline__ u128 cast_float_mag(double ax, int digits,
                                               int s) {
  const u128 sat = pow10(38);
  const double unit = (double)kPow10[s];  // 10^s, exact: s <= 18
  if (ax == 0.0 || ax < 0.4 / unit) return 0;
  if (ax >= 0x1p127) return sat;
  int e2;
  const double f = frexp(ax, &e2);  // ax = f * 2^e2, f in [0.5, 1)
  // Most rows take the float's answer: rounding |x| to `digits` digits
  // moves it by at most half a unit of its last digit, below 0.5 *
  // 10^(E + 1 - digits) with E < e2 * log10(2) + 1, and ax * 10^s is off by
  // its own rounding; where both stay below the distance from ax * 10^s to
  // the nearest half, rounding it half away from zero is the answer.
  const double scaled = ax * unit;
  if (scaled < 0x1p52) {
    const double e_up = ceil(e2 * 0.30103) + 1.0;
    const double moved =
        0.5 * exp10(e_up + 1.0 - digits + s) + scaled * 0x1p-50;
    if (fabs(scaled - floor(scaled) - 0.5) > moved) {
      return (u128)(uint64_t)floor(scaled + 0.5);
    }
  }
  // e: the exponent where |x| * 10^(digits - 1 - e), truncated, lies in
  // [10^(digits-1), 10^digits) (log10 is off by at most one)
  int e = (int)floor(log10(ax));
  const u128 lo_d = pow10(digits - 1), hi_d = lo_d * 10;
  if (digits <= 12) {
    // A double resolves up to 12 digits (a real's six): v = |x| *
    // 10^(digits - 1 - e) within a few units of its last place; where it
    // is clear of the range's ends and of a half, its rounding is D.
    double v = ax * exp10((double)(digits - 1 - e));
    int eb = e;
    if (v >= (double)hi_d || v < (double)lo_d) {
      eb += v >= (double)hi_d ? 1 : -1;
      v = ax * exp10((double)(digits - 1 - eb));
    }
    const double margin = v * 0x1p-45;
    if (v >= (double)lo_d + margin && v < (double)hi_d - margin &&
        fabs(v - floor(v) - 0.5) > margin) {
      return digits_at_scale((uint64_t)floor(v + 0.5), eb, digits, s);
    }
  }
  const uint64_t m = (uint64_t)ldexp(f, 53);
  const int k = e2 - 53;
  u128 d = 0;
  bool up = false;
  for (int pass = 0; pass < 3; ++pass) {
    const int a = digits - 1 - e;
    up = false;
    if (a >= 0 && k >= 0) {
      d = ((u128)m << k) * pow10(a);
    } else if (a >= 0) {
      d = shr_half_even(m, a, -k, &up);
    } else if (k >= 0) {
      d = div_half_even((u128)m << k, pow10(-a), &up);
    } else {
      d = div_half_even(m, pow10(-a) << -k, &up);
    }
    if (d >= hi_d) {
      ++e;
    } else if (d < lo_d) {
      --e;
    } else {
      break;
    }
  }
  d += up;  // may reach 10^digits: |x| rounded up to 10^(e + 1)
  return digits_at_scale((uint64_t)d, e, digits, s);
}

// row i's R; false where it has none (cast_f of NaN or an infinity)
template <int OP>
__device__ __forceinline__ bool row_result(
    int64_t i, const void* x, int xw, int64_t xs, const void* y, int yw,
    int64_t ys, int sx, int sy, int s, int digits, i128* r) {
  const int op = OP;
  if (op == OP_CAST_F) {
    const double v = load_float(x, xw, xs, i);
    if (isnan(v) || isinf(v)) return false;
    const i128 mag = (i128)cast_float_mag(fabs(v), digits, s);
    *r = v < 0 ? -mag : mag;
    return true;
  }
  const i128 a = load_int(x, xw, xs, i);
  if (op == OP_CAST) {
    *r = rescale(a, sx, s);
  } else if (op == OP_MUL) {
    *r = rescale(a * load_int(y, yw, ys, i), sx + sy, s);
  } else {
    const i128 b = rescale(load_int(y, yw, ys, i), sy, s);
    const i128 va = rescale(a, sx, s);
    if (op == OP_MOD) {  // C++'s % truncates: the dividend's sign
      if (b == 0) {
        *r = 0;
      } else if (va == (int64_t)va && b == (int64_t)b && b != -1) {
        *r = (int64_t)va % (int64_t)b;  // 64-bit where both fit
      } else {
        *r = va % b;
      }
    } else {
      *r = op == OP_ADD ? va + b : va - b;
    }
  }
  return true;
}

// one kernel an op: each keeps the registers of its own path
template <int OP>
__global__ void checked_arith_kernel(
    int64_t n, const void* x, int xw, int64_t xs, const void* y,
    int yw, int64_t ys, const uint8_t* valid, int64_t vs, int sx, int sy,
    int s, int64_t lo, int64_t hi, int code_range, int prec, int code_prec,
    int digits, void* out, int ow, int32_t* code) {
  const i128 limit = prec > 0 ? (i128)pow10(prec) : 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    i128 r = 0;
    int c = 0;
    if (!row_result<OP>(i, x, xw, xs, y, yw, ys, sx, sy, s, digits, &r)) {
      c = code_prec;
    } else if (prec > 0 && (r >= limit || r <= -limit)) {
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

// op: 0 add, 1 sub, 2 mul, 3 cast (y unused), 4 mod, 5 cast_f (y unused,
// x float32 (width 4) or float64 (width 8), digits 1..17, prec > 0). x, y:
// device pointers of int32 (width 4) or int64 (width 8) elements, stride 1
// (a column) or 0 (a scalar). valid: bool bytes or null, stride 1 or 0.
// out: n elements of width ow (4 or 8); code: n int32. Returns the CUDA
// error of the launch, or a negative code for arguments the kernel does not
// take.
extern "C" int ldb_checked_arith(int op, int64_t n, const void* x, int xw,
                                 int64_t xs, const void* y, int yw,
                                 int64_t ys, const void* valid, int64_t vs,
                                 int sx, int sy, int s, int64_t lo,
                                 int64_t hi, int code_range, int prec,
                                 int code_prec, int digits, void* out, int ow,
                                 void* code, int max_blocks, void* stream) {
  if (n < 1 || max_blocks < 1 || op < OP_ADD || op > OP_CAST_F) return -1;
  const bool unary = op == OP_CAST || op == OP_CAST_F;
  if ((xw != 4 && xw != 8) || (!unary && yw != 4 && yw != 8) ||
      (ow != 4 && ow != 8)) {
    return -2;
  }
  if (x == nullptr || (!unary && y == nullptr) || out == nullptr ||
      code == nullptr) {
    return -3;
  }
  if (prec < 0 || prec > 38 || sx < 0 || sy < 0 || s < 0) return -4;
  const int k1 = s - sx, k2 = s - sy, km = sx + sy - s;
  bool shifts;
  if (op == OP_MUL) {
    shifts = km >= 0 && km <= 18;
  } else if (op == OP_CAST_F) {
    shifts = s <= 18 && digits >= 1 && digits <= 17 && prec > 0;
  } else if (op == OP_MOD) {
    shifts = k1 >= 0 && k1 <= 18 && k2 >= 0 && k2 <= 18;
  } else {
    shifts = k1 >= -18 && k1 <= 18 &&
             (op == OP_CAST || (k2 >= -18 && k2 <= 18));
  }
  if (!shifts) return -5;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* c = static_cast<int32_t*>(code);
#define LDB_CHECKED_LAUNCH(OP)                                              \
  checked_arith_kernel<OP><<<(unsigned)blocks, threads, 0, st>>>(          \
      n, x, xw, xs, y, yw, ys, v, vs, sx, sy, s, lo, hi, code_range, prec, \
      code_prec, digits, out, ow, c)
  switch (op) {
    case OP_ADD: LDB_CHECKED_LAUNCH(OP_ADD); break;
    case OP_SUB: LDB_CHECKED_LAUNCH(OP_SUB); break;
    case OP_MUL: LDB_CHECKED_LAUNCH(OP_MUL); break;
    case OP_CAST: LDB_CHECKED_LAUNCH(OP_CAST); break;
    case OP_MOD: LDB_CHECKED_LAUNCH(OP_MOD); break;
    default: LDB_CHECKED_LAUNCH(OP_CAST_F); break;
  }
#undef LDB_CHECKED_LAUNCH
  return (int)cudaGetLastError();
}
