// Native host runtime kernels.
//
// TPU-native counterpart of the reference's C++ value runtimes
// (reference: src/runtime/StringRuntime.cpp — like/cast formatting;
// src/runtime/DateRuntime.cpp — date decomposition; the generated code calls
// these through the FFI). Here the device compute path is XLA/Pallas; these
// kernels cover the host data plane: result-value formatting (every
// sqllogictest/tester row passes through) and dictionary pattern matching.
// Built with build.py into .cache/native/lingodb_native.so, bound via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- decimals
// Format scaled-int64 decimals: "-123.45" for val=-12345, scale=2.
// offsets[0..n] delimit each string in `out`. Returns bytes needed;
// if > cap nothing is guaranteed written (caller re-calls with larger buf).
int64_t format_decimal(const int64_t* vals, const uint8_t* valid, int64_t n,
                       int scale, char* out, int64_t* offsets, int64_t cap) {
   int64_t pos = 0;
   char tmp[48];
   for (int64_t i = 0; i < n; i++) {
      offsets[i] = pos;
      if (valid && !valid[i]) continue;  // NULL -> empty slice
      int64_t v = vals[i];
      int len;
      if (scale == 0) {
         len = snprintf(tmp, sizeof tmp, "%lld", (long long)v);
      } else {
         uint64_t a = v < 0 ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
         uint64_t p10 = 1;
         for (int k = 0; k < scale; k++) p10 *= 10;
         len = snprintf(tmp, sizeof tmp, "%s%llu.%0*llu", v < 0 ? "-" : "",
                        (unsigned long long)(a / p10), scale,
                        (unsigned long long)(a % p10));
      }
      if (pos + len <= cap) memcpy(out + pos, tmp, len);
      pos += len;
   }
   offsets[n] = pos;
   return pos;
}

// ------------------------------------------------------------------- dates
// days since 1970-01-01 -> "YYYY-MM-DD" (civil-from-days, Howard Hinnant's
// public-domain algorithm shape)
static void civil_from_days(int64_t z, int* y, unsigned* m, unsigned* d) {
   z += 719468;
   const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
   const unsigned doe = (unsigned)(z - era * 146097);
   const unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
   const int64_t yy = (int64_t)yoe + era * 400;
   const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
   const unsigned mp = (5 * doy + 2) / 153;
   *d = doy - (153 * mp + 2) / 5 + 1;
   *m = mp < 10 ? mp + 3 : mp - 9;
   *y = (int)(yy + (*m <= 2));
}

int64_t format_date32(const int32_t* days, const uint8_t* valid, int64_t n,
                      char* out, int64_t* offsets, int64_t cap) {
   int64_t pos = 0;
   char tmp[24];
   for (int64_t i = 0; i < n; i++) {
      offsets[i] = pos;
      if (valid && !valid[i]) continue;
      int y; unsigned m, d;
      civil_from_days(days[i], &y, &m, &d);
      int len = snprintf(tmp, sizeof tmp, "%04d-%02u-%02u", y, m, d);
      if (pos + len <= cap) memcpy(out + pos, tmp, len);
      pos += len;
   }
   offsets[n] = pos;
   return pos;
}

int64_t format_ts_us(const int64_t* us, const uint8_t* valid, int64_t n,
                     char* out, int64_t* offsets, int64_t cap) {
   int64_t pos = 0;
   char tmp[48];
   for (int64_t i = 0; i < n; i++) {
      offsets[i] = pos;
      if (valid && !valid[i]) continue;
      int64_t v = us[i];
      int64_t days = v / 86400000000LL;
      int64_t rem = v - days * 86400000000LL;
      if (rem < 0) { rem += 86400000000LL; days -= 1; }
      int y; unsigned m, d;
      civil_from_days(days, &y, &m, &d);
      unsigned hh = (unsigned)(rem / 3600000000LL);
      unsigned mi = (unsigned)((rem / 60000000LL) % 60);
      unsigned ss = (unsigned)((rem / 1000000LL) % 60);
      unsigned frac = (unsigned)(rem % 1000000LL);
      int len;
      if (frac) {
         len = snprintf(tmp, sizeof tmp, "%04d-%02u-%02u %02u:%02u:%02u.%06u",
                        y, m, d, hh, mi, ss, frac);
         while (len > 0 && tmp[len - 1] == '0') len--;  // trim trailing zeros
         if (len > 0 && tmp[len - 1] == '.') len--;
      } else {
         len = snprintf(tmp, sizeof tmp, "%04d-%02u-%02u %02u:%02u:%02u",
                        y, m, d, hh, mi, ss);
      }
      if (pos + len <= cap) memcpy(out + pos, tmp, len);
      pos += len;
   }
   offsets[n] = pos;
   return pos;
}

// ---------------------------------------------------------------- integers
int64_t format_int64(const int64_t* vals, const uint8_t* valid, int64_t n,
                     char* out, int64_t* offsets, int64_t cap) {
   int64_t pos = 0;
   char tmp[24];
   for (int64_t i = 0; i < n; i++) {
      offsets[i] = pos;
      if (valid && !valid[i]) continue;
      int len = snprintf(tmp, sizeof tmp, "%lld", (long long)vals[i]);
      if (pos + len <= cap) memcpy(out + pos, tmp, len);
      pos += len;
   }
   offsets[n] = pos;
   return pos;
}

// -------------------------------------------------------------------- LIKE
// SQL LIKE: '%' any run, '_' one char, optional escape. Iterative two-pointer
// wildcard match (no backtracking blowup). Bytes are UTF-8; '_' consumes one
// codepoint.
static int utf8_len(unsigned char c) {
   if (c < 0x80) return 1;
   if ((c >> 5) == 0x6) return 2;
   if ((c >> 4) == 0xe) return 3;
   if ((c >> 3) == 0x1e) return 4;
   return 1;
}

static bool like_one(const char* s, int64_t slen, const char* p, int64_t plen,
                     char esc, bool ci) {
   int64_t si = 0, pi = 0, star_si = -1, star_pi = -1;
   auto eq = [ci](char a, char b) {
      if (a == b) return true;
      if (!ci) return false;
      char la = (a >= 'A' && a <= 'Z') ? a + 32 : a;
      char lb = (b >= 'A' && b <= 'Z') ? b + 32 : b;
      return la == lb;
   };
   while (si < slen) {
      bool lit = false;
      char pc = 0;
      if (pi < plen) {
         pc = p[pi];
         if (esc && pc == esc && pi + 1 < plen) { lit = true; pc = p[pi + 1]; }
      }
      if (pi < plen && !lit && pc == '%') {
         star_pi = ++pi;
         star_si = si;
         continue;
      }
      if (pi < plen && ((!lit && pc == '_') || eq(pc, s[si]))) {
         if (!lit && pc == '_') {
            si += utf8_len((unsigned char)s[si]);
         } else {
            si++;
         }
         pi += lit ? 2 : 1;
         continue;
      }
      if (star_pi >= 0) {
         star_si += utf8_len((unsigned char)s[star_si]);
         si = star_si;
         pi = star_pi;
         continue;
      }
      return false;
   }
   while (pi < plen && p[pi] == '%') pi++;
   return pi == plen;
}

void like_match(const char* bytes, const int64_t* offsets, int64_t n,
                const char* pattern, int64_t plen, char esc, int ci,
                uint8_t* out) {
   for (int64_t i = 0; i < n; i++) {
      out[i] = like_one(bytes + offsets[i], offsets[i + 1] - offsets[i],
                        pattern, plen, esc, ci != 0);
   }
}

}  // extern "C"
