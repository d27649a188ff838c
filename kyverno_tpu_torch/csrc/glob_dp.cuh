// The glob DP shared by K1c (k1c_wildcard.cu) and K1v (k1_vm.cuh): does
// a constant pattern match the first `vlen` bytes of a value's window?
//
//     dp[j]: the pattern consumed so far matches value[:j]
//     '*'      dp = cumsum(dp) > 0             (every j at or after the first hit)
//     '?'      dp = [0] ++ (dp[:-1] & j < vlen)
//     literal  dp = [0] ++ (dp[:-1] & head == c & j < vlen)
//     matched  = dp[vlen],  vlen = min(str_len, w)
//
// dp over its w + 1 <= 65 positions lives in two 64-bit words
// (positions 0..63 in `lo`, position 64 in bit 0 of `hi`): a literal or
// '?' is (dp & eq_mask) << 1, and '*' is a prefix-OR, every bit at or
// above the lowest set bit, clipped to position w.
//
// `h` holds GLOB_DP_MAX_W bytes, zero past the window's w bytes: the
// loops over it are unrolled, so a caller's array stays in registers.
// Under nvcc the functions are host and device code; under a host
// compiler they are plain inline functions (the CPU tests of K1v).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GLOB_DP_HD __host__ __device__ __forceinline__
#else
#define GLOB_DP_HD inline
#endif

#define GLOB_DP_MAX_W 64

GLOB_DP_HD bool glob_dp_match(const unsigned char* h, int w, int vlen,
                              const unsigned char* pat, int plen) {
  // positions j < vlen (vlen <= w <= 64)
  const uint64_t valid =
      vlen >= 64 ? ~0ull : (vlen <= 0 ? 0ull : ((1ull << vlen) - 1ull));
  // dp positions 0..w: `lo` keeps 0..63, `hi` bit 0 is position 64
  const uint64_t lo_span = w >= 63 ? ~0ull : ((1ull << (w + 1)) - 1ull);
  const uint64_t hi_span = w >= 64 ? 1ull : 0ull;
  uint64_t lo = 1ull, hi = 0ull;
  for (int p = 0; p < plen; ++p) {
    const unsigned char c = pat[p];
    if (c == '*') {
      if (lo != 0ull) {
        lo = ~((lo & (~lo + 1ull)) - 1ull) & lo_span;
        hi = hi_span;
      }
      // lo == 0: the prefix-OR of `hi` alone is `hi`
    } else {
      uint64_t m = valid;
      if (c != '?') {
        uint64_t eq = 0ull;
#pragma unroll
        for (int j = 0; j < GLOB_DP_MAX_W; ++j)
          eq |= static_cast<uint64_t>(h[j] == c) << j;
        m &= eq;
      }
      const uint64_t step = lo & m;  // positions < vlen <= w only
      hi = step >> 63;
      lo = step << 1;
    }
  }
  return vlen >= 64 ? (hi & 1ull) != 0ull
                    : (vlen >= 0 && ((lo >> vlen) & 1ull) != 0ull);
}

// No byte at or above 0x80 among the first vlen: '?' matches a rune, so
// over non-ASCII bytes the byte DP does not decide.
GLOB_DP_HD bool glob_ascii_ok(const unsigned char* h, int vlen) {
  const uint64_t valid =
      vlen >= 64 ? ~0ull : (vlen <= 0 ? 0ull : ((1ull << vlen) - 1ull));
  uint64_t high = 0ull;
#pragma unroll
  for (int j = 0; j < GLOB_DP_MAX_W; ++j)
    high |= static_cast<uint64_t>(h[j] >= 0x80) << j;
  return (high & valid) == 0ull;
}
