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
// (positions 0..63 in `lo`, position 64 in bit 0 of `hi`), and '*' is a
// prefix-OR: every bit at or above the lowest set bit, clipped to
// position w.
//
// The pattern comes compiled (ops/kernels.py glob_program): a flags byte
// (bit 0: the pattern holds a '?'), then tokens, 0 for a run of '*'
// (one star: a prefix-OR is idempotent) and L in 1..255 for a run of L
// bytes that follow, '?' among them matching any byte.  A run of L
// steps is one step of L positions:
//
//     dp = (dp & M) << L,   M = (j + L - 1 < vlen) & AND_k (eq[c_k] >> k)
//
// over the literal bytes c_k of the run, eq[c][j] = (head[j] == c).
// The value's bytes come as little-endian 32-bit words, only the
// ceil(vlen / 4) that hold its first vlen bytes (glob_load: aligned
// loads on the card, whatever the window's alignment); eq[c] is built
// from them four bytes at a time (SWAR zero-byte test, then a multiply
// that gathers the four flags), so a literal costs about 11 word
// operations per 4 bytes of the value, not a compare per window byte.
// Bytes at or past vlen may be anything: every mask is clipped to
// positions below vlen.  The word arrays are indexed by loop counters of
// unrolled loops only, so a caller's array stays in registers.
//
// Under nvcc the functions are host and device code; under a host
// compiler they are plain inline functions (the CPU tests of K1v).  The
// one device-only branch is glob_load's; its host branch assembles the
// same first n bytes from byte loads.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GLOB_DP_HD __host__ __device__ __forceinline__
#else
#define GLOB_DP_HD inline
#endif

#define GLOB_DP_MAX_W 64
#define GLOB_DP_WORDS 16
#define GLOB_STAR 0
#define GLOB_HAS_Q 1
// the host loader's byte past a value: non-ASCII, and the first byte of
// 'é', which the tests' patterns hold
#define GLOB_POISON 0xC3

// words[k] = bytes 4k..4k+3 of p, for 4k < n; bytes at or past n, and
// the words past them, are left unspecified.
GLOB_DP_HD void glob_load(const unsigned char* p, int n, uint32_t* words) {
#ifdef __CUDA_ARCH__
  if (n <= 0) return;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3u);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(p - off);
  if (off == 0) {
#pragma unroll
    for (int k = 0; k < GLOB_DP_WORDS; ++k)
      if (4 * k < n) words[k] = a[k];
    return;
  }
  // word k straddles aligned words k and k + 1; the second is read only
  // when one of the first n bytes lies in it
  uint32_t cur = a[0];
#pragma unroll
  for (int k = 0; k < GLOB_DP_WORDS; ++k) {
    if (4 * k < n) {
      const int last = min(4 * k + 3, n - 1);
      const uint32_t nxt = off + last >= 4 * k + 4 ? a[k + 1] : 0u;
      words[k] = __funnelshift_r(cur, nxt, 8 * off);
      cur = nxt;
    }
  }
#else
  // bytes past n get GLOB_POISON, as the card's loads bring whatever
  // follows the value: a mask that reads past vlen shows in the tests
  for (int k = 0; k < GLOB_DP_WORDS; ++k) {
    if (4 * k >= n) break;
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i)
      v |= static_cast<uint32_t>(4 * k + i < n ? p[4 * k + i] : GLOB_POISON)
           << (8 * i);
    words[k] = v;
  }
#endif
}

// positions j < vlen (0 <= vlen <= 64)
GLOB_DP_HD uint64_t glob_valid(int vlen) {
  return vlen >= 64 ? ~0ull : (vlen <= 0 ? 0ull : ((1ull << vlen) - 1ull));
}

// bit j: byte j of the value equals c (bits at or past vlen unspecified)
GLOB_DP_HD uint64_t glob_eq_mask(const uint32_t* words, int vlen,
                                 unsigned char c) {
  const uint32_t rep = 0x01010101u * c;
  uint64_t eq = 0ull;
#pragma unroll
  for (int k = 0; k < GLOB_DP_WORDS; ++k) {
    if (4 * k < vlen) {
      const uint32_t x = words[k] ^ rep;
      // 0x80 in each byte of x that is zero, exactly (no carry between
      // bytes: the low seven bits are summed alone)
      const uint32_t z =
          ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
      // flags at bits 0, 8, 16, 24 -> bits 21..24, no two products overlap
      const uint32_t nib = (((z >> 7) * 0x00204081u) >> 21) & 0xFu;
      eq |= static_cast<uint64_t>(nib) << (4 * k);
    }
  }
  return eq;
}

// a byte at or above 0x80 among the first vlen: '?' matches a rune, so
// over non-ASCII bytes the byte DP does not decide
GLOB_DP_HD bool glob_high(const uint32_t* words, int vlen) {
  uint32_t high = 0u;
#pragma unroll
  for (int k = 0; k < GLOB_DP_WORDS; ++k) {
    if (4 * k < vlen) {
      const int left = vlen - 4 * k;
      const uint32_t keep = left >= 4 ? ~0u : ((1u << (8 * left)) - 1u);
      high |= words[k] & keep & 0x80808080u;
    }
  }
  return high != 0u;
}

// The DP over the tokens tok[0..n) (a compiled pattern less its flags
// byte) and the value's words; vlen = min(str_len, w).
GLOB_DP_HD bool glob_dp_match(const uint32_t* words, int w, int vlen,
                              const unsigned char* tok, int n) {
  if (vlen < 0) return false;
  const uint64_t valid = glob_valid(vlen);
  const uint64_t lo_span = w >= 63 ? ~0ull : ((1ull << (w + 1)) - 1ull);
  const uint64_t hi_span = w >= 64 ? 1ull : 0ull;
  uint64_t lo = 1ull, hi = 0ull;
  for (int p = 0; p < n;) {
    const int len = tok[p++];
    if (len == GLOB_STAR) {
      if (lo != 0ull) {
        lo = ~((lo & (~lo + 1ull)) - 1ull) & lo_span;
        hi = hi_span;
      }
      // lo == 0: the prefix-OR of `hi` alone is `hi`
      continue;
    }
    // a run of len steps from positions j with j + len - 1 < vlen <= 64;
    // once no position is left the match fails, whatever follows
    if (len > vlen) return false;
    uint64_t m = lo & (valid >> (len - 1));
    for (int k = 0; k < len && m != 0ull; ++k) {
      const unsigned char c = tok[p + k];
      if (c != '?') m &= glob_eq_mask(words, vlen, c) >> k;
    }
    if (m == 0ull) return false;
    p += len;
    // positions j + len <= vlen: position 64 only when len reaches it
    hi = (m >> (64 - len)) & 1ull;
    lo = len >= 64 ? 0ull : m << len;
  }
  return vlen >= 64 ? (hi & 1ull) != 0ull : ((lo >> vlen) & 1ull) != 0ull;
}

// K1c's Kleene verdict (bit 0 known true, bit 1 known false) of the
// compiled pattern prog[0..plen) against one value: decidable only
// inside the window and, for patterns with '?', only over ASCII bytes (a
// rune is wider than a byte); t = conv & decidable & matched,
// f = !array & (!conv | (decidable & !matched)).
GLOB_DP_HD uint8_t glob_kleene(const uint32_t* words, int w, int64_t slen,
                               int tag, unsigned conv_tags, int array_tag,
                               const unsigned char* prog, int plen) {
  const int vlen = slen < w ? static_cast<int>(slen) : w;
  const bool matched = glob_dp_match(words, w, vlen, prog + 1, plen - 1);
  const bool ascii_ok = !(prog[0] & GLOB_HAS_Q) || !glob_high(words, vlen);
  const bool conv = tag >= 0 && tag < 32 && ((conv_tags >> tag) & 1u) != 0u;
  const bool arrayish = tag == array_tag;
  const bool decid = slen <= w && ascii_ok;
  const bool t = conv && decid && matched;
  const bool f = !arrayish && (!conv || (decid && !matched));
  return static_cast<uint8_t>((t ? 1 : 0) | (f ? 2 : 0));
}
