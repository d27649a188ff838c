// K4h's counting step (k4_status_hist.cu), host and device code: the
// per-thread byte counters over a block's rows and their reduction.
// k4_count_host.cpp runs the same functions on the CPU for the tests.
//
// A thread owns Q words of 4 consecutive status bytes of a row (one
// column group of 4Q columns) and walks rows with a stride.  For each
// word it adds, per code c < n_codes <= K4_SWAR_CODES, 0x01 to byte j of
// cnt[c][q] when byte j holds c (SWAR: three bit planes of the byte and
// an in-range flag, two logic operations and one add per code; a code
// outside [0, n_codes), negative codes included, matches no plane).  A
// byte counter takes at most K4_ROUND rows, so a block counts in rounds
// of K4_ROUND row steps and then reduces: every thread's counters go to
// shared memory, and each (group, code, word) sums the byte counters of
// the block's threads on its group in two 16-bit lanes per word (at
// most 256 threads x 255 < 2^16).  Rows past the end, rows whose row
// mask is 0 and columns past the last count nowhere (K4_NONE).

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define K4_HD __host__ __device__ __forceinline__
#else
#define K4_HD inline
#endif

#define K4_SWAR_CODES 8
#define K4_ROUND 255
#define K4_NONE 0xFFFFFFFFu

// one call's statuses (int8 [rows, cols], row stride `stride` bytes,
// unit column stride) and row mask (uint8, stride `rv_stride`, or null)
struct K4Args {
  const int8_t* st;
  long long stride;
  const uint8_t* rv;
  long long rv_stride;
  long long rows;
  int cols;
  int n_codes;
  int aligned;  // word loads allowed: 16-byte (Q = 4) or 4-byte (Q = 1)
};

// a block's share of one column tile: first column, columns, groups of
// 4Q columns, and rows per pass (threads / groups)
struct K4Tile {
  int col0;
  int tcols;
  int ng;
  int rpp;
};

K4_HD K4Tile k4_tile(int cols, int tile_cols, int tile, int q_words,
                     int threads) {
  K4Tile t;
  t.col0 = tile * tile_cols;
  t.tcols = cols - t.col0 < tile_cols ? cols - t.col0 : tile_cols;
  t.ng = (t.tcols + 4 * q_words - 1) / (4 * q_words);
  t.rpp = threads / t.ng;
  return t;
}

// columns col..col+3 of a row as one little-endian word, byte 0xFF (a
// code that counts nowhere) past `cols`
K4_HD uint32_t k4_word(const int8_t* row, int col, int cols, int aligned) {
  if (col + 4 <= cols) {
#ifdef __CUDA_ARCH__
    if (aligned) return *reinterpret_cast<const uint32_t*>(row + col);
#else
    (void)aligned;
    uint32_t w;
    memcpy(&w, row + col, 4);
    return w;
#endif
  }
  uint32_t w = 0u;
  for (int j = 0; j < 4; ++j) {
    const uint32_t b =
        col + j < cols ? static_cast<uint32_t>(static_cast<uint8_t>(row[col + j]))
                       : 0xFFu;
    w |= b << (8 * j);
  }
  return w;
}

template <int Q>
K4_HD void k4_words(const int8_t* row, int col, int cols, int aligned,
                    uint32_t* w) {
#ifdef __CUDA_ARCH__
  if (Q == 4 && aligned && col + 16 <= cols) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + col);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    return;
  }
#endif
  for (int q = 0; q < Q; ++q) w[q] = k4_word(row, col + 4 * q, cols, aligned);
}

// 0x01 in each byte of w that holds a code in [0, n_codes), n_codes <= 8:
// (b | 0x80) - n borrows from no other byte, and its top bit is clear
// exactly when b & 0x7F < n
K4_HD uint32_t k4_in_range(uint32_t w, int n_codes) {
  const uint32_t d =
      (w | 0x80808080u) - 0x01010101u * static_cast<uint32_t>(n_codes);
  return ((~d & ~w) >> 7) & 0x01010101u;
}

// cnt[c * Q + q] += 0x01 in byte j for each byte j of word q holding c
template <int Q>
K4_HD void k4_count(const uint32_t* w, int n_codes, uint32_t* cnt) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const uint32_t r = k4_in_range(w[q], n_codes);
    // bit 0 of each byte of b_k is bit k of that byte (r keeps bit 0 only)
    const uint32_t b0 = w[q], b1 = w[q] >> 1, b2 = w[q] >> 2;
#pragma unroll
    for (int c = 0; c < K4_SWAR_CODES; ++c)
      if (c < n_codes)
        cnt[c * Q + q] += r & ((c & 1) ? b0 : ~b0) & ((c & 2) ? b1 : ~b1) &
                          ((c & 4) ? b2 : ~b2);
  }
}

// Thread `sub`'s (row in the pass) counters for its group `g` over the
// row steps i0 <= i < i0 + n (n <= K4_ROUND) of a block whose first row
// is `row0`: rows row0 + sub + i * step.
template <int Q>
K4_HD void k4_round(const K4Args& a, const K4Tile& tl, int g, int sub,
                    long long row0, long long step, long long i0, int n,
                    uint32_t* cnt) {
  for (int i = 0; i < K4_SWAR_CODES * Q; ++i) cnt[i] = 0u;
  const int col = tl.col0 + g * 4 * Q;
  long long r = row0 + sub + i0 * step;
#pragma unroll 4
  for (int i = 0; i < n; ++i, r += step) {
    uint32_t w[Q];
    if (r < a.rows) {
      // the row mask and the statuses are loaded independently, the
      // mask applied after
      k4_words<Q>(a.st + r * a.stride, col, a.cols, a.aligned, w);
      if (a.rv != nullptr && a.rv[r * a.rv_stride] == 0)
        for (int q = 0; q < Q; ++q) w[q] = K4_NONE;
    } else {
      for (int q = 0; q < Q; ++q) w[q] = K4_NONE;
    }
    k4_count<Q>(w, a.n_codes, cnt);
  }
}

// The counts of output o of a round's reduction: o = (c * Q + q) * ng +
// g, summed over the tile's rpp threads of group g, whose counters lie
// at red[(c * Q + q) * threads + g + k * ng]; count[j] is column
// col0 + 4Q g + 4q + j, code c.
K4_HD void k4_reduce(const uint32_t* red, int threads, const K4Tile& tl,
                     int o, uint32_t* count) {
  const int g = o % tl.ng, cq = o / tl.ng;
  const uint32_t* p = red + static_cast<long long>(cq) * threads + g;
  uint32_t lo = 0u, hi = 0u;
  for (int k = 0; k < tl.rpp; ++k) {
    const uint32_t v = p[k * tl.ng];
    lo += v & 0x00FF00FFu;
    hi += (v >> 8) & 0x00FF00FFu;
  }
  count[0] = lo & 0xFFFFu;
  count[1] = hi & 0xFFFFu;
  count[2] = lo >> 16;
  count[3] = hi >> 16;
}
