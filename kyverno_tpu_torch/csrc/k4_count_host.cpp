// K4h's counting step (k4_count.cuh) compiled for the CPU: the same
// functions as the kernel, run block by block and thread by thread in
// the order of k4_status_hist.cu's status_hist_kernel (rounds of at most
// K4_ROUND row steps, then the shared-memory reduction of each round),
// so the tests can hold the byte counters, their flush and the
// reduction against the plain histogram without a card.  Only the
// launch (which blocks run where), the atomics and the last block's
// copy are the card's own.  No entry point of the port loads this
// build; the tests compile it
//
//     g++ -std=c++17 -O1 -shared -fPIC -o k4_count_host.so k4_count_host.cpp
//
// and call k4_count_host with the kernel's arguments (host memory) plus
// the words per thread (1 or 4), the threads of a block and the blocks
// of a column tile, so a test can give a thread any number of rounds.

#include <cstdint>
#include <vector>

#include "k4_count.cuh"

namespace {

template <int Q>
void run(const K4Args& a, int threads, int grid, int64_t* out) {
  const int tile_cols = a.cols < threads * 4 * Q ? a.cols : threads * 4 * Q;
  const int tiles = (a.cols + tile_cols - 1) / tile_cols;
  std::vector<uint32_t> red;
  uint32_t cnt[K4_SWAR_CODES * Q];
  for (int tile = 0; tile < tiles; ++tile) {
    const K4Tile tl = k4_tile(a.cols, tile_cols, tile, Q, threads);
    red.assign(static_cast<size_t>(a.n_codes) * Q * threads, 0u);
    const long long step = static_cast<long long>(grid) * tl.rpp;
    for (int bx = 0; bx < grid; ++bx) {
      const long long row0 = static_cast<long long>(bx) * tl.rpp;
      const long long steps =
          a.rows > row0 ? (a.rows - row0 + step - 1) / step : 0;
      for (long long i0 = 0; i0 < steps; i0 += K4_ROUND) {
        const int n = static_cast<int>(steps - i0 < K4_ROUND ? steps - i0
                                                             : K4_ROUND);
        for (int t = 0; t < threads; ++t) {
          const int g = t % tl.ng, sub = t / tl.ng;
          for (int i = 0; i < K4_SWAR_CODES * Q; ++i) cnt[i] = 0u;
          if (sub < tl.rpp) k4_round<Q>(a, tl, g, sub, row0, step, i0, n, cnt);
          for (int c = 0; c < a.n_codes; ++c)
            for (int q = 0; q < Q; ++q)
              red[static_cast<size_t>(c * Q + q) * threads + t] = cnt[c * Q + q];
        }
        for (int o = 0; o < a.n_codes * Q * tl.ng; ++o) {
          uint32_t count[4];
          k4_reduce(red.data(), threads, tl, o, count);
          const int cq = o / tl.ng;
          const int col = tl.col0 + (o % tl.ng) * 4 * Q + 4 * (cq % Q);
          for (int j = 0; j < 4; ++j)
            if (col + j < a.cols)
              out[static_cast<long long>(col + j) * a.n_codes + cq / Q] +=
                  count[j];
        }
      }
    }
  }
}

}  // namespace

// statuses int8 [rows, cols] (row stride `stride`), rowvalid uint8
// (stride `rv_stride`) or null, out int64 [cols, n_codes] zeroed by the
// caller; 1 <= n_codes <= K4_SWAR_CODES, q_words 1 or 4, threads <= 256
// (the columns are cut into tiles of threads x 4 q_words).
// Returns 0, or -1 for arguments the kernel's counting path refuses.
extern "C" int k4_count_host(const int8_t* statuses, long long stride,
                             const uint8_t* rowvalid, long long rv_stride,
                             long long rows, int cols, int n_codes,
                             int q_words, int threads, int grid,
                             int64_t* out) {
  if (n_codes < 1 || n_codes > K4_SWAR_CODES || threads < 1 ||
      threads > 256 || grid < 1 || (q_words != 1 && q_words != 4))
    return -1;
  if (rows <= 0 || cols <= 0) return 0;
  K4Args a{statuses, stride, rowvalid, rv_stride, rows, cols, n_codes, 1};
  if (q_words == 4)
    run<4>(a, threads, grid, out);
  else
    run<1>(a, threads, grid, out);
  return 0;
}
