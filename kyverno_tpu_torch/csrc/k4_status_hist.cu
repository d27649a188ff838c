// K4h: per-rule verdict histogram of the sharded scan step.
//
// Replaces the reduction body of kyverno_tpu/parallel/mesh.py
// build_sharded_evaluator.step (:70-74):
//
//     one_hot = jax.nn.one_hot(statuses, n_codes, dtype=int32)  # [R, P, C]
//     one_hot = one_hot * (rowmask != 0)[:, None, None]
//     summary = sum(one_hot, axis=0)                            # [P, C]
//
// summary[p, c] counts the rows r with statuses[r, p] == c and
// rowvalid[r] != 0 (no mask when rowvalid is absent).  jax.nn.one_hot
// gives an all-zero row for a code outside [0, C), negative codes
// included, so such a cell counts nowhere: it is neither clamped nor
// written.  The cross-device psum that followed the sum in JAX is a
// torch.distributed all_reduce outside this kernel.
//
// Bound on an H100: bytes (R x P status bytes and R mask bytes read, P x
// C int64 written).  Design:
//
// * Counts in registers (k4_count.cuh).  A thread owns a group of 16
//   consecutive columns of a row (one 16-byte load, where the base and
//   the row stride are multiples of 16) or of 4 (a 4-byte load where
//   they are multiples of 4, else byte loads; narrower at the last
//   columns), and walks rows with a stride: no division and no atomic
//   per cell.  Per code it keeps a word of four byte counters per 4
//   columns, added to with SWAR logic; a block counts in rounds of at
//   most 255 row steps, reduces its threads' counters in shared memory
//   and adds each non-zero (column, code) count once, with a 64-bit
//   atomic, into a workspace accumulator.  Up to K4_SWAR_CODES codes;
//   past that a block keeps a shared-memory histogram of its column
//   tile and adds into it per cell (the first port's design).
// * Inputs where they lie: the statuses and the row mask are each a
//   pointer and a row stride, so the mask lane is read inside its packed
//   buffer and nothing is copied first.
// * One launch, no host sync: the workspace (uint64, a ticket and then
//   the C x P accumulator) is zero before a launch, allocated zeroed
//   once per device and stream by the wrapper (two streams never share
//   one).  Each block fences its atomics and takes a ticket; the block
//   that takes the last ticket copies the accumulator into the output
//   (torch.empty: no fill kernel) with atomic exchanges that leave it
//   zero, and resets the ticket.  Integer sums are exact in any order.
//
// When P x 4 columns exceed a block's threads (or, on the shared-memory
// path, P x C counters its budget) the columns are cut into tiles, one
// per blockIdx.y.

#include <cstdint>
#include <cuda_runtime.h>

#include "k4_count.cuh"

namespace {

constexpr int kThreads = 256;
// shared memory a block may use without opting in to more
constexpr int kSmemBytes = 48 * 1024;
// row steps a thread takes at least before the grid stops growing: few,
// so that a step's small batch spreads over many blocks (its time is
// the chain of loads, reduction, atomics and the last block's copy)
constexpr int kMinSteps = 2;
// blocks of the shared-memory path (and of the counting path should the
// occupancy query fail): 4 of 256 threads on each of 132 SMs
constexpr int kMaxBlocks = 132 * 4;

// The last block to finish (by a ticket taken after its atomics are
// fenced) moves the accumulator into `out` and leaves it and the ticket
// zero for the next launch on this stream.  `flag` is a word of the
// block's dynamic shared memory, free once the block's counts are in
// (no static shared memory: the histogram path may use all 48 KB).
__device__ __forceinline__ void k4_finish(unsigned long long* ticket,
                                          unsigned long long* acc,
                                          long long* out, long long nbins,
                                          uint32_t* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long blocks =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    *flag = atomicAdd(ticket, 1ull) == blocks - 1ull;
  }
  __syncthreads();
  if (*flag == 0u) return;
  __threadfence();
  for (long long i = threadIdx.x; i < nbins; i += blockDim.x)
    out[i] = static_cast<long long>(atomicExch(&acc[i], 0ull));
  if (threadIdx.x == 0) atomicExch(ticket, 0ull);
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
status_hist_kernel(const K4Args a, int tile_cols,
                   unsigned long long* __restrict__ ws,
                   long long* __restrict__ out) {
  extern __shared__ uint32_t red[];  // [n_codes * Q][kThreads]
  unsigned long long* acc = ws + 1;
  const K4Tile tl = k4_tile(a.cols, tile_cols, blockIdx.y, Q, kThreads);
  const int t = threadIdx.x;
  const int g = t % tl.ng, sub = t / tl.ng;
  const long long step = static_cast<long long>(gridDim.x) * tl.rpp;
  const long long row0 = static_cast<long long>(blockIdx.x) * tl.rpp;
  const long long steps = a.rows > row0 ? (a.rows - row0 + step - 1) / step
                                        : 0;
  for (long long i0 = 0; i0 < steps; i0 += K4_ROUND) {
    const int n = static_cast<int>(steps - i0 < K4_ROUND ? steps - i0
                                                         : K4_ROUND);
    uint32_t cnt[K4_SWAR_CODES * Q];
    if (sub < tl.rpp) {
      k4_round<Q>(a, tl, g, sub, row0, step, i0, n, cnt);
    } else {
#pragma unroll
      for (int i = 0; i < K4_SWAR_CODES * Q; ++i) cnt[i] = 0u;
    }
#pragma unroll
    for (int c = 0; c < K4_SWAR_CODES; ++c)
      if (c < a.n_codes)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          red[(c * Q + q) * kThreads + t] = cnt[c * Q + q];
    __syncthreads();
    for (int o = t; o < a.n_codes * Q * tl.ng; o += kThreads) {
      uint32_t count[4];
      k4_reduce(red, kThreads, tl, o, count);
      const int cq = o / tl.ng;
      const int c = cq / Q;
      const int col = tl.col0 + (o % tl.ng) * 4 * Q + 4 * (cq % Q);
      for (int j = 0; j < 4; ++j)
        if (count[j] != 0u && col + j < a.cols)
          atomicAdd(&acc[static_cast<long long>(col + j) * a.n_codes + c],
                    static_cast<unsigned long long>(count[j]));
    }
    __syncthreads();
  }
  k4_finish(ws, acc, out, static_cast<long long>(a.cols) * a.n_codes, red);
}

// n_codes > K4_SWAR_CODES: a shared-memory histogram of the column tile
// (32-bit counters; a block never counts 2^32 cells), one atomic per cell
__global__ void __launch_bounds__(kThreads)
status_hist_kernel_shared(const K4Args a, int tile_cols,
                          unsigned long long* __restrict__ ws,
                          long long* __restrict__ out) {
  extern __shared__ uint32_t hist[];  // [tcols][n_codes]
  unsigned long long* acc = ws + 1;
  const int col0 = blockIdx.y * tile_cols;
  const int tcols = min(tile_cols, a.cols - col0);
  const int nbins = tcols * a.n_codes;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  const int lanes = min(tcols, kThreads);
  const int rpp = kThreads / lanes;
  const int sub = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  if (sub < rpp) {
    const long long step = static_cast<long long>(gridDim.x) * rpp;
    for (long long r = static_cast<long long>(blockIdx.x) * rpp + sub;
         r < a.rows; r += step) {
      if (a.rv != nullptr && a.rv[r * a.rv_stride] == 0) continue;
      const int8_t* row = a.st + r * a.stride + col0;
      for (int c = lane; c < tcols; c += lanes) {
        const int code = row[c];
        if (code >= 0 && code < a.n_codes)
          atomicAdd(&hist[c * a.n_codes + code], 1u);
      }
    }
  }
  __syncthreads();
  unsigned long long* tile_acc = acc + static_cast<long long>(col0) * a.n_codes;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const unsigned int v = hist[i];
    if (v != 0u) atomicAdd(&tile_acc[i], static_cast<unsigned long long>(v));
  }
  k4_finish(ws, acc, out, static_cast<long long>(a.cols) * a.n_codes, hist);
}

// blocks of a column tile: kMinSteps row steps each at least, at most
// `most` over all tiles
int grid_x(long long rows, int rpp, int tiles, int most) {
  const long long want = (rows + static_cast<long long>(rpp) * kMinSteps - 1) /
                         (static_cast<long long>(rpp) * kMinSteps);
  const long long cap = most / tiles > 0 ? most / tiles : 1;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// every row of the statuses starts on a multiple of m bytes
bool rows_aligned(const void* p, long long stride, long long rows, int m) {
  return reinterpret_cast<uintptr_t>(p) % m == 0 &&
         (rows == 1 || stride % m == 0);
}

// the blocks of status_hist_kernel<Q> with n_codes codes the card holds
// at once (its registers bound them), asked once per (Q, n_codes)
template <int Q>
int resident_blocks(int n_codes, size_t smem) {
  static int cached[K4_SWAR_CODES + 1];
  if (cached[n_codes] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, status_hist_kernel<Q>, kThreads, smem);
    cached[n_codes] = sms * per_sm > 0 ? sms * per_sm : kMaxBlocks;
  }
  return cached[n_codes];
}

template <int Q>
int launch_counts(const K4Args& a, unsigned long long* ws, long long* out,
                  cudaStream_t s) {
  const int tile_cols = a.cols < kThreads * 4 * Q ? a.cols : kThreads * 4 * Q;
  const int tiles = (a.cols + tile_cols - 1) / tile_cols;
  const K4Tile first = k4_tile(a.cols, tile_cols, 0, Q, kThreads);
  const size_t smem =
      static_cast<size_t>(a.n_codes) * Q * kThreads * sizeof(uint32_t);
  const int most = resident_blocks<Q>(a.n_codes, smem);
  status_hist_kernel<Q>
      <<<dim3(grid_x(a.rows, first.rpp, tiles, most), tiles), kThreads, smem,
         s>>>(a, tile_cols, ws, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// statuses: int8 [rows, cols], unit column stride, `stride` bytes from
// row to row; rowvalid: uint8, `rv_stride` bytes from row to row, or
// NULL for no mask; out: int64 [cols, n_codes], contiguous, need not be
// zeroed; ws: uint64 [1 + cols * n_codes], all zero (it is zero again
// when the launch ends); all on the current device.  Requires rows >= 0,
// cols >= 0 and 1 <= n_codes <= kSmemBytes / 4.  Returns 0 or the CUDA
// error of the launch.
extern "C" int k4_status_hist(const void* statuses, long long stride,
                              const void* rowvalid, long long rv_stride,
                              void* out, void* ws, long long rows, int cols,
                              int n_codes, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int max_bins = kSmemBytes / static_cast<int>(sizeof(uint32_t));
  if (n_codes <= 0 || n_codes > max_bins || stride < 0 || rv_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K4Args a;
  a.st = static_cast<const int8_t*>(statuses);
  a.stride = stride;
  a.rv = static_cast<const uint8_t*>(rowvalid);
  a.rv_stride = rv_stride;
  a.rows = rows;
  a.cols = cols;
  a.n_codes = n_codes;
  unsigned long long* w = static_cast<unsigned long long*>(ws);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_codes <= K4_SWAR_CODES) {
    if (cols >= 16 && rows_aligned(statuses, stride, rows, 16)) {
      a.aligned = 1;
      return launch_counts<4>(a, w, o, s);
    }
    a.aligned = rows_aligned(statuses, stride, rows, 4);
    return launch_counts<1>(a, w, o, s);
  }
  a.aligned = 0;
  const int tile_cols = cols < max_bins / n_codes ? cols : max_bins / n_codes;
  const int tiles = (cols + tile_cols - 1) / tile_cols;
  const int lanes = tile_cols < kThreads ? tile_cols : kThreads;
  const size_t smem = static_cast<size_t>(tile_cols) * n_codes *
                      sizeof(uint32_t);
  status_hist_kernel_shared<<<dim3(grid_x(rows, kThreads / lanes, tiles,
                                          kMaxBlocks),
                                   tiles),
                              kThreads, smem, s>>>(
      a, tile_cols, w, o);
  return static_cast<int>(cudaGetLastError());
}
