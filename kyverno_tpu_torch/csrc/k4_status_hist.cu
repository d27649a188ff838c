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
// Design: a grid-stride loop over the (row, column) cells of one column
// tile, consecutive threads on consecutive bytes of the row-major
// [R, P] int8 matrix.  Each block keeps a private histogram of its
// tile's P_tile x C counters in shared memory (32-bit; a block never
// counts 2^32 cells), adds into it with shared-memory atomics, and at
// the end adds each non-zero counter once into the global int64 output
// (atomicAdd on unsigned long long; the wrapper zeroes it first).  When
// P x C counters pass the shared-memory budget the columns are cut into
// tiles, one tile per blockIdx.y.  Integer sums have no rounding, so the
// result is exact whatever order the atomics land in.
//
// Bound on an H100: bytes.  The statuses are read once (R x P bytes),
// the row mask once per row, and P x C int64 counts are written; each
// cell costs one compare and one shared-memory atomic, far under the
// card's integer rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block may use without opting in to more
constexpr int kSmemBytes = 48 * 1024;
// cells per thread before the grid stops growing
constexpr int kCellsPerThread = 8;
// enough resident blocks to fill 132 SMs
constexpr int kMaxBlocks = 132 * 8;

__global__ void status_hist_kernel(const int8_t* __restrict__ statuses,
                                   const uint8_t* __restrict__ rowvalid,
                                   unsigned long long* __restrict__ out,
                                   long long rows, int cols, int n_codes,
                                   int tile_cols) {
  extern __shared__ unsigned int hist[];
  const int col0 = blockIdx.y * tile_cols;
  const int tcols = min(tile_cols, cols - col0);
  const int nbins = tcols * n_codes;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  const long long cells = rows * tcols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    const long long r = i / tcols;
    const int c = static_cast<int>(i - r * tcols);
    if (rowvalid != nullptr && rowvalid[r] == 0) continue;
    const int code = statuses[r * cols + col0 + c];
    if (code >= 0 && code < n_codes) {
      atomicAdd(&hist[c * n_codes + code], 1u);
    }
  }
  __syncthreads();
  unsigned long long* tile_out = out + static_cast<long long>(col0) * n_codes;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const unsigned int v = hist[i];
    if (v != 0u) atomicAdd(&tile_out[i], static_cast<unsigned long long>(v));
  }
}

}  // namespace

// statuses: int8 [rows, cols]; rowvalid: uint8 [rows] or NULL for no
// mask; out: int64 [cols, n_codes], zeroed by the caller; all contiguous
// on the current device.  Requires rows >= 0, cols >= 0 and
// 1 <= n_codes <= kSmemBytes / 4.  Returns 0 or the CUDA error of the
// launch.
extern "C" int k4_status_hist(const void* statuses, const void* rowvalid,
                              void* out, long long rows, int cols,
                              int n_codes, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int max_bins = kSmemBytes / static_cast<int>(sizeof(unsigned int));
  if (n_codes <= 0 || n_codes > max_bins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_cols = cols < max_bins / n_codes ? cols : max_bins / n_codes;
  const int tiles = (cols + tile_cols - 1) / tile_cols;
  const long long cells = rows * tile_cols;
  const long long want =
      (cells + static_cast<long long>(kThreads) * kCellsPerThread - 1) /
      (static_cast<long long>(kThreads) * kCellsPerThread);
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = static_cast<size_t>(tile_cols) * n_codes *
                      sizeof(unsigned int);
  status_hist_kernel<<<dim3(blocks, tiles), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(statuses),
      static_cast<const uint8_t*>(rowvalid),
      static_cast<unsigned long long*>(out), rows, cols, n_codes, tile_cols);
  return static_cast<int>(cudaGetLastError());
}
