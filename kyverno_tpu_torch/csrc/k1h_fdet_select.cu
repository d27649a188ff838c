// K1h: compact fail-detail select, one warp per row.
//
// Replaces kyverno_tpu/ops/eval.py evaluate_packed (the fixed-budget
// fail-detail select at :1797-1807):
//
//     keys  = where(rel, col, C)            # [R, C]
//     order = sort(keys, axis=1)[:, :k]     # first k relevant columns
//     fds   = take_along_axis(fdet_u, min(order, C - 1), axis=1)
//     out32 = concatenate([order, fds], axis=1)        # [R, 2k] int32
//
// A sort is the general tool; here the keys are the column indices
// themselves, so the sorted prefix is just the relevant columns in
// ascending order: a per-row stream compaction.  Each warp walks its
// row 32 columns at a time, __ballot_sync marks the relevant lanes and
// __popc of the ballot below a lane gives that lane's output slot.  The
// walk stops once k slots are filled.  Slots past the row's relevant
// count hold C in `order` and fdet_u[row, C - 1] in `fds`, which is what
// the sort + clamped gather produce.
//
// Bound on an H100: bytes.  Per row the kernel reads the C relevance
// bytes, the <= k selected fail-detail cells (plus one fill cell) and
// writes 2k int32; there is no arithmetic to speak of.  Reading the
// relevance mask one byte per lane keeps each warp's loads within one
// 32-byte sector per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fdet_select_kernel(const uint8_t* __restrict__ rel,
                                   const int32_t* __restrict__ fdet,
                                   int32_t* __restrict__ out,
                                   int rows, int cols, int k) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const uint8_t* rrow = rel + static_cast<size_t>(row) * cols;
  const int32_t* frow = fdet + static_cast<size_t>(row) * cols;
  int32_t* orow = out + static_cast<size_t>(row) * 2 * k;
  const unsigned below = (1u << lane) - 1u;
  int found = 0;  // uniform: every lane adds the same popcount
  for (int base = 0; base < cols && found < k; base += 32) {
    const int col = base + lane;
    const bool hit = col < cols && rrow[col] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int slot = found + __popc(ballot & below);
      if (slot < k) {
        orow[slot] = col;
        orow[k + slot] = frow[col];
      }
    }
    found += __popc(ballot);
  }
  const int32_t fill_fd = frow[cols - 1];
  for (int slot = found + lane; slot < k; slot += 32) {
    orow[slot] = cols;
    orow[k + slot] = fill_fd;
  }
}

}  // namespace

// rel: bool [rows, cols] (one byte per cell), fdet: int32 [rows, cols],
// out: int32 [rows, 2k], all contiguous on the current device; requires
// 1 <= k <= cols.  Returns 0 or the CUDA error of the launch.
extern "C" int k1h_fdet_select(const void* rel, const void* fdet, void* out,
                               int rows, int cols, int k, void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0 || k <= 0 || k > cols) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fdet_select_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rel), static_cast<const int32_t*>(fdet),
      static_cast<int32_t*>(out), rows, cols, k);
  return static_cast<int>(cudaGetLastError());
}
