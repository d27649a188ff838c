// K1h: the tail of a K1 call, one warp per row.
//
// Replaces the end of kyverno_tpu/ops/eval.py evaluate_packed
// (:1789-1815), which XLA fuses after the status trees:
//
//     rel   = (s_u == FAIL) & (match != 0) & (rowvalid != 0)[:, None]
//     rel   = concatenate([rel] + [broadcast(rel[:, u:u+1], cnt)
//                                  for u, cnt in uniq_any], axis=1)
//     keys  = where(rel, col, C)            # [R, C]
//     order = sort(keys, axis=1)[:, :k]     # first k relevant columns
//     fds   = take_along_axis(fdet_u, min(order, C - 1), axis=1)
//     out32 = concatenate([order, fds], axis=1)        # [R, 2k] int32
//     out8  = concatenate([s_u, d_u, adm], axis=1)     # [R, 2U + A] int8
//
// In the port that tail was ~20 eager torch ops around a select kernel;
// here it is one launch that reads K1v's outputs and the two lanes where
// they lie and writes one allocation.
//
// * Relevance is read, not materialised: column c belongs to unique
//   tree src[c] (c itself for c < U; the tree of each `uniq_any` child
//   column past U), so lane c tests s_u[row, src[c]] == FAIL and
//   match[row, src[c]] != 0.  `match` and `rowvalid` are lanes of the
//   packed batch: a pointer to the lane's first column and the buffer's
//   row stride, no copy.
// * A sort is the general tool; here the keys are the column indices
//   themselves, so the sorted prefix is just the relevant columns in
//   ascending order: a per-row stream compaction.  Each warp walks its
//   row 32 columns at a time, __ballot_sync marks the relevant lanes and
//   __popc of the ballot below a lane gives that lane's output slot.  The
//   walk stops once k slots are filled.  Slots past the row's relevant
//   count hold C in `order` and fdet_u[row, C - 1] in `fds`, which is
//   what the sort and the clamped gather produce.
// * Each output row is the out8 row (n8 = 2U + A bytes), zero padding to
//   a 4-byte boundary, then the out32 row: one contiguous write per row,
//   and one copy back to the host for the whole call.
//
// Bound on an H100: bytes.  Per row the kernel reads s_u, d_u and adm
// (n8 bytes), the U match bytes and one rowvalid byte, the <= k selected
// fail-detail cells (plus one fill cell), and writes the row; there is
// no arithmetic to speak of.  The src table (4C bytes) stays in L1.  At
// the admission shape (64 rows) the launch itself is the floor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fdet_select_kernel(
    const int8_t* __restrict__ s_u, const int8_t* __restrict__ d_u,
    const int8_t* __restrict__ adm, const int32_t* __restrict__ fdet,
    const uint8_t* __restrict__ match, long long match_stride,
    const uint8_t* __restrict__ rowvalid, long long rowvalid_stride,
    const int32_t* __restrict__ src, int8_t* __restrict__ out,
    long long out_stride, int rows, int n_uniq, int n_adm, int cols, int k,
    int out32_off, int fail) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const int8_t* srow = s_u + static_cast<size_t>(row) * n_uniq;
  const int8_t* drow = d_u + static_cast<size_t>(row) * n_uniq;
  const int8_t* arow = adm + static_cast<size_t>(row) * n_adm;
  int8_t* orow = out + static_cast<size_t>(row) * out_stride;
  // the out8 row, then zeros up to the out32 row
  const int n8 = 2 * n_uniq + n_adm;
  for (int j = lane; j < out32_off; j += 32) {
    int8_t v = 0;
    if (j < n_uniq) v = srow[j];
    else if (j < 2 * n_uniq) v = drow[j - n_uniq];
    else if (j < n8) v = arow[j - 2 * n_uniq];
    orow[j] = v;
  }
  if (k <= 0) return;
  int32_t* o32 = reinterpret_cast<int32_t*>(orow + out32_off);
  const int32_t* frow = fdet + static_cast<size_t>(row) * cols;
  const uint8_t* mrow = match + static_cast<size_t>(row) * match_stride;
  const bool live = rowvalid == nullptr ||
      rowvalid[static_cast<size_t>(row) * rowvalid_stride] != 0;
  const unsigned below = (1u << lane) - 1u;
  int found = 0;  // uniform: every lane adds the same popcount
  for (int base = 0; live && base < cols && found < k; base += 32) {
    const int col = base + lane;
    bool hit = false;
    if (col < cols) {
      const int u = src[col];
      hit = srow[u] == fail && mrow[u] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int slot = found + __popc(ballot & below);
      if (slot < k) {
        o32[slot] = col;
        o32[k + slot] = frow[col];
      }
    }
    found += __popc(ballot);
  }
  const int32_t fill_fd = frow[cols - 1];
  for (int slot = found + lane; slot < k; slot += 32) {
    o32[slot] = cols;
    o32[k + slot] = fill_fd;
  }
}

}  // namespace

// s_u, d_u: int8 [rows, n_uniq]; adm: int8 [rows, n_adm]; fdet: int32
// [rows, cols]; src: int32 [cols], each entry in [0, n_uniq); all
// contiguous on the current device.  match: the __match__ lane's first
// column, row stride match_stride bytes, n_uniq bytes a row; rowvalid:
// the __rowvalid__ lane (row stride rowvalid_stride) or null for every
// row.  out: int8 [rows, out_stride], out_stride = out32_off + 8k,
// out32_off = 2 * n_uniq + n_adm rounded up to 4.  Requires 0 <= k <=
// cols.  Returns 0 or the CUDA error of the launch.
extern "C" int k1h_fdet_select(const void* s_u, const void* d_u,
                               const void* adm, const void* fdet,
                               const void* match, long long match_stride,
                               const void* rowvalid,
                               long long rowvalid_stride, const void* src,
                               void* out, int rows, int n_uniq, int n_adm,
                               int cols, int k, long long out_stride,
                               int out32_off, int fail, void* stream) {
  if (rows <= 0 || out_stride <= 0) return 0;
  if (k < 0 || k > cols || out32_off < 2 * n_uniq + n_adm ||
      out32_off % 4 != 0 || out_stride != out32_off + 8LL * k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fdet_select_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s_u), static_cast<const int8_t*>(d_u),
      static_cast<const int8_t*>(adm), static_cast<const int32_t*>(fdet),
      static_cast<const uint8_t*>(match), match_stride,
      static_cast<const uint8_t*>(rowvalid), rowvalid_stride,
      static_cast<const int32_t*>(src), static_cast<int8_t*>(out),
      out_stride, rows, n_uniq, n_adm, cols, k, out32_off, fail);
  return static_cast<int>(cudaGetLastError());
}
