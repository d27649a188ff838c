// K1v: every unique status tree of a policy set over a batch, in one
// launch.  One thread per (row, tree): grid = (row tiles, kernel trees),
// so the threads of a block run the same program and never diverge on
// its control flow.  The interpreter is k1_vm.cuh; the bytecode comes
// from kyverno_tpu_torch/ops/vm.py.
//
// Bound on an H100: bytes.  Each row's lanes that the bytecode reads
// are read once from the packed buffers and each unique column is
// written once; the interpreter's work per lane is a few dozen integer
// instructions.  This first version reads rows kilobytes apart (thread r
// reads row r), so its loads are not coalesced, and it re-evaluates a
// subexpression that two trees share (the eager walk memoizes them per
// call); both are measured against the bound in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_vm.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void k1_vm_kernel(const K1vmArgs a, long long rows,
                             const int32_t* __restrict__ trees) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  k1vm_run(a, r, trees[2 * blockIdx.y]);
}

}  // namespace

// bufs: the five packed buffers (uint8, int8, bool, int32, int64; null
// for one the layout lacks), widths: their row widths in elements, both
// host arrays of 5.  code, lanes, i64, f64, bytes, trees: the program's
// device tables (ops/vm.py Program); trees holds n_trees (entry pc,
// unique column) pairs.  s_out, d_out: int8 [rows, n_uniq]; fd_out:
// int32 [rows, n_cols_u].  Returns 0 or the CUDA error of the launch.
extern "C" int k1_vm(const void* const* bufs, const long long* widths,
                     long long rows, const void* code, const void* lanes,
                     const void* i64, const void* f64, const void* bytes,
                     const void* trees, int n_trees, void* s_out,
                     void* d_out, void* fd_out, int n_uniq, int n_cols_u,
                     void* stream) {
  if (rows <= 0 || n_trees <= 0) return 0;
  if (n_trees > 65535) return static_cast<int>(cudaErrorInvalidValue);
  K1vmArgs a;
  for (int b = 0; b < 5; ++b) {
    a.buf[b] = static_cast<const unsigned char*>(bufs[b]);
    a.width[b] = widths[b];
  }
  a.code = static_cast<const int32_t*>(code);
  a.lanes = static_cast<const int32_t*>(lanes);
  a.i64 = static_cast<const int64_t*>(i64);
  a.f64 = static_cast<const double*>(f64);
  a.bytes = static_cast<const unsigned char*>(bytes);
  a.s_out = static_cast<int8_t*>(s_out);
  a.d_out = static_cast<int8_t*>(d_out);
  a.fd_out = static_cast<int32_t*>(fd_out);
  a.n_uniq = n_uniq;
  a.n_cols_u = n_cols_u;
  const dim3 grid(static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_trees));
  k1_vm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, rows, static_cast<const int32_t*>(trees));
  return static_cast<int>(cudaGetLastError());
}
