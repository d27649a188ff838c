// K1v: every unique status tree of a policy set over a batch, foreach
// trees included, and the per-row admission match of its eligible
// programs, in one launch.  The interpreter is k1_vm.cuh; the bytecode
// comes from kyverno_tpu_torch/ops/vm.py.
//
// Launch.  ops/vm.py packs the program's parts (a long tree's runs of
// root children, a short tree, an admission entry) into groups of
// group_warps parts, the parts of one tree always in one group.  One
// block runs one (tile of 32 rows, group): warp w runs part w of the
// group over the tile's rows, lane l on row tile * 32 + l, so the 32
// threads of a warp run one instruction stream.  The block then
// synchronizes, and the warp holding a tree's first part folds the
// tree's slots in shared memory (k1vm_fold, child order) and writes its
// columns once.  The grid is one linear x dimension over (tile, group),
// so no grid dimension limited to 65,535 counts entries.
//
// Tables on chip.  Each block first copies into shared memory what its
// warps read in the same order: its group's instruction range and lane-
// table rows (ops/vm.py lays each group's out contiguously) and the
// constant pools, then interprets from there.  A group whose tables
// exceed the program's staging budget (ops/vm.py STAGE_BYTES) reads the
// device tables instead: the global mode, chosen per group by size when
// the program is lowered.
//
// Bound on an H100: the lanes each row's bytecode reads, read once, and
// each unique column written once (bytes), or one operation per
// interpreted instruction (PERF.md).  What keeps it from either: each
// interpreted instruction is a chain of dependent loads (instruction,
// lane row, the row's value, the stacks in local memory), and thread r
// reads row r, kilobytes from its neighbours, so the value loads are not
// coalesced; a subexpression two trees share is evaluated twice.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "k1_vm.cuh"

namespace {

constexpr int kTile = 32;     // rows of a block: one warp's lanes
constexpr int kGroupCols = 5; // code_lo, code_hi, lane_lo, lane_hi, staged
constexpr int kWarpCols = 3;  // entry pc (-1: idle), parts to fold, column

// copy n 8-byte words (n counted in 8-byte words) with the block's threads
__device__ void k1vm_stage(void* dst, const void* src, long long n) {
  uint2* d = static_cast<uint2*>(dst);
  const uint2* s = static_cast<const uint2*>(src);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__global__ void k1_vm_kernel(const K1vmArgs a, const K1vmTables dev,
                             long long rows, int n_groups,
                             const int32_t* __restrict__ warps,
                             const int32_t* __restrict__ groups,
                             int n_i64, int n_f64, int n_bytes,
                             unsigned long long* executed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long tile = blockIdx.x / n_groups;
  const int group = static_cast<int>(blockIdx.x % n_groups);
  const int w = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const long long r = tile * kTile + lane;
  const int group_warps = blockDim.x / kTile;
  K1vmStatus* slots = reinterpret_cast<K1vmStatus*>(smem);
  const int32_t* g = groups + static_cast<long long>(group) * kGroupCols;
  K1vmTables t = dev;
  if (g[4]) {
    // shared memory: slots, i64, f64, lanes, code, bytes (8-byte aligned
    // sizes up to the byte pool, as ops/vm.py Program.smem_bytes counts)
    unsigned char* p = smem + group_warps * kTile * sizeof(K1vmStatus);
    int64_t* i64 = reinterpret_cast<int64_t*>(p);
    k1vm_stage(i64, dev.i64, n_i64);
    p += 8LL * n_i64;
    double* f64 = reinterpret_cast<double*>(p);
    k1vm_stage(f64, dev.f64, n_f64);
    p += 8LL * n_f64;
    int32_t* lanes = reinterpret_cast<int32_t*>(p);
    k1vm_stage(lanes, dev.lanes + static_cast<long long>(g[2]) * K1VM_LANE,
               (g[3] - g[2]) * (K1VM_LANE / 2LL));
    p += 4LL * K1VM_LANE * (g[3] - g[2]);
    int32_t* code = reinterpret_cast<int32_t*>(p);
    k1vm_stage(code, dev.code + static_cast<long long>(g[0]) * K1VM_INSN,
               (g[1] - g[0]) * (K1VM_INSN / 2LL));
    p += 4LL * K1VM_INSN * (g[1] - g[0]);
    for (int i = threadIdx.x; i < n_bytes; i += blockDim.x) p[i] = dev.bytes[i];
    t = K1vmTables{code, lanes, i64, f64, p, g[0], g[2]};
  }
  __syncthreads();
  const int32_t* me = warps +
      (static_cast<long long>(group) * group_warps + w) * kWarpCols;
  K1vmStatus* slot = slots + w * kTile + lane;
  if (me[0] >= 0 && r < rows) {
    const long long n = k1vm_run(a, t, r, me[0], slot);
    if (executed) atomicAdd(executed, static_cast<unsigned long long>(n));
  }
  __syncthreads();
  if (me[1] > 0 && r < rows) k1vm_write(a, r, me[2], k1vm_fold(slot, me[1], kTile));
}

}  // namespace

// bufs: the five packed buffers (uint8, int8, bool, int32, int64; null
// for one the layout lacks), widths: their row widths in elements, both
// host arrays of 5.  code, lanes, i64, f64, bytes: the program's device
// tables (ops/vm.py Program), the pools of n_i64, n_f64 and n_bytes
// entries.  warps: [n_groups * group_warps, 3] (entry pc or -1, parts to
// fold, unique column), groups: [n_groups, 5] (code range, lane range,
// staged), smem_bytes: dynamic shared memory per block.  s_out, d_out:
// int8 [rows, n_uniq]; fd_out: int32 [rows, n_cols_u]; adm_out: int8
// [rows, n_adm] (null when n_adm is 0).  executed: null, or a device
// counter that gains the instructions the launch interpreted.  Returns 0
// or the CUDA error of the launch.
extern "C" int k1_vm(const void* const* bufs, const long long* widths,
                     long long rows, const void* code, const void* lanes,
                     const void* i64, const void* f64, const void* bytes,
                     int n_i64, int n_f64, int n_bytes, const void* warps,
                     const void* groups, int n_groups, int group_warps,
                     int smem_bytes, void* s_out, void* d_out, void* fd_out,
                     void* adm_out, int n_uniq, int n_cols_u, int n_adm,
                     void* executed, void* stream) {
  if (rows <= 0 || n_groups <= 0) return 0;
  const long long tiles = (rows + kTile - 1) / kTile;
  // x takes 2^31 - 1 blocks: past it the outputs alone would take over
  // 64 GiB (at least one byte per row and group)
  if (tiles > INT_MAX / n_groups || group_warps <= 0 ||
      group_warps * kTile > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        k1_vm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  K1vmArgs a;
  for (int b = 0; b < 5; ++b) {
    a.buf[b] = static_cast<const unsigned char*>(bufs[b]);
    a.width[b] = widths[b];
  }
  a.s_out = static_cast<int8_t*>(s_out);
  a.d_out = static_cast<int8_t*>(d_out);
  a.fd_out = static_cast<int32_t*>(fd_out);
  a.adm_out = static_cast<int8_t*>(adm_out);
  a.n_uniq = n_uniq;
  a.n_cols_u = n_cols_u;
  a.n_adm = n_adm;
  const K1vmTables dev{static_cast<const int32_t*>(code),
                       static_cast<const int32_t*>(lanes),
                       static_cast<const int64_t*>(i64),
                       static_cast<const double*>(f64),
                       static_cast<const unsigned char*>(bytes), 0, 0};
  k1_vm_kernel<<<static_cast<unsigned>(tiles * n_groups),
                 group_warps * kTile, smem_bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      a, dev, rows, n_groups, static_cast<const int32_t*>(warps),
      static_cast<const int32_t*>(groups), n_i64, n_f64, n_bytes,
      static_cast<unsigned long long*>(executed));
  return static_cast<int>(cudaGetLastError());
}
