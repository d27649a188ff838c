// K3: the device mutate decision, one thread per (row, site) cell.
//
// Replaces kyverno_tpu/mutate/kernel.py:94 MutateKernel._eval (jitted at
// :160).  Per (resource, edit site) it decides whether the edit applies:
//
//     missing = tag == MISSING          bad = istate == 2
//     present = !missing && !bad
//     eq      = numeric site: present && numeric tag && milli_ok
//                             && milli == t_milli
//               string site:  present && tag == STRING && slen == t_len
//                             && the w-byte windows are equal
//     edit    = (missing && !bad) || (!add_only && present && !eq)
//
// and reduces the sites of each rule to
//
//     edits   = sum_k edit_k * 2^k      (an int64 matmul in the JAX code)
//     status  = FALLBACK if any replace guard, non-map intermediate or
//               undecidable numeric site, else PASS if edits != 0,
//               else SKIP
//     reason  = first fault in the host fast path's order: replace
//               missing (1), non-dict (2), undecidable (3), none (0)
//
// with padding rows (valid == 0) forced to SKIP / 0 / 0.
//
// Bound on an H100: bytes.  One pass over the lanes, R*S*(15 + w) + R
// bytes at most (only a present string cell whose length matches needs
// its window), and R*NR*10 bytes written, with no arithmetic to speak
// of.  A mutate set has few sites a rule (the smoke pack: 3 rules over 6
// sites), so a warp per (row, rule), one lane per site, would leave most
// lanes idle and cover a couple of bytes of `tag` per load.  Here:
//
// * one thread per cell of the row-major [R, S] grid, so a warp's loads
//   of tag, istate, slen, milli and milli_ok are contiguous, and a block
//   takes a tile of whole rows (256 / S of them, at least one);
// * each cell ORs its edit bit (site k of a rule is bit k: `site_slot`
//   holds 32 * rule + k) and its fault flags into two 32-bit words per
//   (row, rule) in shared memory; a rule has at most 32 sites, so the
//   edit word is the rule's mask, widened unsigned so bit 31 never
//   sign-extends;
// * then one thread per (row, rule) writes edits, status and reason
//   (contiguous in the output buffer: edits int64 [R, NR], then status
//   and reason int8 [R, NR]);
// * the window is compared 16 bytes a load where w % 16 == 0 (the staged
//   buffer puts it on a 16-byte boundary), else 8.
//
// The lanes arrive in one staged buffer (ops/kernels.py k3_pack: one
// host-to-device copy a call) at byte offsets the wrapper passes; the
// site tables are device memory built once per lowered set (not
// __constant__: S * (w + 16) bytes can pass 64 KB at w = 256) and stay
// in L1/L2 across rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Lanes {
  const int64_t* milli;     // [R, S]
  const uint8_t* sbytes;    // [R, S, w]
  const int32_t* slen;      // [R, S]
  const int8_t* tag;        // [R, S]
  const int8_t* istate;     // [R, S]
  const uint8_t* milli_ok;  // [R, S] bool
  const uint8_t* valid;     // [R] bool
};

struct Sites {
  const uint8_t* is_num;    // [S] bool
  const int64_t* milli;     // [S]
  const int32_t* len;       // [S]
  const uint8_t* bytes;     // [S, w]
  const uint8_t* add_only;  // [S] bool
  const uint8_t* replace;   // [S] bool
  const int32_t* slot;      // [S] 32 * rule + bit
};

__device__ __forceinline__ bool window_equal(const uint8_t* a,
                                             const uint8_t* b, int width) {
  if ((width & 15) == 0) {
    const uint4* x = reinterpret_cast<const uint4*>(a);
    const uint4* y = reinterpret_cast<const uint4*>(b);
    for (int j = 0; j < (width >> 4); ++j) {
      const uint4 p = x[j], q = y[j];
      if (p.x != q.x || p.y != q.y || p.z != q.z || p.w != q.w) return false;
    }
    return true;
  }
  const uint2* x = reinterpret_cast<const uint2*>(a);
  const uint2* y = reinterpret_cast<const uint2*>(b);
  for (int j = 0; j < (width >> 3); ++j) {
    const uint2 p = x[j], q = y[j];
    if (p.x != q.x || p.y != q.y) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
mutate_kernel(Lanes in, Sites st, uint8_t* __restrict__ out, int rows,
              int n_sites, int n_rules, int width, int tile_rows,
              unsigned num_tag_bits, int tag_missing, int tag_string) {
  extern __shared__ unsigned words[];
  unsigned* mask = words;                           // [tile_rows, n_rules]
  unsigned* flags = words + tile_rows * n_rules;    // [tile_rows, n_rules]
  for (int j = threadIdx.x; j < 2 * tile_rows * n_rules; j += blockDim.x)
    words[j] = 0u;
  __syncthreads();

  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int live = static_cast<int>(
      min(static_cast<long long>(tile_rows), rows - row0));
  const size_t cell0 = static_cast<size_t>(row0) * n_sites;
  for (int c = threadIdx.x; c < live * n_sites; c += blockDim.x) {
    const int lr = c / n_sites;
    const int site = c - lr * n_sites;
    const size_t cell = cell0 + c;
    const int tag = in.tag[cell];
    const int istate = in.istate[cell];
    const bool missing = tag == tag_missing;
    const bool bad = istate == 2;
    const bool present = !missing && !bad;
    const bool add_only = st.add_only[site] != 0;
    bool eq = false, undec = false;
    if (present) {
      if (st.is_num[site]) {
        const bool num_tag =
            tag >= 0 && tag < 32 && ((num_tag_bits >> tag) & 1u);
        const bool ok = in.milli_ok[cell] != 0;
        eq = num_tag && ok && in.milli[cell] == st.milli[site];
        undec = num_tag && !ok && !add_only;
      } else if (tag == tag_string && in.slen[cell] == st.len[site]) {
        eq = window_equal(in.sbytes + cell * width,
                          st.bytes + static_cast<size_t>(site) * width,
                          width);
      }
    }
    const bool edit = (missing && !bad) || (!add_only && present && !eq);
    const bool rep_bad = st.replace[site] != 0 && (istate != 0 || missing);
    const unsigned slot = static_cast<unsigned>(st.slot[site]);
    if ((slot >> 5) >= static_cast<unsigned>(n_rules)) continue;
    const int w = lr * n_rules + static_cast<int>(slot >> 5);
    if (edit) atomicOr(mask + w, 1u << (slot & 31u));
    const unsigned f = (rep_bad ? 1u : 0u) | (bad ? 2u : 0u) |
                       (undec ? 4u : 0u);
    if (f) atomicOr(flags + w, f);
  }
  __syncthreads();

  const size_t total = static_cast<size_t>(rows) * n_rules;
  int64_t* edits = reinterpret_cast<int64_t*>(out);
  int8_t* status = reinterpret_cast<int8_t*>(out + total * 8);
  int8_t* reason = status + total;
  for (int j = threadIdx.x; j < live * n_rules; j += blockDim.x) {
    const size_t o = static_cast<size_t>(row0) * n_rules + j;
    if (!in.valid[row0 + j / n_rules]) {
      edits[o] = 0;
      status[o] = 0;
      reason[o] = 0;
      continue;
    }
    const unsigned m = mask[j], f = flags[j];
    edits[o] = static_cast<int64_t>(m);  // zero-extended: unsigned
    status[o] = f ? 2 : (m != 0u ? 1 : 0);
    reason[o] = (f & 1u) ? 1 : ((f & 2u) ? 2 : ((f & 4u) ? 3 : 0));
  }
}

}  // namespace

// `lanes`: the staged buffer on the current device, 16-byte aligned,
// holding milli, sbytes, slen, tag, istate, milli_ok and valid at the
// byte offsets `offsets[0..7)` (sbytes 16-byte aligned, the rest 8).
// Site tables as above, contiguous, t_bytes 16-byte aligned; w a
// multiple of 8 (w >= 8); every site's slot below 32 * n_rules.
// `out`: uint8 [rows * n_rules * 10], edits int64 [rows, n_rules] then
// status and reason int8 [rows, n_rules].  `num_tag_bits` has bit t set
// for each numeric type tag t.  Returns 0 or the CUDA error of the
// launch.
extern "C" int k3_mutate(const void* lanes, const long long* offsets,
                         const void* t_is_num, const void* t_milli,
                         const void* t_len, const void* t_bytes,
                         const void* add_only, const void* replace,
                         const void* site_slot, void* out, int rows,
                         int n_sites, int n_rules, int width,
                         unsigned num_tag_bits, int tag_missing,
                         int tag_string, void* stream) {
  if (rows <= 0 || n_rules <= 0 || n_sites <= 0) return 0;
  if (width < 8 || width % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* base = static_cast<const uint8_t*>(lanes);
  Lanes in{reinterpret_cast<const int64_t*>(base + offsets[0]),
           base + offsets[1],
           reinterpret_cast<const int32_t*>(base + offsets[2]),
           reinterpret_cast<const int8_t*>(base + offsets[3]),
           reinterpret_cast<const int8_t*>(base + offsets[4]),
           base + offsets[5], base + offsets[6]};
  Sites st{static_cast<const uint8_t*>(t_is_num),
           static_cast<const int64_t*>(t_milli),
           static_cast<const int32_t*>(t_len),
           static_cast<const uint8_t*>(t_bytes),
           static_cast<const uint8_t*>(add_only),
           static_cast<const uint8_t*>(replace),
           static_cast<const int32_t*>(site_slot)};
  int tile = n_sites >= kThreads ? 1 : kThreads / n_sites;
  while (tile > 1 && 8LL * tile * n_rules > kDefaultSmem) tile >>= 1;
  const long long smem = 8LL * tile * n_rules;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mutate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (rows + tile - 1) / tile;
  mutate_kernel<<<static_cast<unsigned>(blocks), kThreads,
                  static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(
      in, st, static_cast<uint8_t*>(out), rows, n_sites, n_rules, width,
      tile, num_tag_bits, tag_missing, tag_string);
  return static_cast<int>(cudaGetLastError());
}
