// K3: the device mutate decision, one warp per (row, rule).
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
// Sites are enumerated rule by rule, so rule r owns the contiguous range
// [rule_start[r], rule_start[r + 1]).  The plan caps a rule at 32 sites
// (kyverno_tpu/mutate/plan.py MAX_SITES), so lane k of the rule's warp
// evaluates site k and __ballot_sync of `edit` is the edit bitmask
// itself (bit k = site k: the same value as the sum of distinct powers
// of two).  Ballots of the three fault flags give the per-rule ORs.  The
// ballot is widened through `unsigned`, so bit 31 (a 32-site rule) never
// sign-extends.  The wrapper (ops/kernels.py k3_mutate) refuses a rule
// with more than 32 sites.
//
// Bound on an H100: bytes.  One pass over the lanes, R*S*(15 + w) + R
// bytes read and R*NR*10 bytes written, with no arithmetic to speak of.
// The design keeps that one pass: the five scalar lanes are read one
// element per lane, so a warp's loads of a rule's sites are contiguous;
// only a present string site whose length matches reads its w-byte
// window, 8 bytes at a time.  The site tables live in device memory
// (not __constant__: S * (w + 16) bytes can pass 64 KB at w = 256) and
// stay in L1/L2 across rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

struct Lanes {
  const int8_t* tag;        // [R, S]
  const int8_t* istate;     // [R, S]
  const int64_t* milli;     // [R, S]
  const uint8_t* milli_ok;  // [R, S] bool
  const int32_t* slen;      // [R, S]
  const uint64_t* sbytes;   // [R, S, w] as w / 8 words per cell
  const uint8_t* valid;     // [R] bool
};

struct Sites {
  const uint8_t* is_num;    // [S] bool
  const int64_t* milli;     // [S]
  const int32_t* len;       // [S]
  const uint64_t* bytes;    // [S, w] as w / 8 words per site
  const uint8_t* add_only;  // [S] bool
  const uint8_t* replace;   // [S] bool
  const int32_t* rule_start;  // [NR + 1]
};

__global__ void mutate_kernel(Lanes in, Sites st, int8_t* __restrict__ status,
                              int64_t* __restrict__ edits,
                              int8_t* __restrict__ reason, int rows,
                              int n_sites, int n_rules, int words,
                              unsigned num_tag_bits, int tag_missing,
                              int tag_string) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(rows) * n_rules) return;  // warp-uniform
  const int row = static_cast<int>(warp / n_rules);
  const int rule = static_cast<int>(warp % n_rules);
  const int s0 = st.rule_start[rule];
  const int s1 = st.rule_start[rule + 1];
  const int site = s0 + lane;
  bool edit = false, rep_bad = false, bad = false, undec = false;
  if (site < s1) {
    const size_t cell = static_cast<size_t>(row) * n_sites + site;
    const int tag = in.tag[cell];
    const int istate = in.istate[cell];
    const bool missing = tag == tag_missing;
    bad = istate == 2;
    const bool present = !missing && !bad;
    const bool add_only = st.add_only[site] != 0;
    bool eq = false;
    if (present) {
      if (st.is_num[site]) {
        const bool num_tag =
            tag >= 0 && tag < 32 && ((num_tag_bits >> tag) & 1u);
        const bool ok = in.milli_ok[cell] != 0;
        eq = num_tag && ok && in.milli[cell] == st.milli[site];
        undec = num_tag && !ok && !add_only;
      } else if (tag == tag_string && in.slen[cell] == st.len[site]) {
        const uint64_t* a = in.sbytes + cell * words;
        const uint64_t* b = st.bytes + static_cast<size_t>(site) * words;
        eq = true;
        for (int j = 0; j < words && eq; ++j) eq = a[j] == b[j];
      }
    }
    edit = (missing && !bad) || (!add_only && present && !eq);
    rep_bad = st.replace[site] != 0 && (istate != 0 || missing);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, edit);
  const bool rep_any = __any_sync(0xffffffffu, rep_bad) != 0;
  const bool bad_any = __any_sync(0xffffffffu, bad) != 0;
  const bool undec_any = __any_sync(0xffffffffu, undec) != 0;
  if (lane != 0) return;
  const size_t out = static_cast<size_t>(row) * n_rules + rule;
  if (!in.valid[row]) {
    status[out] = 0;
    edits[out] = 0;
    reason[out] = 0;
    return;
  }
  const bool fallback = rep_any || bad_any || undec_any;
  status[out] = fallback ? 2 : (mask != 0 ? 1 : 0);
  edits[out] = static_cast<int64_t>(mask);  // zero-extended: unsigned
  reason[out] = rep_any ? 1 : (bad_any ? 2 : (undec_any ? 3 : 0));
}

}  // namespace

// Lanes and site tables as above, contiguous on the current device;
// sbytes and t_bytes 8-byte aligned with w a multiple of 8 (w >= 8), and
// at most 32 sites per rule.
// Outputs: status int8, edits int64, reason int8, each [rows, n_rules].
// `num_tag_bits` has bit t set for each numeric type tag t.  Returns 0 or
// the CUDA error of the launch.
extern "C" int k3_mutate(const void* tag, const void* istate,
                         const void* milli, const void* milli_ok,
                         const void* slen, const void* sbytes,
                         const void* valid, const void* t_is_num,
                         const void* t_milli, const void* t_len,
                         const void* t_bytes, const void* add_only,
                         const void* replace, const void* rule_start,
                         void* status, void* edits, void* reason, int rows,
                         int n_sites, int n_rules, int width,
                         unsigned num_tag_bits, int tag_missing,
                         int tag_string, void* stream) {
  if (rows <= 0 || n_rules <= 0) return 0;
  if (n_sites < 0 || width < 8 || width % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes in{static_cast<const int8_t*>(tag), static_cast<const int8_t*>(istate),
           static_cast<const int64_t*>(milli),
           static_cast<const uint8_t*>(milli_ok),
           static_cast<const int32_t*>(slen),
           static_cast<const uint64_t*>(sbytes),
           static_cast<const uint8_t*>(valid)};
  Sites st{static_cast<const uint8_t*>(t_is_num),
           static_cast<const int64_t*>(t_milli),
           static_cast<const int32_t*>(t_len),
           static_cast<const uint64_t*>(t_bytes),
           static_cast<const uint8_t*>(add_only),
           static_cast<const uint8_t*>(replace),
           static_cast<const int32_t*>(rule_start)};
  const long long warps = static_cast<long long>(rows) * n_rules;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mutate_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      in, st, static_cast<int8_t*>(status), static_cast<int64_t*>(edits),
      static_cast<int8_t*>(reason), rows, n_sites, n_rules, width / 8,
      num_tag_bits, tag_missing, tag_string);
  return static_cast<int>(cudaGetLastError());
}
