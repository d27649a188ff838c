// K1c: glob match of a constant pattern against each value's byte
// window, as a bitmask dynamic program.  One thread per (row, element).
//
// Replaces kyverno_tpu/ops/eval.py _View.wildcard_const (:275-309),
// which runs the DP as one [.., w + 1] bool array per pattern byte:
//
//     dp[j]: the pattern consumed so far matches value[:j]
//     '*'      dp = cumsum(dp) > 0             (every j at or after the first hit)
//     '?'      dp = [0] ++ (dp[:-1] & j < vlen)
//     literal  dp = [0] ++ (dp[:-1] & head == c & j < vlen)
//     matched  = dp[vlen],  vlen = min(str_len, w)
//
// Here the DP is glob_dp.cuh's two 64-bit words, shared with K1v
// (k1_vm.cuh), which runs the same DP inside its interpreter.  The verdict keeps
// the reference's Kleene pair exactly: decidable only inside the window
// and, for patterns with '?', only over ASCII bytes (a rune is wider
// than a byte); t = conv & decidable & matched,
// f = !array & (!conv | (decidable & !matched)).
//
// Bound on an H100: bytes.  A thread reads its w head bytes, str_len and
// tag once and writes two bytes; the DP costs about w compares per
// pattern byte in registers, far under the byte time at these widths.
// The pattern rides in the kernel's parameter space (__grid_constant__,
// so the DP's pointer to it makes no copy): every thread reads it from
// the constant bank.

#include <cstdint>
#include <cuda_runtime.h>

#include "glob_dp.cuh"

namespace {

constexpr int kMaxPattern = 256;
constexpr int kMaxWidth = GLOB_DP_MAX_W;
constexpr int kThreads = 256;

struct Pattern {
  int len;
  int has_q;
  unsigned char bytes[kMaxPattern];
};

__global__ void wildcard_kernel(const uint8_t* __restrict__ head,
                                const int32_t* __restrict__ str_len,
                                const int8_t* __restrict__ tag,
                                uint8_t* __restrict__ t_out,
                                uint8_t* __restrict__ f_out, long long n,
                                int w, unsigned conv_tags, int array_tag,
                                const __grid_constant__ Pattern pat) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* h = head + i * w;
  uint8_t hb[kMaxWidth];
#pragma unroll
  for (int j = 0; j < kMaxWidth; ++j) hb[j] = j < w ? h[j] : 0;

  const int slen = str_len[i];
  const int vlen = slen < w ? slen : w;
  const bool matched = glob_dp_match(hb, w, vlen, pat.bytes, pat.len);
  const bool ascii_ok = !pat.has_q || glob_ascii_ok(hb, vlen);
  const int tg = tag[i];
  const bool conv = tg >= 0 && tg < 32 && ((conv_tags >> tg) & 1u) != 0u;
  const bool arrayish = tg == array_tag;
  const bool decid = (slen <= w) && ascii_ok;
  t_out[i] = conv && decid && matched;
  f_out[i] = !arrayish && (!conv || (decid && !matched));
}

}  // namespace

// head: uint8 [n, w], str_len: int32 [n], tag: int8 [n]; t_out, f_out:
// bool [n]; all contiguous on the current device.  `pattern` is a host
// buffer of `plen` bytes.  Returns 0 or the CUDA error of the launch.
extern "C" int k1c_wildcard(const void* head, const void* str_len,
                            const void* tag, void* t_out, void* f_out,
                            long long n, int w, const unsigned char* pattern,
                            int plen, unsigned conv_tags, int array_tag,
                            void* stream) {
  if (n <= 0) return 0;
  if (w < 0 || w > kMaxWidth || plen < 0 || plen > kMaxPattern)
    return static_cast<int>(cudaErrorInvalidValue);
  Pattern pat;
  pat.len = plen;
  pat.has_q = 0;
  for (int p = 0; p < plen; ++p) {
    pat.bytes[p] = pattern[p];
    if (pattern[p] == '?') pat.has_q = 1;
  }
  for (int p = plen; p < kMaxPattern; ++p) pat.bytes[p] = 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  wildcard_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(head), static_cast<const int32_t*>(str_len),
      static_cast<const int8_t*>(tag), static_cast<uint8_t*>(t_out),
      static_cast<uint8_t*>(f_out), n, w, conv_tags, array_tag, pat);
  return static_cast<int>(cudaGetLastError());
}
