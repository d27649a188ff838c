// K1c: glob match of a constant pattern against each value's byte
// window, as a bitmask dynamic program.  One thread per value.
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
// Here the DP is glob_dp.cuh's, shared with K1v (k1_vm.cuh): two 64-bit
// words of positions, a run of literal and '?' bytes as one AND of
// shifted equality masks built from the value's 32-bit words.  The
// verdict keeps the reference's Kleene pair exactly (glob_kleene).
//
// Bound on an H100: bytes.  Each value's window, length and tag are
// read and two bytes written.  Neighbouring threads' windows lie w bytes
// apart, so a thread reading its own window would touch a new sector
// with every load of a warp; instead the block first stages its values'
// lengths, then the words of their windows that hold one of the first
// vlen bytes, into shared memory: consecutive threads on consecutive 16
// bytes of the block's contiguous [256, w] slab (4 or 1 bytes when the
// window's alignment does not allow 16), skipping every piece that lies
// wholly at or past its value's vlen.  Each thread then reads its
// ceil(vlen / 4) words from shared memory (rows padded to an odd number
// of words, so a warp's reads fall on 32 banks) and runs the DP in
// registers.  The pattern comes compiled on the host (ops/kernels.py
// glob_program: '?' flag, runs and stars, decided once per call) and
// rides in the kernel's parameter space (__grid_constant__): every
// thread reads it from the constant bank.

#include <cstdint>
#include <cuda_runtime.h>

#include "glob_dp.cuh"

namespace {

constexpr int kMaxProgram = 512;
constexpr int kMaxWidth = GLOB_DP_MAX_W;
constexpr int kThreads = 256;
// words of a staged window row: odd, so thread i's word k and thread
// i + 1's fall on different banks
constexpr int kRowWords = GLOB_DP_WORDS + 1;

struct Program {
  int len;
  unsigned char bytes[kMaxProgram];
};

__device__ __forceinline__ int clamp_len(int32_t slen, int w) {
  return slen < 0 ? 0 : (slen < w ? slen : w);
}

// unit = 16, 4 or 1 bytes: the staging load width the alignment allows
template <int kUnit>
__global__ void __launch_bounds__(kThreads)
wildcard_kernel(const uint8_t* __restrict__ head,
                const int32_t* __restrict__ str_len,
                const int8_t* __restrict__ tag, uint8_t* __restrict__ t_out,
                uint8_t* __restrict__ f_out, long long n, int w,
                unsigned conv_tags, int array_tag,
                const __grid_constant__ Program prog) {
  __shared__ uint32_t win[kThreads * kRowWords];
  __shared__ int vlen_s[kThreads];
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nv = static_cast<int>(n - v0 < kThreads ? n - v0 : kThreads);
  const int t = threadIdx.x;
  const long long i = v0 + t;
  const int32_t slen = t < nv ? str_len[i] : 0;
  vlen_s[t] = clamp_len(slen, w);
  __syncthreads();

  // the block's windows are one contiguous slab of nv * w bytes
  const uint8_t* slab = head + v0 * w;
  const int per = w / kUnit;  // units per window (kUnit divides w)
  unsigned char* win_b = reinterpret_cast<unsigned char*>(win);
  for (int u = t; u < nv * per; u += kThreads) {
    const int v = u / per, k = u - v * per;
    if (k * kUnit >= vlen_s[v]) continue;
    const int dst = v * kRowWords * 4 + k * kUnit;
    if (kUnit == 16) {
      const uint4 x = reinterpret_cast<const uint4*>(slab)[u];
      uint32_t* d = win + dst / 4;
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    } else if (kUnit == 4) {
      win[dst / 4] = reinterpret_cast<const uint32_t*>(slab)[u];
    } else {
      win_b[dst] = slab[u];
    }
  }
  __syncthreads();
  if (t >= nv) return;

  const int vlen = vlen_s[t];
  uint32_t words[GLOB_DP_WORDS];
  const uint32_t* row = win + t * kRowWords;
#pragma unroll
  for (int k = 0; k < GLOB_DP_WORDS; ++k)
    if (4 * k < vlen) words[k] = row[k];
  const uint8_t kl = glob_kleene(words, w, slen, tag[i], conv_tags,
                                 array_tag, prog.bytes, prog.len);
  t_out[i] = kl & 1;
  f_out[i] = (kl >> 1) & 1;
}

}  // namespace

// head: uint8 [n, w], str_len: int32 [n], tag: int8 [n]; t_out, f_out:
// bool [n]; all contiguous on the current device.  `program` is a host
// buffer of `plen` bytes, the pattern compiled by glob_program.  Returns
// 0 or the CUDA error of the launch.
extern "C" int k1c_wildcard(const void* head, const void* str_len,
                            const void* tag, void* t_out, void* f_out,
                            long long n, int w, const unsigned char* program,
                            int plen, unsigned conv_tags, int array_tag,
                            void* stream) {
  if (n <= 0) return 0;
  if (w < 0 || w > kMaxWidth || plen < 1 || plen > kMaxProgram)
    return static_cast<int>(cudaErrorInvalidValue);
  Program prog;
  prog.len = plen;
  for (int p = 0; p < plen; ++p) prog.bytes[p] = program[p];
  for (int p = plen; p < kMaxProgram; ++p) prog.bytes[p] = 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(head);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* h = static_cast<const uint8_t*>(head);
  const int32_t* sl = static_cast<const int32_t*>(str_len);
  const int8_t* tg = static_cast<const int8_t*>(tag);
  uint8_t* to = static_cast<uint8_t*>(t_out);
  uint8_t* fo = static_cast<uint8_t*>(f_out);
  // a block's slab starts at v0 * w: 16-byte loads when w and the base
  // are multiples of 16 (then kThreads * w is too), else 4, else bytes
  if (w > 0 && w % 16 == 0 && at % 16 == 0)
    wildcard_kernel<16><<<blocks, kThreads, 0, s>>>(
        h, sl, tg, to, fo, n, w, conv_tags, array_tag, prog);
  else if (w > 0 && w % 4 == 0 && at % 4 == 0)
    wildcard_kernel<4><<<blocks, kThreads, 0, s>>>(
        h, sl, tg, to, fo, n, w, conv_tags, array_tag, prog);
  else
    wildcard_kernel<1><<<blocks, kThreads, 0, s>>>(
        h, sl, tg, to, fo, n, w, conv_tags, array_tag, prog);
  return static_cast<int>(cudaGetLastError());
}
