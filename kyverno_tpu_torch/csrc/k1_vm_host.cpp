// K1v's interpreter (k1_vm.cuh) compiled for the CPU: the same source as
// the kernel, so the tests can hold the bytecode of ops/vm.py against the
// JAX evaluator and the eager walk without a card.  For each row and each
// group it runs the group's parts one after another into their slots,
// then folds each tree's slots with k1vm_fold, in the order the kernel's
// epilogue does; only the thread mapping, the warp-wide loop counts and
// the shared-memory staging of k1_vm.cu are the card's own.  No entry
// point of the port loads this build; the tests compile it
//
//     g++ -std=c++17 -O1 -shared -fPIC -o k1_vm_host.so k1_vm_host.cpp
//
// and call k1_vm_host with the arguments of k1_vm.cu's k1_vm (all host
// memory, no staging size and no stream; executed may be null).

#include <cstdint>
#include <vector>

#include "k1_vm.cuh"

extern "C" int k1_vm_host(const void* const* bufs, const long long* widths,
                          long long rows, const void* code, const void* lanes,
                          const void* i64, const void* f64, const void* bytes,
                          const void* warps, int n_groups, int group_warps,
                          void* s_out, void* d_out, void* fd_out,
                          void* adm_out, int n_uniq, int n_cols_u, int n_adm,
                          long long* executed) {
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
  const K1vmTables t{static_cast<const int32_t*>(code),
                     static_cast<const int32_t*>(lanes),
                     static_cast<const int64_t*>(i64),
                     static_cast<const double*>(f64),
                     static_cast<const unsigned char*>(bytes), 0, 0};
  const int32_t* wp = static_cast<const int32_t*>(warps);
  std::vector<K1vmStatus> slots(group_warps);
  long long n = 0;
  for (long long r = 0; r < rows; ++r)
    for (int g = 0; g < n_groups; ++g) {
      const int32_t* gw = wp + static_cast<long long>(g) * group_warps * 3;
      for (int w = 0; w < group_warps; ++w)
        if (gw[3 * w] >= 0) n += k1vm_run(a, t, r, gw[3 * w], &slots[w]);
      for (int w = 0; w < group_warps; ++w)
        if (gw[3 * w + 1] > 0)
          k1vm_write(a, r, gw[3 * w + 2],
                     k1vm_fold(&slots[w], gw[3 * w + 1], 1));
    }
  if (executed) *executed = n;
  return 0;
}

// k1vm_fold over n triples (s, d, fd), for the tests: the result in
// out_s, out_d, out_fd.
extern "C" void k1_vm_fold_host(const int8_t* s, const int8_t* d,
                                const int32_t* fd, int n, int8_t* out_s,
                                int8_t* out_d, int32_t* out_fd) {
  std::vector<K1vmStatus> parts(n);
  for (int i = 0; i < n; ++i) parts[i] = K1vmStatus{s[i], d[i], fd[i]};
  const K1vmStatus out = k1vm_fold(parts.data(), n, 1);
  *out_s = out.s;
  *out_d = out.d;
  *out_fd = out.fd;
}
