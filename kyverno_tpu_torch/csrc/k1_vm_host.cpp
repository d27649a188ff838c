// K1v's interpreter (k1_vm.cuh) compiled for the CPU: the same source as
// the kernel, in a row loop, so the tests can hold the bytecode of
// ops/vm.py against the JAX evaluator and the eager walk without a card.
// No entry point of the port loads this build; the tests compile it
//
//     g++ -std=c++17 -O1 -shared -fPIC -o k1_vm_host.so k1_vm_host.cpp
//
// and call k1_vm_host with the arguments of k1_vm.cu's k1_vm (all host
// memory, no stream).

#include <cstdint>

#include "k1_vm.cuh"

extern "C" int k1_vm_host(const void* const* bufs, const long long* widths,
                          long long rows, const void* code, const void* lanes,
                          const void* i64, const void* f64, const void* bytes,
                          const void* trees, int n_trees, void* s_out,
                          void* d_out, void* fd_out, int n_uniq,
                          int n_cols_u) {
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
  const int32_t* tr = static_cast<const int32_t*>(trees);
  for (long long r = 0; r < rows; ++r)
    for (int t = 0; t < n_trees; ++t) k1vm_run(a, r, tr[2 * t]);
  return 0;
}
