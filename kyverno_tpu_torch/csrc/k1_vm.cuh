// K1v: the status-program interpreter, per (row, part of a unique tree).
//
// Replaces kyverno_tpu/ops/eval.py build_evaluator's program walk
// (eval_leaf :1290, eval_expr :1336, eval_status :1406, evaluate_unique
// :1710, jitted in evaluate_packed :1819), which XLA fuses into one
// straight-line program per policy set.  The port cannot compile a
// kernel per policy set at run time cheaply, so the policy set becomes
// data: ops/vm.py lowers each unique status tree to a bytecode stream,
// and this interpreter runs it for one row, reading the packed [R, W]
// lane buffers (pack_batch) directly.
//
// Values.  The Kleene stack holds pairs in two bits (bit 0 known-true,
// bit 1 known-false); a boolean is the known pair (v, !v).  The status
// stack holds (status, detail, fail detail) triples.  Element axes are
// loops: LOOP/ENDLOOP reduce a body over one index level (0, 1: the slot
// element axes; 2: a gather's elements; 3: a foreach list's elements)
// with Kleene AND, Kleene OR or a bitwise OR of the value's bits;
// SLOOP/SENDLOOP fold a status body into the forall/exists accumulator
// (first failing element in index order, the undecidable elements before
// it, element 0's fail detail).  A lane is read at column
// off + (c0*i0 + c1*i1 + c2*i2 + c3*i3 + k) * stride of its buffer's
// row, so a lane shallower than its context broadcasts.
//
// The foreach list element has a level of its own (3) rather than
// reusing level 0.  Conditions inside a foreach entry are lowered at
// depth 0, so no slot loop is open around them, but such a condition
// may still hold a leaf on a deeper slot, which reduces over levels 0
// and 1, and every per-element gather ([R, FE, EG]) loops over its EG
// elements at level 2 inside the list loop.  With its own level the
// list loop never shares an index with either; it costs one int per
// thread and one multiply-add per load.  SFEBEGIN/SFEENTRY/SFEEND fold
// the entries of a foreach node into a status-stack accumulator: each
// entry is a LOOP over level 3 whose body packs four per-element bits
// (PACK2) and whose bitwise OR SFEENTRY reads.
//
// The admission match (K1i) is one more entry per eligible program:
// membership of the int32 id lanes in a constant id set (IDIN, over the
// int64 pool) and boolean bytecode; its AEND writes an int8 column of
// adm_out.
//
// Parts.  A status tree whose root is a `seq` may be lowered as parts:
// runs of consecutive children, each ending in PEND, which leaves the
// part's (s, d, fd) triple in a slot instead of the outputs.  k1vm_fold
// folds a tree's slots in child order exactly as SSEQ folds its
// children (the first non-PASS triple, else the last), and k1vm_write
// stores the result.  Every status entry ends in PEND, so a tree of one
// part is a fold of one slot; an admission entry's AEND writes its
// column itself.
//
// Loops that stop at the count.  A LOOP or SLOOP whose word 5 names a
// count lane (ops/vm.py proves that every element at or past the row's
// count adds the reduction's identity) runs min(max(count, 0), width)
// elements, and a status loop at least element 0, whose fail detail
// SENDLOOP keeps whatever the element's validity.  On the card the
// warp runs the largest such count among its rows, so its threads stay
// together; the extra elements add the identity.  An unmarked loop
// runs its full width.
//
// Tables.  The interpreter reads its instructions, lane-table rows and
// constant pools through K1vmTables: the device tables, or the copy of
// one block's share that k1_vm.cu staged in shared memory, whose
// instruction and lane indices start at code_lo and lane_lo.
//
// Control flow depends on the program and the loop counts only, so the
// threads of a warp, which run one part over 32 rows, diverge only
// inside an instruction.
//
// K1VM_HD marks every function host and device code under nvcc and
// plain inline code under a host compiler: k1_vm_host.cpp runs the same
// source on the CPU for the tests.

#pragma once

#include <math.h>
#include <stdint.h>

#include "glob_dp.cuh"

#ifdef __CUDACC__
#define K1VM_HD __host__ __device__ __forceinline__
#else
#define K1VM_HD inline
#endif

// fixed limits: ops/vm.py routes a tree past one of them to the eager walk
#define K1VM_KSTACK 32
#define K1VM_SSTACK 16
#define K1VM_LOCALS 16
#define K1VM_FRAMES 4
#define K1VM_LEVELS 4
#define K1VM_INSN 6
#define K1VM_LANE 8

// status codes and type tags (compiler/ir.py)
#define K1VM_PASS 0
#define K1VM_FAIL 1
#define K1VM_SKIP 2
#define K1VM_HOST 3
#define K1VM_VAR_ERR 5
#define K1VM_TAG_MISSING 0
#define K1VM_TAG_ARRAY 7
// TAG_STRING, TAG_INT, TAG_FLOAT, TAG_BOOL: the string-convertible tags
#define K1VM_CONV_TAGS ((1u << 5) | (1u << 3) | (1u << 4) | (1u << 2))

// opcodes: the order of ops/vm.py OPS
enum K1vmOp {
  K1_K, K1_TAG, K1_LB, K1_CI, K1_ABSLE, K1_F64, K1_F64DUR, K1_BYTES,
  K1_GLOB, K1_IDXLT, K1_AND, K1_OR, K1_NOT, K1_PAIR, K1_TOF, K1_FOF,
  K1_UOF, K1_TU, K1_BLOCK, K1_MASK, K1_FIXF, K1_BOR, K1_BLOCKT, K1_BLOCKF,
  K1_STORE, K1_LOAD, K1_LOOP, K1_ENDLOOP, K1_SCONST, K1_SFROMK,
  K1_SVARERR, K1_SFAILGUARD, K1_STRACKFAIL, K1_SSEQ, K1_SANY, K1_SEQUALITY,
  K1_SCOND, K1_SLOOP, K1_SENDLOOP, K1_SFORALL, K1_SEXISTS, K1_SSCALARS,
  K1_PEND, K1_SUSP, K1_IDXLAST, K1_PACK2, K1_IDIN, K1_SFEBEGIN, K1_SFEENTRY,
  K1_SFEEND, K1_AEND
};

// one evaluator call: the five packed buffers (uint8, int8, bool, int32,
// int64; a missing one is null), their row widths in elements, the
// unique-space outputs and the admission columns
struct K1vmArgs {
  const unsigned char* buf[5];
  long long width[5];
  int8_t* s_out;
  int8_t* d_out;
  int32_t* fd_out;
  int8_t* adm_out;
  int n_uniq;
  int n_cols_u;
  int n_adm;
};

// the program's tables as the interpreter reads them: instruction pc is
// code[(pc - code_lo) * K1VM_INSN], lane l is lanes[(l - lane_lo) *
// K1VM_LANE] (both los 0 for the device tables themselves)
struct K1vmTables {
  const int32_t* code;
  const int32_t* lanes;
  const int64_t* i64;
  const double* f64;
  const unsigned char* bytes;
  int code_lo;
  int lane_lo;
};

struct K1vmStatus {
  int8_t s;
  int8_t d;
  int32_t fd;
};

struct K1vmFrame {
  int start;      // first instruction of the body
  int level;      // index level the loop runs
  int width;
  int kind;       // LOOP: the reduction
  int saved;      // the level's index before the loop
  uint8_t acc;    // LOOP: the Kleene accumulator
  uint8_t flags;  // SLOOP: any FAIL | HOST << 1 | SKIP << 2 | PASS << 3
  bool host_seen; // SLOOP: a valid HOST element so far
  bool amb;       // SLOOP: a valid HOST element before the first FAIL
  int first;      // SLOOP: the first valid FAIL element, -1 for none
  int32_t sel;    // SLOOP: its fail detail
  int32_t fd0;    // SLOOP: element 0's fail detail
};

K1VM_HD uint8_t k1vm_known(bool v) { return v ? 1 : 2; }

K1VM_HD int k1vm_esize(int b) { return b == 3 ? 4 : (b == 4 ? 8 : 1); }

// a lane-table row: buffer, column, stride, c0, c1, c2, constant, c3
K1VM_HD const unsigned char* k1vm_addr(const K1vmArgs& a, long long r,
                                       const int32_t* ln, const int* idx) {
  const int b = ln[0];
  const long long e = static_cast<long long>(ln[3]) * idx[0] +
                      static_cast<long long>(ln[4]) * idx[1] +
                      static_cast<long long>(ln[5]) * idx[2] +
                      static_cast<long long>(ln[7]) * idx[3] + ln[6];
  const long long col = ln[1] + e * ln[2];
  return a.buf[b] + (r * a.width[b] + col) * k1vm_esize(b);
}

K1VM_HD int64_t k1vm_read(const unsigned char* p, int b) {
  switch (b) {
    case 0: return *p;
    case 1: return *reinterpret_cast<const int8_t*>(p);
    case 2: return *p != 0;
    case 3: return *reinterpret_cast<const int32_t*>(p);
    default: return *reinterpret_cast<const int64_t*>(p);
  }
}

K1VM_HD int64_t k1vm_load(const K1vmArgs& a, long long r, const int32_t* ln,
                          const int* idx) {
  return k1vm_read(k1vm_addr(a, r, ln, idx), ln[0]);
}

K1VM_HD bool k1vm_cmp_i(int64_t x, int64_t c, int op) {
  switch (op) {
    case 0: return x > c;
    case 1: return x >= c;
    case 2: return x < c;
    case 3: return x <= c;
    case 4: return x == c;
    default: return x != c;
  }
}

K1VM_HD bool k1vm_cmp_f(double x, double c, int op) {
  switch (op) {
    case 0: return x > c;
    case 1: return x >= c;
    case 2: return x < c;
    case 3: return x <= c;
    case 4: return x == c;
    default: return x != c;
  }
}

// IEEE double division and product, rounded to nearest, never fused or
// approximated (the host engine's float(key) and int(x * 1e9) / 1e9)
K1VM_HD double k1vm_div(double x, double y) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(x, y);
#else
  return x / y;
#endif
}

K1VM_HD double k1vm_mul(double x, double y) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(x, y);
#else
  return x * y;
#endif
}

K1VM_HD uint8_t k1vm_identity(int red) {
  return red == 0 ? 1 : (red == 1 ? 2 : 0);
}

K1VM_HD uint8_t k1vm_and(uint8_t x, uint8_t y) {
  return static_cast<uint8_t>(((x & y) & 1) | ((x | y) & 2));
}

K1VM_HD uint8_t k1vm_or(uint8_t x, uint8_t y) {
  return static_cast<uint8_t>(((x | y) & 1) | ((x & y) & 2));
}

K1VM_HD uint8_t k1vm_reduce(uint8_t acc, uint8_t v, int red) {
  return red == 0 ? k1vm_and(acc, v)
                  : (red == 1 ? k1vm_or(acc, v) : static_cast<uint8_t>(acc | v));
}

// K1c's verdict on the glob DP (k1c_wildcard.cu)
K1VM_HD uint8_t k1vm_glob(const unsigned char* head, int w, int64_t slen,
                          int tag, const unsigned char* pat, int plen) {
  unsigned char hb[GLOB_DP_MAX_W];
#pragma unroll
  for (int j = 0; j < GLOB_DP_MAX_W; ++j) hb[j] = j < w ? head[j] : 0;
  const int vlen = slen < w ? static_cast<int>(slen) : w;
  const bool matched = glob_dp_match(hb, w, vlen, pat, plen);
  bool has_q = false;
  for (int p = 0; p < plen; ++p) has_q |= pat[p] == '?';
  const bool ascii_ok = !has_q || glob_ascii_ok(hb, vlen);
  const bool conv = tag >= 0 && tag < 32 && ((K1VM_CONV_TAGS >> tag) & 1u);
  const bool arrayish = tag == K1VM_TAG_ARRAY;
  const bool decid = slen <= w && ascii_ok;
  const bool t = conv && decid && matched;
  const bool f = !arrayish && (!conv || (decid && !matched));
  return static_cast<uint8_t>((t ? 1 : 0) | (f ? 2 : 0));
}

// The eager walk's _suspicious_scalar, less its has_wild term: a '-' in
// the value, a '[' after nothing but whitespace (the cumprod of the
// whitespace test over the whole window), or a value past the window.
K1VM_HD bool k1vm_susp(const unsigned char* head, int w, int64_t slen) {
  const int64_t n = slen < w ? slen : w;
  bool dash = false, bracket = false, before = true;
  for (int j = 0; j < w; ++j) {
    const unsigned char c = head[j];
    if (j < n) {
      dash |= c == '-';
      bracket |= before && c == '[';
    }
    before = before && (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  }
  return dash || bracket || slen > w;
}

// One foreach entry folded into the accumulator (eval.py's foreach
// branch): acc holds nonpass | unknown << 1 | apply << 2 | fd_ok << 3;
// fl is the OR over the list's elements of FAIL | PASS << 1 |
// undecidable << 2 | last-element error << 3.  fd_ok is taken before
// this entry's outcome is merged.
K1VM_HD int k1vm_foreach_entry(int acc, int fl, bool active, bool ovf) {
  const bool any_fail = fl & 1, any_pass = fl & 2, any_unk = fl & 4;
  const bool last_err = (fl & 8) && !ovf;
  const bool nonpass = active && (any_fail || last_err);
  const bool unknown = active && (any_unk || ovf) && !nonpass;
  const bool apply = active && any_pass;
  if (!(acc & 3) && active && any_fail) acc |= 8;
  return acc | (nonpass ? 1 : 0) | (unknown ? 2 : 0) | (apply ? 4 : 0);
}

// lane-table row l
K1VM_HD const int32_t* k1vm_lane(const K1vmTables& t, int l) {
  return t.lanes + static_cast<long long>(l - t.lane_lo) * K1VM_LANE;
}

// Elements a loop marked with a count lane runs: min(max(count, 0),
// width), at least element 0 for a status loop (status) of a nonzero
// width; on the card, the largest of that among the warp's rows.
K1VM_HD int k1vm_loop_count(int64_t count, int width, bool status) {
  int n = count <= 0 ? 0 : (count < width ? static_cast<int>(count) : width);
  if (status && width > 0 && n == 0) n = 1;
#ifdef __CUDA_ARCH__
  n = __reduce_max_sync(__activemask(), n);
#endif
  return n;
}

// A split tree's result: its parts' triples (parts[i * stride], in
// child order) folded as K1_SSEQ folds the children, the first non-PASS
// triple, else the last one.
K1VM_HD K1vmStatus k1vm_fold(const K1vmStatus* parts, int n, int stride) {
  K1vmStatus out = parts[0];
  for (int i = 1; i < n; ++i)
    if (out.s == K1VM_PASS) out = parts[static_cast<long long>(i) * stride];
  return out;
}

// a status tree's (status, detail, fail detail) into unique column col
K1VM_HD void k1vm_write(const K1vmArgs& a, long long r, int col,
                        K1vmStatus st) {
  a.s_out[r * a.n_uniq + col] = st.s;
  a.d_out[r * a.n_uniq + col] = st.d;
  a.fd_out[r * a.n_cols_u + col] = st.fd;
}

// Run the part whose instructions start at `pc` for row r: a status
// part, whose PEND leaves its (status, detail, fail detail) in *slot, or
// an admission match, whose AEND writes its admission column.  Returns
// the instructions it executed.
K1VM_HD long long k1vm_run(const K1vmArgs& a, const K1vmTables& t,
                           long long r, int pc, K1vmStatus* slot) {
  uint8_t ks[K1VM_KSTACK];
  K1vmStatus ss[K1VM_SSTACK];
  uint8_t loc[K1VM_LOCALS];
  K1vmFrame fr[K1VM_FRAMES];
  int idx[K1VM_LEVELS] = {0, 0, 0, 0};
  int kp = 0, sp = 0, fp = 0;
  long long executed = 0;
  for (;;) {
    const int32_t* in = t.code + static_cast<long long>(pc - t.code_lo) * K1VM_INSN;
    ++pc;
    ++executed;
    switch (in[0]) {
      case K1_K:
        ks[kp++] = static_cast<uint8_t>(in[1]);
        break;
      case K1_TAG: {
        const int64_t tg = k1vm_load(a, r, k1vm_lane(t, in[1]), idx);
        ks[kp++] = k1vm_known(tg >= 0 && tg < 32 && ((in[2] >> tg) & 1));
        break;
      }
      case K1_LB:
        ks[kp++] = k1vm_known(k1vm_load(a, r, k1vm_lane(t, in[1]), idx) != 0);
        break;
      case K1_CI:
        ks[kp++] = k1vm_known(
            k1vm_cmp_i(k1vm_load(a, r, k1vm_lane(t, in[1]), idx), t.i64[in[3]], in[2]));
        break;
      case K1_ABSLE: {
        const int64_t x = k1vm_load(a, r, k1vm_lane(t, in[1]), idx);
        // torch.abs wraps INT64_MIN to itself
        const int64_t ax = x < 0 ? static_cast<int64_t>(0ull - static_cast<uint64_t>(x)) : x;
        ks[kp++] = k1vm_known(ax <= t.i64[in[3]]);
        break;
      }
      case K1_F64: {
        const double x = k1vm_div(static_cast<double>(k1vm_load(a, r, k1vm_lane(t, in[1]), idx)),
                                  t.f64[in[4]]);
        ks[kp++] = k1vm_known(k1vm_cmp_f(x, t.f64[in[3]], in[2]));
        break;
      }
      case K1_F64DUR: {
        const double key = k1vm_div(static_cast<double>(k1vm_load(a, r, k1vm_lane(t, in[1]), idx)),
                                    1000.0);
        const double kd = trunc(k1vm_mul(key, 1e9));
        ks[kp++] = k1vm_known(k1vm_cmp_f(in[4] ? kd : k1vm_div(kd, 1e9),
                                         t.f64[in[3]], in[2]));
        break;
      }
      case K1_BYTES: {
        const unsigned char* p = k1vm_addr(a, r, k1vm_lane(t, in[1]), idx);
        const unsigned char* c = t.bytes + in[3];
        bool eq = true;
        for (int j = 0; j < in[4]; ++j) eq &= p[j] == c[j];
        ks[kp++] = k1vm_known(eq);
        break;
      }
      case K1_GLOB: {
        const int32_t* ln = k1vm_lane(t, in[1]);
        const int32_t* len_ln = k1vm_lane(t, in[2]);
        const int32_t* tag_ln = k1vm_lane(t, in[3]);
        ks[kp++] = k1vm_glob(k1vm_addr(a, r, ln, idx), ln[2],
                             k1vm_load(a, r, len_ln, idx),
                             static_cast<int>(k1vm_load(a, r, tag_ln, idx)),
                             t.bytes + in[4], in[5]);
        break;
      }
      case K1_IDXLT:
        ks[kp++] = k1vm_known(idx[in[2]] < k1vm_load(a, r, k1vm_lane(t, in[1]), idx));
        break;
      case K1_AND:
        --kp;
        ks[kp - 1] = k1vm_and(ks[kp - 1], ks[kp]);
        break;
      case K1_OR:
        --kp;
        ks[kp - 1] = k1vm_or(ks[kp - 1], ks[kp]);
        break;
      case K1_NOT: {
        const uint8_t x = ks[kp - 1];
        ks[kp - 1] = static_cast<uint8_t>(((x & 1) << 1) | ((x >> 1) & 1));
        break;
      }
      case K1_PAIR:
        --kp;
        ks[kp - 1] = static_cast<uint8_t>((ks[kp - 1] & 1) | ((ks[kp] & 1) << 1));
        break;
      case K1_TOF:
        ks[kp - 1] = k1vm_known(ks[kp - 1] & 1);
        break;
      case K1_FOF:
        ks[kp - 1] = k1vm_known(ks[kp - 1] & 2);
        break;
      case K1_UOF:
        ks[kp - 1] = k1vm_known((ks[kp - 1] & 3) == 0);
        break;
      case K1_TU: {
        --kp;
        const bool t = ks[kp - 1] & 1, u = ks[kp] & 1;
        ks[kp - 1] = static_cast<uint8_t>((t ? 1 : 0) | (!t && !u ? 2 : 0));
        break;
      }
      case K1_BLOCK:
        --kp;
        if (ks[kp] & 1) ks[kp - 1] = 0;
        break;
      case K1_MASK:
        --kp;
        if (!(ks[kp] & 1)) ks[kp - 1] = 0;
        break;
      case K1_FIXF:
        if (ks[kp - 1] & 1) ks[kp - 1] = 1;
        break;
      case K1_BOR:
        --kp;
        ks[kp - 1] = static_cast<uint8_t>(ks[kp - 1] | ks[kp]);
        break;
      case K1_BLOCKT:
        --kp;
        if (ks[kp] & 1) ks[kp - 1] &= 2;
        break;
      case K1_BLOCKF:
        --kp;
        if (ks[kp] & 1) ks[kp - 1] &= 1;
        break;
      case K1_STORE:
        loc[in[1]] = ks[--kp];
        break;
      case K1_LOAD:
        ks[kp++] = loc[in[1]];
        break;
      case K1_LOOP:
      case K1_SLOOP: {
        const int level = in[1];
        const int width = in[5] >= 0
            ? k1vm_loop_count(k1vm_load(a, r, k1vm_lane(t, in[5]), idx), in[2],
                              in[0] == K1_SLOOP)
            : in[2];
        K1vmFrame& f = fr[fp];
        f.start = pc;
        f.level = level;
        f.width = width;
        f.kind = in[3];
        f.saved = idx[level];
        f.acc = k1vm_identity(in[3]);
        f.flags = 0;
        f.host_seen = false;
        f.amb = false;
        f.first = -1;
        f.sel = -1;
        f.fd0 = -1;
        if (width > 0) {
          ++fp;
          idx[level] = 0;
        } else if (in[0] == K1_LOOP) {
          ks[kp++] = f.acc;
          pc = in[4];
        } else {
          ss[sp++] = K1vmStatus{0, 0, -1};
          pc = in[4];
        }
        break;
      }
      case K1_ENDLOOP: {
        K1vmFrame& f = fr[fp - 1];
        f.acc = k1vm_reduce(f.acc, ks[--kp], f.kind);
        if (++idx[f.level] < f.width) {
          pc = f.start;
        } else {
          idx[f.level] = f.saved;
          ks[kp++] = f.acc;
          --fp;
        }
        break;
      }
      case K1_SENDLOOP: {
        K1vmFrame& f = fr[fp - 1];
        const bool valid = ks[--kp] & 1;
        const K1vmStatus st = ss[--sp];
        const int i = idx[f.level];
        if (i == 0) f.fd0 = st.fd;
        if (valid) {
          if (st.s == K1VM_FAIL) {
            f.flags |= 1;
            if (f.first < 0) {
              f.first = i;
              f.sel = st.fd;
              f.amb = f.host_seen;
            }
          } else if (st.s == K1VM_HOST) {
            f.flags |= 2;
            f.host_seen = true;
          } else if (st.s == K1VM_SKIP) {
            f.flags |= 4;
          } else if (st.s == K1VM_PASS) {
            f.flags |= 8;
          }
        }
        if (++idx[f.level] < f.width) {
          pc = f.start;
        } else {
          idx[f.level] = f.saved;
          // forall's fail detail (eval.py:1598-1610): the first failing
          // element, or element 0 when none fails (argmax of all-false)
          const bool hit = f.first >= 0;
          const int at = hit ? f.first : 0;
          const int32_t sel = hit ? f.sel : f.fd0;
          const bool amb = hit && f.amb;
          const int32_t fd = (amb || sel < 0)
              ? -1 : static_cast<int32_t>(sel | (at << (8 * f.level)));
          ss[sp++] = K1vmStatus{static_cast<int8_t>(f.flags), 0, fd};
          --fp;
        }
        break;
      }
      case K1_SCONST:
        ss[sp++] = K1vmStatus{static_cast<int8_t>(in[1]), 0, -1};
        break;
      case K1_SFROMK: {
        const uint8_t k = ks[--kp];
        const int s = (k & 1) ? in[1] : ((k & 2) ? in[2] : K1VM_HOST);
        ss[sp++] = K1vmStatus{static_cast<int8_t>(s), 0, in[3]};
        break;
      }
      case K1_SVARERR: {
        K1vmStatus& st = ss[sp - 1];
        if (k1vm_load(a, r, k1vm_lane(t, in[1]), idx) != 0 && st.s != K1VM_VAR_ERR) {
          st.s = K1VM_VAR_ERR;
          st.d = static_cast<int8_t>(in[2]);
        }
        break;
      }
      case K1_SFAILGUARD:
        if (!(ks[--kp] & 1)) ss[sp - 1].fd = -1;
        break;
      case K1_STRACKFAIL: {
        const bool guard = ks[--kp] & 1;
        if (ss[sp - 1].s == K1VM_FAIL) ss[sp - 1].s = guard ? K1VM_FAIL : K1VM_HOST;
        break;
      }
      case K1_SSEQ: {
        const K1vmStatus c = ss[--sp];
        if (ss[sp - 1].s == K1VM_PASS) ss[sp - 1] = c;
        break;
      }
      case K1_SANY: {
        const int n = in[1];
        const K1vmStatus* ch = ss + (sp - n);
        bool taken = false, pending = false, all_skip = true;
        int detail = 0;
        int32_t* aux = a.fd_out + r * a.n_cols_u + in[2];
        for (int i = 0; i < n; ++i) {
          const int s = ch[i].s;
          if (s == K1VM_PASS && !taken && !pending) {
            detail = i;
            taken = true;
          }
          pending |= s == K1VM_HOST;
          all_skip &= s == K1VM_SKIP;
          aux[i] = s == K1VM_SKIP ? -2 : (s == K1VM_FAIL ? ch[i].fd : -1);
        }
        sp -= n;
        const int out = taken ? K1VM_PASS
            : (pending ? K1VM_HOST : (all_skip ? K1VM_SKIP : K1VM_FAIL));
        ss[sp++] = K1vmStatus{static_cast<int8_t>(out),
                              static_cast<int8_t>(detail), -1};
        break;
      }
      case K1_SEQUALITY:
        if (!(ks[--kp] & 1)) ss[sp - 1].s = K1VM_PASS;
        break;
      case K1_SCOND: {
        const bool present = ks[--kp] & 1;
        const int sub = ss[sp - 1].s;
        const int s = !present ? in[1]
            : (sub == K1VM_PASS ? K1VM_PASS
                                : (sub == K1VM_HOST ? K1VM_HOST : K1VM_SKIP));
        ss[sp - 1] = K1vmStatus{static_cast<int8_t>(s), 0, -1};
        break;
      }
      case K1_SFORALL:
      case K1_SEXISTS: {
        const K1vmStatus rec = ss[sp - 1];
        const int32_t* ovf_ln = k1vm_lane(t, in[2]);
        const int64_t tag = k1vm_load(a, r, k1vm_lane(t, in[1]), idx);
        const bool ovf = k1vm_load(a, r, ovf_ln, idx) != 0;
        const int fl = rec.s;
        int s;
        int32_t fd = in[3];
        if (in[0] == K1_SFORALL) {
          s = tag != K1VM_TAG_ARRAY ? K1VM_FAIL
              : (fl & 1) ? K1VM_FAIL
              : ((fl & 2) || ovf) ? K1VM_HOST
              : ((fl & 4) && !(fl & 8)) ? K1VM_SKIP : K1VM_PASS;
          if (tag == K1VM_TAG_ARRAY) fd = rec.fd;
        } else {
          s = tag == K1VM_TAG_MISSING ? K1VM_PASS
              : tag != K1VM_TAG_ARRAY ? K1VM_FAIL
              : (fl & 8) ? K1VM_PASS
              : ((fl & 2) || ovf) ? K1VM_HOST : K1VM_FAIL;
        }
        ss[sp - 1] = K1vmStatus{static_cast<int8_t>(s), 0, fd};
        break;
      }
      case K1_SSCALARS: {
        const uint8_t k = ks[--kp];  // (any valid FAIL, any valid unknown)
        const int32_t* ovf_ln = k1vm_lane(t, in[2]);
        const int64_t tag = k1vm_load(a, r, k1vm_lane(t, in[1]), idx);
        const bool ovf = k1vm_load(a, r, ovf_ln, idx) != 0;
        const int s = tag != K1VM_TAG_ARRAY ? K1VM_FAIL
            : (k & 1) ? K1VM_FAIL
            : ((k & 2) || ovf) ? K1VM_HOST : K1VM_PASS;
        ss[sp++] = K1vmStatus{static_cast<int8_t>(s), 0, in[3]};
        break;
      }
      case K1_SUSP: {
        const int32_t* ln = k1vm_lane(t, in[1]);
        const int32_t* len_ln = k1vm_lane(t, in[2]);
        ks[kp++] = k1vm_known(k1vm_susp(k1vm_addr(a, r, ln, idx), ln[2],
                                        k1vm_load(a, r, len_ln, idx)));
        break;
      }
      case K1_IDXLAST: {
        const int64_t c = k1vm_load(a, r, k1vm_lane(t, in[1]), idx);
        ks[kp++] = k1vm_known(idx[in[2]] == (c > 1 ? c - 1 : 0));
        break;
      }
      case K1_PACK2:
        --kp;
        ks[kp - 1] = static_cast<uint8_t>((ks[kp - 1] & 3) | ((ks[kp] & 3) << 2));
        break;
      case K1_IDIN: {
        const int32_t* ln = k1vm_lane(t, in[1]);
        const unsigned char* p = k1vm_addr(a, r, ln, idx);
        const int esz = k1vm_esize(ln[0]);
        bool hit = false;
        for (int j = 0; j < in[2]; ++j) {
          const int64_t x = k1vm_read(p + j * esz, ln[0]);
          for (int k = 0; k < in[4]; ++k) hit |= x == t.i64[in[3] + k];
        }
        ks[kp++] = k1vm_known(hit);
        break;
      }
      case K1_SFEBEGIN:
        ss[sp++] = K1vmStatus{0, 0, 0};
        break;
      case K1_SFEENTRY: {
        const int fl = ks[--kp];
        const bool ovf = ks[--kp] & 1;
        const bool active = ks[--kp] & 1;
        ss[sp - 1].s = static_cast<int8_t>(
            k1vm_foreach_entry(ss[sp - 1].s, fl, active, ovf));
        break;
      }
      case K1_SFEEND: {
        const int acc = ss[sp - 1].s;
        const int s = (acc & 1) ? K1VM_FAIL
            : (acc & 2) ? K1VM_HOST : (acc & 4) ? K1VM_PASS : K1VM_SKIP;
        ss[sp - 1] = K1vmStatus{static_cast<int8_t>(s), 0,
                                (acc & 8) ? 0 : -1};
        break;
      }
      case K1_AEND:
        a.adm_out[r * a.n_adm + in[1]] = static_cast<int8_t>(ks[kp - 1] & 1);
        return executed;
      default:  // K1_PEND
        *slot = ss[sp - 1];
        return executed;
    }
  }
}
