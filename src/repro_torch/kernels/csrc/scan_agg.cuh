// Shared pieces of the scan-aggregate kernels (filter_agg.cu,
// groupby.cu): the column table, the per-row interpreter of the
// postfix expression programs built by kernels/program.py, the f64
// identities and combiners, and the fixed-order second pass.
//
// Built with -fmad=false: the interpreter's mul and add stay separate
// roundings, as in the reference's unfused jnp arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace scan_agg {

constexpr int kMaxCols = 16;   // keep in step with program.MAX_COLS
constexpr int kMaxStack = 16;  // program.MAX_STACK
constexpr int kMaxAggs = 32;   // program.MAX_AGGS

// opcodes: keep in step with kernels/program.py
enum Op {
  COL = 0, CONST = 1, ADD = 2, SUB = 3, MUL = 4, DIV = 5,
  LT = 6, LE = 7, GT = 8, GE = 9, EQ = 10, NE = 11,
  AND = 12, OR = 13, NOT = 14, CASE = 15, IN = 16, TRUNC = 17
};
enum Agg { SUM = 0, COUNT = 1, MIN = 2, MAX = 3 };

// column pointers and type codes (program.DTYPE_CODES), passed by value
struct Cols {
  const void* ptr[kMaxCols];
  int type[kMaxCols];
};

// one fused call's program, in device memory
struct Prog {
  const int* code;       // (opcode, arg) pairs
  const double* consts;  // constant pool
  const int* slots;      // slot offsets in pairs: 0 pred, 1 gid, 2+a agg a
  const int* fns;        // aggregate codes (Agg)
  int n_aggs;
};

__device__ __forceinline__ double load_col(const Cols& c, int j,
                                           int64_t row) {
  const void* p = c.ptr[j];
  switch (c.type[j]) {
    case 0: return __ldg(static_cast<const double*>(p) + row);
    case 1: return (double)__ldg(static_cast<const float*>(p) + row);
    case 2: return (double)__ldg(static_cast<const long long*>(p) + row);
    case 3: return (double)__ldg(static_cast<const int*>(p) + row);
    case 4: return (double)static_cast<const short*>(p)[row];
    case 5: return (double)static_cast<const signed char*>(p)[row];
    default: return (double)static_cast<const unsigned char*>(p)[row];
  }
}

__device__ __forceinline__ bool has_slot(const Prog& P, int slot) {
  return __ldg(P.slots + slot + 1) > __ldg(P.slots + slot);
}

// Evaluate one slot of the program for one row; booleans are 0/1.
__device__ double eval_slot(const Prog& P, int slot, const Cols& cols,
                            int64_t row) {
  const int lo = __ldg(P.slots + slot), hi = __ldg(P.slots + slot + 1);
  double st[kMaxStack];
  int sp = 0;
  for (int pc = lo; pc < hi; ++pc) {
    const int op = __ldg(P.code + 2 * pc);
    const int arg = __ldg(P.code + 2 * pc + 1);
    switch (op) {
      case COL: st[sp++] = load_col(cols, arg, row); break;
      case CONST: st[sp++] = __ldg(P.consts + arg); break;
      case NOT: st[sp - 1] = st[sp - 1] == 0.0 ? 1.0 : 0.0; break;
      case TRUNC: st[sp - 1] = trunc(st[sp - 1]); break;
      case IN: {
        const double t = st[sp - 1];
        const int n = (int)__ldg(P.consts + arg);
        double hit = 0.0;
        for (int i = 1; i <= n; ++i)
          if (t == __ldg(P.consts + arg + i)) hit = 1.0;
        st[sp - 1] = hit;
        break;
      }
      case CASE: {
        const double e = st[--sp];
        const double t = st[--sp];
        st[sp - 1] = st[sp - 1] != 0.0 ? t : e;
        break;
      }
      default: {
        const double b = st[--sp];
        const double a = st[sp - 1];
        double r;
        switch (op) {
          case ADD: r = a + b; break;
          case SUB: r = a - b; break;
          case MUL: r = a * b; break;
          case DIV: r = a / b; break;
          case LT: r = a < b ? 1.0 : 0.0; break;
          case LE: r = a <= b ? 1.0 : 0.0; break;
          case GT: r = a > b ? 1.0 : 0.0; break;
          case GE: r = a >= b ? 1.0 : 0.0; break;
          case EQ: r = a == b ? 1.0 : 0.0; break;
          case NE: r = a != b ? 1.0 : 0.0; break;
          case AND: r = (a != 0.0 && b != 0.0) ? 1.0 : 0.0; break;
          case OR: r = (a != 0.0 || b != 0.0) ? 1.0 : 0.0; break;
          default: r = __longlong_as_double(0x7ff8dead00000000ULL);
        }
        st[sp - 1] = r;
      }
    }
  }
  return st[0];
}

// jnp.minimum / jnp.maximum: a NaN on either side wins
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

__device__ __forceinline__ double identity(int fn) {
  return fn == MIN ? INFINITY : (fn == MAX ? -INFINITY : 0.0);
}

__device__ __forceinline__ double combine(int fn, double a, double b) {
  return fn == MIN ? nan_min(a, b) : (fn == MAX ? nan_max(a, b) : a + b);
}

// Shared-memory min/max of a double by compare-and-swap.
__device__ __forceinline__ void atomic_combine_cas(double* addr, int fn,
                                                   double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    const double nv = combine(fn, __longlong_as_double(assumed), v);
    const unsigned long long bits = __double_as_longlong(nv);
    if (bits == assumed) break;
    old = atomicCAS(a, assumed, bits);
  } while (assumed != old);
}

// Second pass: out[i] = fold over the CTAs' partials of element i, in
// CTA order, so the result repeats run to run. Element i belongs to
// aggregate column i % row_len; a column past the aggregates is the
// presence count (a sum).
__global__ void reduce_partials_kernel(const double* __restrict__ partials,
                                       int n_parts, int64_t width,
                                       int row_len,
                                       const int* __restrict__ fns,
                                       int n_aggs,
                                       double* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= width) return;
  const int col = (int)(i % row_len);
  const int fn = col < n_aggs ? __ldg(fns + col) : (int)SUM;
  double v = identity(fn);
  for (int p = 0; p < n_parts; ++p)
    v = combine(fn, v, partials[(int64_t)p * width + i]);
  out[i] = v;
}

inline int reduce_partials(const double* partials, int n_parts,
                           int64_t width, int row_len, const int* fns,
                           int n_aggs, double* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (int)((width + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(
      partials, n_parts, width, row_len, fns, n_aggs, out);
  return (int)cudaGetLastError();
}

inline Cols make_cols(const int64_t* ptrs, const int* types, int n_cols) {
  Cols c;
  for (int j = 0; j < kMaxCols; ++j) {
    c.ptr[j] = j < n_cols ? reinterpret_cast<const void*>(ptrs[j])
                          : nullptr;
    c.type[j] = j < n_cols ? types[j] : 0;
  }
  return c;
}

}  // namespace scan_agg

extern "C" const char* scan_agg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
