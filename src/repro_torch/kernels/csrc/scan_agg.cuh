// Shared pieces of the scan-aggregate kernels (filter_agg.cu,
// groupby.cu, join_probe.cu): the column table, the per-row interpreter
// of the postfix expression programs built by kernels/program.py, the
// f64 identities and combiners, the per-row folds into the ungrouped
// accumulators and the grouped (K, A+1) tile, and the fixed-order
// second pass (contiguous runs of the CTAs' partials, then a tree).
//
// The join kernel reads some program columns on the build side, at the
// probe row's hit position: the loads and folds take a template flag,
// kGather, and a bit mask of the gathered columns. With kGather false
// (the scan kernels) they are the plain row loads.
//
// Built with -fmad=false: the interpreter's mul and add stay separate
// roundings, as in the reference's unfused jnp arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace scan_agg {

constexpr int kMaxCols = 16;   // keep in step with program.MAX_COLS
constexpr int kMaxStack = 16;  // program.MAX_STACK
constexpr int kMaxAggs = 32;   // program.MAX_AGGS

// opcodes: keep in step with kernels/program.py
enum Op {
  COL = 0, CONST = 1, ADD = 2, SUB = 3, MUL = 4, DIV = 5,
  LT = 6, LE = 7, GT = 8, GE = 9, EQ = 10, NE = 11,
  AND = 12, OR = 13, NOT = 14, CASE = 15, IN = 16, TRUNC = 17, F32 = 18
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

// Column j at ``row``, or at ``pos`` where kGather and bit j of
// ``gathered`` is set (a build payload column of the join).
template <bool kGather = false>
__device__ __forceinline__ double load_col(const Cols& c, int j,
                                           int64_t row, int64_t pos = 0,
                                           unsigned gathered = 0u) {
  if (kGather && ((gathered >> j) & 1u)) row = pos;
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
template <bool kGather = false>
__device__ double eval_slot(const Prog& P, int slot, const Cols& cols,
                            int64_t row, int64_t pos = 0,
                            unsigned gathered = 0u) {
  const int lo = __ldg(P.slots + slot), hi = __ldg(P.slots + slot + 1);
  double st[kMaxStack];
  int sp = 0;
  for (int pc = lo; pc < hi; ++pc) {
    const int op = __ldg(P.code + 2 * pc);
    const int arg = __ldg(P.code + 2 * pc + 1);
    switch (op) {
      case COL:
        st[sp++] = load_col<kGather>(cols, arg, row, pos, gathered);
        break;
      case CONST: st[sp++] = __ldg(P.consts + arg); break;
      case NOT: st[sp - 1] = st[sp - 1] == 0.0 ? 1.0 : 0.0; break;
      case TRUNC: st[sp - 1] = trunc(st[sp - 1]); break;
      case F32: st[sp - 1] = (double)__double2float_rn(st[sp - 1]); break;
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

// -- ungrouped: A accumulators per thread, reduced per CTA --------------

__device__ __forceinline__ void init_acc(double* acc, const Prog& P) {
  for (int a = 0; a < P.n_aggs; ++a) acc[a] = identity(__ldg(P.fns + a));
}

// Fold one surviving row into the thread's accumulators.
template <bool kGather = false>
__device__ __forceinline__ void fold_row(double* acc, const Prog& P,
                                         const Cols& cols, int64_t row,
                                         int64_t pos = 0,
                                         unsigned gathered = 0u) {
  for (int a = 0; a < P.n_aggs; ++a) {
    const int fn = __ldg(P.fns + a);
    if (fn == COUNT) {
      acc[a] += 1.0;
    } else {
      acc[a] = combine(fn, acc[a],
                       eval_slot<kGather>(P, 2 + a, cols, row, pos,
                                          gathered));
    }
  }
}

// Reduce the CTA's accumulators by warp shuffles and a pass over the
// warps' partials in shared memory (n_warps × A doubles); thread a < A
// writes partials[blockIdx.x * A + a].
__device__ __forceinline__ void cta_reduce(const double* acc, const Prog& P,
                                           double* warp_part,
                                           double* __restrict__ partials) {
  const int A = P.n_aggs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int a = 0; a < A; ++a) {
    const int fn = __ldg(P.fns + a);
    double v = acc[a];
    for (int off = 16; off > 0; off >>= 1)
      v = combine(fn, v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_part[warp * A + a] = v;
  }
  __syncthreads();
  if (threadIdx.x < A) {
    const int a = threadIdx.x;
    const int fn = __ldg(P.fns + a);
    double v = identity(fn);
    for (int w = 0; w < n_warps; ++w) v = combine(fn, v, warp_part[w * A + a]);
    partials[(int64_t)blockIdx.x * A + a] = v;
  }
}

// -- grouped: one (K, A+1) f64 tile per CTA in shared memory ---------------

__device__ __forceinline__ void init_tile(double* tile, const Prog& P,
                                          int K) {
  const int A = P.n_aggs, W = A + 1;
  const int KW = K * W;
  for (int i = threadIdx.x; i < KW; i += blockDim.x) {
    const int col = i % W;
    tile[i] = col < A ? identity(__ldg(P.fns + col)) : 0.0;
  }
}

// Fold one surviving row into its group: shared atomicAdd for sums,
// counts and the presence column, compare-and-swap for min/max. A row
// whose group id falls outside [0, K) reaches no group, as in the
// reference's one-hot; nothing is written outside the tile.
template <bool kGather = false>
__device__ __forceinline__ void fold_row_grouped(double* tile, const Prog& P,
                                                 const Cols& cols, int K,
                                                 int64_t row, int64_t pos = 0,
                                                 unsigned gathered = 0u) {
  const int A = P.n_aggs, W = A + 1;
  const double g = eval_slot<kGather>(P, 1, cols, row, pos, gathered);
  if (!(g >= 0.0 && g < (double)K)) return;
  double* t = tile + (int)g * W;
  for (int a = 0; a < A; ++a) {
    const int fn = __ldg(P.fns + a);
    if (fn == COUNT) {
      atomicAdd(t + a, 1.0);
      continue;
    }
    const double v = eval_slot<kGather>(P, 2 + a, cols, row, pos, gathered);
    if (fn == SUM) {
      atomicAdd(t + a, v);
    } else {
      atomic_combine_cas(t + a, fn, v);
    }
  }
  atomicAdd(t + A, 1.0);
}

// Copy the CTA's tile to its partials (after a __syncthreads).
__device__ __forceinline__ void write_tile(const double* tile, int KW,
                                           double* __restrict__ partials) {
  double* mine = partials + (int64_t)blockIdx.x * KW;
  for (int i = threadIdx.x; i < KW; i += blockDim.x) mine[i] = tile[i];
}

// Second pass: out[i] = the fold over the CTAs' partials of element i in
// a fixed order, so the result repeats run to run. A block of 256
// threads takes ``lanes`` consecutive elements (32, or the width rounded
// up to a power of two where it is narrower) and splits the partials
// into 256 / lanes contiguous runs: thread (run y, element x) folds run
// y in CTA order, four loads in flight (neighbouring threads read
// neighbouring elements), then a fixed tree in shared memory folds the
// runs, y with y + s for s = runs/2, ..., 1. Element i belongs to
// aggregate column i % row_len; a column past the aggregates is the
// presence count (a sum).
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const double* __restrict__ partials, int n_parts,
                       int64_t width, int row_len,
                       const int* __restrict__ fns, int n_aggs, int lanes,
                       double* __restrict__ out) {
  __shared__ double red[kReduceThreads];
  const int x = threadIdx.x % lanes, y = threadIdx.x / lanes;
  const int runs = kReduceThreads / lanes;
  const int64_t i = blockIdx.x * (int64_t)lanes + x;
  const bool live = i < width;
  int fn = SUM;
  if (live) {
    const int col = (int)(i % row_len);
    fn = col < n_aggs ? __ldg(fns + col) : (int)SUM;
  }
  const int per = (n_parts + runs - 1) / runs;
  const int lo = min(y * per, n_parts), hi = min(lo + per, n_parts);
  double v = identity(fn);
  if (live) {
    int p = lo;
    for (; p + 4 <= hi; p += 4) {
      const double* q = partials + (int64_t)p * width + i;
      const double a = q[0], b = q[width], c = q[2 * width],
                   d = q[3 * width];
      v = combine(fn, combine(fn, combine(fn, combine(fn, v, a), b), c), d);
    }
    for (; p < hi; ++p) v = combine(fn, v, partials[(int64_t)p * width + i]);
  }
  red[threadIdx.x] = v;
  for (int s = runs / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (y < s)
      red[threadIdx.x] =
          combine(fn, red[threadIdx.x], red[threadIdx.x + s * lanes]);
  }
  if (y == 0 && live) out[i] = red[threadIdx.x];
}

inline int reduce_partials(const double* partials, int n_parts,
                           int64_t width, int row_len, const int* fns,
                           int n_aggs, double* out, cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes < width) lanes <<= 1;
  const int blocks = (int)((width + lanes - 1) / lanes);
  reduce_partials_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      partials, n_parts, width, row_len, fns, n_aggs, lanes, out);
  return (int)cudaGetLastError();
}

// Launch the second pass after a scan kernel, if that launched.
inline int finish_partials(const double* partials, int n_parts,
                           int64_t width, int row_len, const int* fns,
                           int n_aggs, double* out, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return reduce_partials(partials, n_parts, width, row_len, fns, n_aggs,
                         out, stream);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
