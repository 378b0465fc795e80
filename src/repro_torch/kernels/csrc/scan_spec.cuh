// Skeletons of the compiled scan-aggregate kernels: the Hopper port of
// the Pallas kernels
//   repro/kernels/filter_agg.py:fused_filter_agg (TPC-H Q6's arm),
//   repro/kernels/groupby_onehot.py:fused_groupby (Q1's arm) and
//   repro/kernels/segmented_minmax.py:fused_groupby_minmax (grouped
//   aggregates with min or max).
//
// The reference traces each query's jnp closures into its kernel body.
// Here kernels/specialise.py does the same: it writes one typed program's
// predicate, group id and aggregate arguments as straight-line code (a
// struct Spec: no stack array, each column loaded once with its static
// type, constants bit-exact), and NVRTC compiles it with one skeleton
// below into that program's own kernel at first use. Per row the values
// are bit for bit those of scan_agg.cuh's interpreter (eval_slot): the
// same operations in the same order, built with -fmad=false.
//
// What bounds them: HBM bytes (Q6 about 21 B a row, Q1 about 45) against
// a few dozen f64 operations a row, far below the FP64 balance point. So
// each thread takes kRows rows an iteration (neighbouring threads on
// neighbouring rows) and issues the predicate columns' loads of all of
// them (every column's, where there is no predicate) before the first
// use, beside the next iteration's mask; the other columns load only for
// the rows that pass, and no column for a masked row. Three skeletons:
//   filter_agg  ungrouped: A accumulators in registers, a warp shuffle
//               and a fold over the warps in shared memory;
//   group_regs  grouped, K·(A+1) small (specialise.REG_TILE): each
//               thread keeps acc[K][A+1] in registers and folds a row
//               into its group by a branch-free select over the unrolled
//               k, the one-hot of the reference done in registers; then
//               a warp shuffle per (k, a) and a fold over the warps in
//               fixed order. No atomics: the result repeats bit for bit.
//   group_smem  grouped, larger tiles (up to lower.MAX_KERNEL_GROUPS
//               groups): one (K, A+1) tile per CTA in shared memory,
//               shared atomicAdd for sums and the presence column,
//               compare-and-swap for min/max.
// Each writes per-CTA partials, which scan_agg.cuh's reduce_partials_kernel
// folds in a fixed order. Min and max follow jnp.minimum / jnp.maximum
// (a NaN wins); a group id outside [0, K) reaches no group.
//
// A Spec provides
//   kA, kK (0: ungrouped), kHasPred, fn(a) (the scan_agg::Agg of a);
//   Row (the columns of one row, in their own types);
//   load_pred(c, i, r): the predicate's columns of row i;
//   load_rest(c, i, r): the other columns;
//   pred(r), gid(r): the slots' values; args(r, v): v[a] for each
//   aggregate (1.0 for a count).
// A count folds the same 1.0s as the row count beside it (the grouped
// tiles' presence column), so the skeletons fold that once and copy it.

#pragma once

#include "scan_agg.cuh"

namespace scan_spec {

using scan_agg::combine;
using scan_agg::identity;
using scan_agg::kMaxCols;

constexpr int kRows = 4;  // rows a thread takes an iteration (specialise.ROWS)

// the program's column pointers, in program order
struct ColPtrs {
  const void* p[kMaxCols];
};

// Call fold(row) for each of the CTA's rows that is valid and passes the
// predicate, kRows rows a thread an iteration. The mask of the next
// iteration loads with this one's columns, so a masked row (the
// block's padding) loads no column and costs no extra round trip.
template <class S, int kThreads, class Fold>
__device__ __forceinline__ void for_rows(const ColPtrs& c,
                                         const unsigned char* __restrict__
                                         mask, int64_t n, Fold&& fold) {
  const int64_t step = (int64_t)gridDim.x * kThreads * kRows;
  int64_t base = (int64_t)blockIdx.x * kThreads * kRows + threadIdx.x;
  bool next[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t i = base + (int64_t)j * kThreads;
    next[j] = i < n && mask[i] != 0;
  }
  for (; base < n; base += step) {
    typename S::Row r[kRows];
    bool live[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      live[j] = next[j];
      const int64_t i = base + (int64_t)j * kThreads;
      if (live[j]) S::load_pred(c, i, r[j]);
      next[j] = i + step < n && mask[i + step] != 0;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (S::kHasPred && live[j]) live[j] = S::pred(r[j]) != 0.0;
      if (live[j]) S::load_rest(c, base + (int64_t)j * kThreads, r[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (live[j]) fold(r[j]);
  }
}

// Ungrouped: partials[blockIdx.x * A + a].
template <class S, int kThreads>
__device__ __forceinline__ void filter_agg(const ColPtrs& c,
                                           const unsigned char* __restrict__
                                           mask, int64_t n,
                                           double* __restrict__ partials) {
  constexpr int A = S::kA, kWarps = kThreads / 32;
  __shared__ double warp_part[kWarps][A];
  double acc[A], rows = 0.0;
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = identity(S::fn(a));
  for_rows<S, kThreads>(c, mask, n, [&](const typename S::Row& r) {
    double v[A];
    S::args(r, v);
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (S::fn(a) != scan_agg::COUNT)
        acc[a] = combine(S::fn(a), acc[a], v[a]);
    rows += 1.0;
  });
  // every count is the sum of the same 1.0s: fold one, copy it
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (S::fn(a) == scan_agg::COUNT) acc[a] = rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    double v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = combine(S::fn(a), v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_part[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < A) {
    const int a = threadIdx.x;
    const int fn = S::fn(a);
    double v = identity(fn);
    for (int w = 0; w < kWarps; ++w) v = combine(fn, v, warp_part[w][a]);
    partials[(int64_t)blockIdx.x * A + a] = v;
  }
}

// The group of a row, or -1 outside [0, K) (as the interpreter's fold).
template <class S>
__device__ __forceinline__ int group_of(const typename S::Row& r) {
  const double g = S::gid(r);
  return (g >= 0.0 && g < (double)S::kK) ? (int)g : -1;
}

// Grouped in registers: partials[blockIdx.x][k][0..A], column A the
// presence count.
template <class S, int kThreads>
__device__ __forceinline__ void group_regs(const ColPtrs& c,
                                           const unsigned char* __restrict__
                                           mask, int64_t n,
                                           double* __restrict__ partials) {
  constexpr int K = S::kK, A = S::kA, W = A + 1, kWarps = kThreads / 32;
  __shared__ double warp_part[kWarps][K * W];
  double acc[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < A; ++a) acc[k][a] = identity(S::fn(a));
    acc[k][A] = 0.0;
  }
  for_rows<S, kThreads>(c, mask, n, [&](const typename S::Row& r) {
    const int g = group_of<S>(r);
    double v[A > 0 ? A : 1];
    S::args(r, v);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool hit = g == k;
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (S::fn(a) != scan_agg::COUNT)
          acc[k][a] = hit ? combine(S::fn(a), acc[k][a], v[a]) : acc[k][a];
      acc[k][A] = hit ? acc[k][A] + 1.0 : acc[k][A];
    }
  });
  // a count is the presence column (the same 1.0s, in the same order):
  // it takes no register and no add until here
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (S::fn(a) == scan_agg::COUNT) acc[k][a] = acc[k][A];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < W; ++a) {
      const int fn = a < A ? S::fn(a) : (int)scan_agg::SUM;
      double v = acc[k][a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = combine(fn, v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) warp_part[warp][k * W + a] = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * W; i += kThreads) {
    const int a = i % W;
    const int fn = a < A ? S::fn(a) : (int)scan_agg::SUM;
    double v = identity(fn);
    for (int w = 0; w < kWarps; ++w) v = combine(fn, v, warp_part[w][i]);
    partials[(int64_t)blockIdx.x * (K * W) + i] = v;
  }
}

// Grouped in shared memory (dynamic, K * (A+1) doubles).
template <class S, int kThreads>
__device__ __forceinline__ void group_smem(const ColPtrs& c,
                                           const unsigned char* __restrict__
                                           mask, int64_t n,
                                           double* __restrict__ partials) {
  constexpr int K = S::kK, A = S::kA, W = A + 1;
  extern __shared__ double tile[];
  for (int i = threadIdx.x; i < K * W; i += kThreads) {
    const int a = i % W;
    tile[i] = a < A ? identity(S::fn(a)) : 0.0;
  }
  __syncthreads();
  for_rows<S, kThreads>(c, mask, n, [&](const typename S::Row& r) {
    const int g = group_of<S>(r);
    if (g < 0) return;
    double v[A > 0 ? A : 1];
    S::args(r, v);
    double* t = tile + g * W;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (S::fn(a) == scan_agg::MIN || S::fn(a) == scan_agg::MAX)
        scan_agg::atomic_combine_cas(t + a, S::fn(a), v[a]);
      else if (S::fn(a) == scan_agg::SUM)
        atomicAdd(t + a, v[a]);
    }
    atomicAdd(t + A, 1.0);
  });
  __syncthreads();
  // a count is the group's presence column
  for (int i = threadIdx.x; i < K * W; i += kThreads) {
    const int a = i % W;
    const bool count = a < A && S::fn(a) == scan_agg::COUNT;
    partials[(int64_t)blockIdx.x * (K * W) + i] =
        tile[count ? i - a + A : i];
  }
}

}  // namespace scan_spec
