// Fused filter + grouped sum/count/min/max: the Hopper port of two Pallas
// kernels of the dispatch layer, both of which launch it —
//   repro/kernels/groupby_onehot.py:fused_groupby (body
//   _fused_groupby_kernel), the TPC-H Q1 arm (sum and count), and
//   repro/kernels/segmented_minmax.py:fused_groupby_minmax (helpers
//   init_group_tile and grouped_tile_update), the arm of grouped
//   aggregates with min or max.
//
// The TPU kernels turned grouping into a one-hot matmul on the MXU, with
// masked broadcast min/max reductions beside it. Here each CTA keeps a
// (K, A+1) f64 tile in shared memory, seeded with the identities, and
// folds every surviving row into its group: shared atomicAdd for sums,
// counts and the presence column, a compare-and-swap loop for min/max
// that follows jnp.minimum / jnp.maximum (a NaN wins); absent groups keep
// 0 / +inf / -inf. The tiles go to per-CTA partials that a second pass
// folds in CTA order. What bounds it: HBM bytes (Q1: 45 B/row) as long as
// the shared atomics keep up. With Q1's K = 6 every warp's rows land on
// the same few addresses, so the atomics serialize: the known slow point
// of this first version.

#include "scan_agg.cuh"

namespace scan_agg {

// Rows whose group id falls outside [0, K) reach no group, as in the
// reference's one-hot; nothing is written outside the tile.
__global__ void groupby_kernel(Cols cols, const unsigned char* __restrict__
                               mask, int64_t n, Prog P, int K,
                               double* __restrict__ partials) {
  extern __shared__ double tile[];
  const int A = P.n_aggs, W = A + 1;
  const int KW = K * W;
  for (int i = threadIdx.x; i < KW; i += blockDim.x) {
    const int col = i % W;
    tile[i] = col < A ? identity(__ldg(P.fns + col)) : 0.0;
  }
  __syncthreads();
  const bool pred = has_slot(P, 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    if (!mask[row]) continue;
    if (pred && eval_slot(P, 0, cols, row) == 0.0) continue;
    const double g = eval_slot(P, 1, cols, row);
    if (!(g >= 0.0 && g < (double)K)) continue;
    double* t = tile + (int)g * W;
    for (int a = 0; a < A; ++a) {
      const int fn = __ldg(P.fns + a);
      if (fn == COUNT) {
        atomicAdd(t + a, 1.0);
        continue;
      }
      const double v = eval_slot(P, 2 + a, cols, row);
      if (fn == SUM) {
        atomicAdd(t + a, v);
      } else {
        atomic_combine_cas(t + a, fn, v);
      }
    }
    atomicAdd(t + A, 1.0);
  }
  __syncthreads();
  double* mine = partials + (int64_t)blockIdx.x * KW;
  for (int i = threadIdx.x; i < KW; i += blockDim.x) mine[i] = tile[i];
}

}  // namespace scan_agg

extern "C" int groupby_launch(const int64_t* col_ptrs, const int* col_types,
                              int n_cols, const unsigned char* mask,
                              int64_t n, const int* code,
                              const double* consts, const int* slots,
                              const int* fns, int n_aggs, int n_groups,
                              double* partials, double* out, int ctas,
                              int threads, void* stream) {
  using namespace scan_agg;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cols c = make_cols(col_ptrs, col_types, n_cols);
  const Prog P{code, consts, slots, fns, n_aggs};
  const int64_t width = (int64_t)n_groups * (n_aggs + 1);
  const size_t smem = (size_t)width * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        groupby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  groupby_kernel<<<ctas, threads, smem, s>>>(c, mask, n, P, n_groups,
                                             partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return reduce_partials(partials, ctas, width, n_aggs + 1, fns, n_aggs,
                         out, s);
}
