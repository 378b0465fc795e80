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
// folds every surviving row into its group (fold_row_grouped in
// scan_agg.cuh): shared atomicAdd for sums, counts and the presence
// column, a compare-and-swap loop for min/max that follows jnp.minimum /
// jnp.maximum (a NaN wins); absent groups keep 0 / +inf / -inf. The
// tiles go to per-CTA partials that a second pass folds in a fixed order.
// What bounds it: HBM bytes (Q1: 45 B/row) as long as the shared atomics
// keep up. With Q1's K = 6 every warp's rows land on
// the same few addresses, so the atomics serialize: the known slow point
// of this first version.

#include "scan_agg.cuh"

namespace scan_agg {

__global__ void groupby_kernel(Cols cols, const unsigned char* __restrict__
                               mask, int64_t n, Prog P, int K,
                               double* __restrict__ partials) {
  extern __shared__ double tile[];
  init_tile(tile, P, K);
  __syncthreads();
  const bool pred = has_slot(P, 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    if (!mask[row]) continue;
    if (pred && eval_slot(P, 0, cols, row) == 0.0) continue;
    fold_row_grouped(tile, P, cols, K, row);
  }
  __syncthreads();
  write_tile(tile, K * (P.n_aggs + 1), partials);
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
  const int rc = allow_smem(groupby_kernel, smem);
  if (rc != 0) return rc;
  groupby_kernel<<<ctas, threads, smem, s>>>(c, mask, n, P, n_groups,
                                             partials);
  return finish_partials(partials, ctas, width, n_aggs + 1, fns, n_aggs,
                         out, s);
}
