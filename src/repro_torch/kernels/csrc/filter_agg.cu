// Fused filter + ungrouped aggregate: the Hopper port of the Pallas
// kernel repro/kernels/filter_agg.py:fused_filter_agg (body
// _fused_filter_agg_kernel), the TPC-H Q6 arm of the dispatch layer.
//
// What bounds it: HBM bytes. Each valid row reads its columns once
// (Q6: 29 B/row with the mask) and does a few dozen f64 operations, far
// below the card's FP64 balance point. The design streams rows
// grid-stride (neighbouring threads on neighbouring rows, so loads
// coalesce), keeps the A accumulators in registers, reduces each CTA
// by warp shuffles and a shared-memory pass over the warps, and writes
// per-CTA partials (ctas, A); a second pass folds them in CTA order,
// so the result repeats run to run. The TPU kernel's sequential grid
// carried the accumulator across steps; blocks here run in no order,
// hence the two passes.

#include "scan_agg.cuh"

namespace scan_agg {

__global__ void filter_agg_kernel(Cols cols,
                                  const unsigned char* __restrict__ mask,
                                  int64_t n, Prog P,
                                  double* __restrict__ partials) {
  extern __shared__ double warp_part[];  // (n_warps, A)
  double acc[kMaxAggs];
  init_acc(acc, P);
  const bool pred = has_slot(P, 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    if (!mask[row]) continue;
    if (pred && eval_slot(P, 0, cols, row) == 0.0) continue;
    fold_row(acc, P, cols, row);
  }
  cta_reduce(acc, P, warp_part, partials);
}

}  // namespace scan_agg

extern "C" int filter_agg_launch(const int64_t* col_ptrs,
                                 const int* col_types, int n_cols,
                                 const unsigned char* mask, int64_t n,
                                 const int* code, const double* consts,
                                 const int* slots, const int* fns,
                                 int n_aggs, double* partials, double* out,
                                 int ctas, int threads, void* stream) {
  using namespace scan_agg;
  if (n_aggs < 1 || n_aggs > kMaxAggs || threads % 32 || threads < n_aggs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cols c = make_cols(col_ptrs, col_types, n_cols);
  const Prog P{code, consts, slots, fns, n_aggs};
  const size_t smem = (size_t)(threads / 32) * n_aggs * sizeof(double);
  filter_agg_kernel<<<ctas, threads, smem, s>>>(c, mask, n, P, partials);
  return finish_partials(partials, ctas, n_aggs, n_aggs, fns, n_aggs, out,
                         s);
}
