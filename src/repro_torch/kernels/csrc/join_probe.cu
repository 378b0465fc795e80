// Fused broadcast-join probe + filter + aggregate: the Hopper port of the
// Pallas kernel repro/kernels/join_probe.py:fused_join_probe_agg (body
// _join_probe_kernel, search _lower_bound), the TPC-H Q12/Q14/Q19 arm of
// the dispatch layer.
//
// The build side arrives sorted by key (masked rows last under the int64
// sentinel) with its payload columns in the same order, from a torch
// prepass. The TPU kernel kept it resident in VMEM; a block's 227 KB of
// shared memory cannot hold it (SF 1 Q12: 1.5 M keys, 12 MB, plus the
// payload), so here it stays in global memory and the 50 MB L2 keeps it
// close. One thread per probe row, grid-stride:
//   1. load the probe key, lower-bound search the sorted keys (the
//      reference's static trip count, bit_length(B) steps, same lo/hi),
//   2. hit = sk[min(pos, B-1)] == key && row valid && key != INT64_MAX,
//   3. on a hit, run the expression program (scan_agg.cuh), whose build
//      payload columns load at the hit position,
//   4. fold into the grouped (K, A+1) shared tile or the per-thread
//      accumulators, exactly as groupby.cu and filter_agg.cu do, then a
//      second pass folds the per-CTA partials in CTA order.
// What bounds it: HBM bytes for the probe columns; each search adds
// log2(B) dependent L2 reads per valid row, which the bound does not
// count (the least time reads each input once).

#include "scan_agg.cuh"

namespace scan_agg {

constexpr long long kKeySentinel = 0x7fffffffffffffffLL;  // INT64_SENTINEL

__device__ __forceinline__ long long load_key(const void* p, int type,
                                              int64_t row) {
  return type == 2 ? __ldg(static_cast<const long long*>(p) + row)
                   : (long long)__ldg(static_cast<const int*>(p) + row);
}

// First index in sk[0, B) with sk[i] >= pk (jnp.searchsorted, left).
__device__ __forceinline__ uint32_t lower_bound(
    const long long* __restrict__ sk, uint32_t B, int steps, long long pk) {
  uint32_t lo = 0, hi = B;
  for (int s = 0; s < steps && lo < hi; ++s) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(sk + mid) < pk) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kGrouped>
__global__ void join_probe_kernel(Cols cols, unsigned gathered,
                                  const unsigned char* __restrict__ mask,
                                  const void* probe_key, int key_type,
                                  int64_t n,
                                  const long long* __restrict__ sk,
                                  uint32_t B, int steps, Prog P, int K,
                                  double* __restrict__ partials) {
  extern __shared__ double smem[];  // grouped: (K, A+1) tile; else warps
  double acc[kGrouped ? 1 : kMaxAggs];
  if constexpr (kGrouped) {
    init_tile(smem, P, K);
    __syncthreads();
  } else {
    init_acc(acc, P);
  }
  const bool pred = has_slot(P, 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    if (!mask[row]) continue;
    const long long pk = load_key(probe_key, key_type, row);
    if (pk == kKeySentinel) continue;
    uint32_t pos = lower_bound(sk, B, steps, pk);
    if (pos >= B) pos = B - 1;
    if (__ldg(sk + pos) != pk) continue;
    if (pred && eval_slot<true>(P, 0, cols, row, pos, gathered) == 0.0)
      continue;
    if constexpr (kGrouped) {
      fold_row_grouped<true>(smem, P, cols, K, row, pos, gathered);
    } else {
      fold_row<true>(acc, P, cols, row, pos, gathered);
    }
  }
  if constexpr (kGrouped) {
    __syncthreads();
    write_tile(smem, K * (P.n_aggs + 1), partials);
  } else {
    cta_reduce(acc, P, smem, partials);
  }
}

}  // namespace scan_agg

// n_groups == 0: ungrouped, out is (A,); else out is (K, A+1) with the
// presence counts last. key_type is program.DTYPE_CODES' (2 int64, 3
// int32). partials holds ctas × the output's width.
extern "C" int join_probe_launch(const int64_t* col_ptrs,
                                 const int* col_types, int n_cols,
                                 unsigned gathered,
                                 const unsigned char* mask, int64_t n,
                                 const void* probe_key, int key_type,
                                 const long long* sorted_keys,
                                 int64_t n_build, const int* code,
                                 const double* consts, const int* slots,
                                 const int* fns, int n_aggs, int n_groups,
                                 double* partials, double* out, int ctas,
                                 int threads, void* stream) {
  using namespace scan_agg;
  if (n_aggs < (n_groups ? 0 : 1) || n_aggs > kMaxAggs || threads % 32 ||
      threads < n_aggs || n_build < 1 || n_build > (1LL << 31) ||
      (key_type != 2 && key_type != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cols c = make_cols(col_ptrs, col_types, n_cols);
  const Prog P{code, consts, slots, fns, n_aggs};
  int steps = 0;
  while (steps < 63 && (n_build >> steps) > 0) ++steps;  // bit_length
  const uint32_t B = (uint32_t)n_build;
  if (n_groups) {
    const int64_t width = (int64_t)n_groups * (n_aggs + 1);
    const size_t smem = (size_t)width * sizeof(double);
    const int rc = allow_smem(join_probe_kernel<true>, smem);
    if (rc != 0) return rc;
    join_probe_kernel<true><<<ctas, threads, smem, s>>>(
        c, gathered, mask, probe_key, key_type, n, sorted_keys, B, steps, P,
        n_groups, partials);
    return finish_partials(partials, ctas, width, n_aggs + 1, fns, n_aggs,
                           out, s);
  }
  const size_t smem = (size_t)(threads / 32) * n_aggs * sizeof(double);
  join_probe_kernel<false><<<ctas, threads, smem, s>>>(
      c, gathered, mask, probe_key, key_type, n, sorted_keys, B, steps, P, 0,
      partials);
  return finish_partials(partials, ctas, n_aggs, n_aggs, fns, n_aggs, out,
                         s);
}
