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
// close. One thread per probe row, 256-row tiles grid-stride:
//   1. a valid row runs the program's probe predicate first, where it
//      has one (the probe side's own filters: probe columns only); a
//      row it rejects never loads its key; the rows that pass queue up
//      in shared memory, in row order, and run the rest 256 at a time,
//   2. load the probe key, lower-bound search the sorted keys (the
//      reference's static trip count, bit_length(B) steps, same lo/hi),
//   3. hit = sk[min(pos, B-1)] == key && key != INT64_MAX,
//   4. on a hit, run the residual predicate (slot 0), the group id and
//      the aggregates (scan_agg.cuh), whose build payload columns load
//      at the hit position,
//   5. fold into the grouped (K, A+1) shared tile or the per-thread
//      accumulators, exactly as groupby.cu and filter_agg.cu do, then a
//      second pass folds the per-CTA partials in a fixed order.
// A conjunction of pure predicates passes the same rows in either order,
// so step 1 changes which rows pay for the search, not the result: at
// SF 1 TPC-H Q12's probe filters pass about 0.5 % of lineitem, Q14's
// 1.2 % and Q19's 7 %, and each search is bit_length(B) dependent L2
// reads. What bounds it: HBM bytes for the mask and the probe-predicate
// columns of every valid row, the key and the residual's columns of
// the survivors.

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

constexpr int kProbeThreads = 256;  // roofline.THREADS

// One probe row past the probe predicate: search, hit test, residual,
// fold.
template <bool kGrouped>
__device__ __forceinline__ void probe_row(
    const Cols& cols, unsigned gathered, const void* probe_key, int key_type,
    const long long* __restrict__ sk, uint32_t B, int steps, const Prog& P,
    bool pred, int K, double* tile, double* acc, int64_t row) {
  const long long pk = load_key(probe_key, key_type, row);
  if (pk == kKeySentinel) return;
  uint32_t pos = lower_bound(sk, B, steps, pk);
  if (pos >= B) pos = B - 1;
  if (__ldg(sk + pos) != pk) return;
  if (pred && eval_slot<true>(P, 0, cols, row, pos, gathered) == 0.0) return;
  if constexpr (kGrouped) {
    fold_row_grouped<true>(tile, P, cols, K, row, pos, gathered);
  } else {
    fold_row<true>(acc, P, cols, row, pos, gathered);
  }
}

// The CTA takes 256-row tiles grid-stride. Each thread tests its row (the
// mask, then the probe predicate); the rows that pass are compacted, in
// row order, into a queue in shared memory, and once it holds 256 every
// thread takes one: the search, whose bit_length(B) dependent L2 reads
// are the longest wait of a row, then runs with every lane of the warp
// busy, not for one surviving row in 32. A last partial round drains the
// queue.
template <bool kGrouped>
__global__ void __launch_bounds__(kProbeThreads)
join_probe_kernel(Cols cols, unsigned gathered,
                  const unsigned char* __restrict__ mask,
                  const void* probe_key, int key_type, int64_t n,
                  const long long* __restrict__ sk, uint32_t B, int steps,
                  Prog P, int pre_slot, int K,
                  double* __restrict__ partials) {
  extern __shared__ double smem[];  // grouped: (K, A+1) tile; else warps
  __shared__ int queue[2 * kProbeThreads];
  __shared__ int warp_counts[kProbeThreads / 32];
  double acc[kGrouped ? 1 : kMaxAggs];
  if constexpr (kGrouped) {
    init_tile(smem, P, K);
    __syncthreads();
  } else {
    init_acc(acc, P);
  }
  const bool pred = has_slot(P, 0);
  const bool pre = pre_slot >= 0 && has_slot(P, pre_slot);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int queued = 0;  // the same in every thread
  const int64_t n_tiles = (n + kProbeThreads - 1) / kProbeThreads;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t row = t * kProbeThreads + tid;
    const bool keep = row < n && mask[row] &&
                      (!pre || eval_slot(P, pre_slot, cols, row) != 0.0);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int at = queued, total = 0;
    for (int w = 0; w < kProbeThreads / 32; ++w) {
      if (w < warp) at += warp_counts[w];
      total += warp_counts[w];
    }
    if (keep) queue[at + __popc(ballot & ((1u << lane) - 1u))] = (int)row;
    queued += total;
    __syncthreads();  // the queue is written; warp_counts is read
    if (queued >= kProbeThreads) {
      probe_row<kGrouped>(cols, gathered, probe_key, key_type, sk, B, steps,
                          P, pred, K, smem, acc, queue[tid]);
      queued -= kProbeThreads;
      __syncthreads();
      if (tid < queued) queue[tid] = queue[kProbeThreads + tid];
      __syncthreads();
    }
  }
  if (tid < queued)
    probe_row<kGrouped>(cols, gathered, probe_key, key_type, sk, B, steps, P,
                        pred, K, smem, acc, queue[tid]);
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
// int32). pre_slot: the program's probe-predicate slot, or -1. partials
// holds ctas × the output's width.
extern "C" int join_probe_launch(const int64_t* col_ptrs,
                                 const int* col_types, int n_cols,
                                 unsigned gathered,
                                 const unsigned char* mask, int64_t n,
                                 const void* probe_key, int key_type,
                                 const long long* sorted_keys,
                                 int64_t n_build, const int* code,
                                 const double* consts, const int* slots,
                                 const int* fns, int n_aggs, int pre_slot,
                                 int n_groups,
                                 double* partials, double* out, int ctas,
                                 int threads, void* stream) {
  using namespace scan_agg;
  if (n_aggs < (n_groups ? 0 : 1) || n_aggs > kMaxAggs ||
      threads != kProbeThreads || n_build < 1 || n_build > (1LL << 31) ||
      n >= (1LL << 31) || (key_type != 2 && key_type != 3))
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
        pre_slot, n_groups, partials);
    return finish_partials(partials, ctas, width, n_aggs + 1, fns, n_aggs,
                           out, s);
  }
  const size_t smem = (size_t)(threads / 32) * n_aggs * sizeof(double);
  join_probe_kernel<false><<<ctas, threads, smem, s>>>(
      c, gathered, mask, probe_key, key_type, n, sorted_keys, B, steps, P,
      pre_slot, 0, partials);
  return finish_partials(partials, ctas, n_aggs, n_aggs, fns, n_aggs, out,
                         s);
}
