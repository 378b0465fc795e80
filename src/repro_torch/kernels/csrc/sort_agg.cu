// Sort-strategy grouped aggregation: the Hopper port of the Pallas kernel
// repro/kernels/sort_agg.py:fused_sort_agg (body _sort_agg_kernel), the
// arm of the dispatch layer for a GROUP BY whose keys are not dictionary
// coded (partial_agg over a scan, strategy "sort").
//
// The predicate and the aggregate arguments are evaluated before the
// launch, as the reference evaluates them outside its pallas_call. Then:
//   1. sortnet::sort orders the rows by [invalid] + the int64 group keys
//      + the position (a stable LSD radix sort of the key lanes that
//      carries the positions; sortnet.cuh);
//   2. one segmented scan (sortnet::segmented_scan) over the sorted rows:
//      a row is a segment head where any lane differs from the row
//      before; each aggregate value is read at the row's position, as
//      sum/count of v * maskf and min/max of where(valid, v, +-inf)
//      (multiplied, not selected: a NaN or inf in a masked row gives
//      what the reference gives); the head count is the segment id;
//   3. compaction: the reference's placement sort is a scatter here. A
//      segment's last row writes its totals to output lane ``seg``, its
//      keys (or INT64_MAX for an invalid segment) and its mask; every
//      lane at or past the segment count takes the identities (INT64_MAX
//      keys, 0 sums, +-inf min/max, false mask). The output equals
//      operators.make_sort_agg lane for lane.
// What bounds it: HBM bytes of the radix passes (sortnet.cuh) and of the
// scan's reads of every lane.

#include "sortnet.cuh"

namespace sortnet {

constexpr long long kKeySentinel = 0x7fffffffffffffffLL;  // INT64_SENTINEL
enum Agg { SUM = 0, COUNT = 1, MIN = 2, MAX = 3 };       // program.AGG_CODES

struct Vals {
  const double* p[kMaxScanAggs];
  int fn[kMaxScanAggs];
  int n;
};

struct Out {
  long long* key[kMaxLanes];
  double* val[kMaxScanAggs];
  unsigned char* mask;
};

__device__ __forceinline__ bool new_segment(const Lanes& L, int64_t i) {
  if (i == 0) return true;
  for (int q = 0; q < L.n; ++q)
    if (L.k[q][i] != L.k[q][i - 1]) return true;
  return false;
}

struct AggLoad {
  Lanes lanes;
  const int* pos;
  Vals vals;

  __device__ Item operator()(int64_t i) const {
    Item x;
    const bool valid = lanes.k[0][i] == 0ULL;
    const double maskf = valid ? 1.0 : 0.0;
    const int p = pos[i];
    for (int k = 0; k < kMaxScanAggs; ++k) {
      if (k >= vals.n) {
        x.v[k] = 0.0;
        continue;
      }
      const int fn = vals.fn[k];
      if (fn == COUNT) {
        x.v[k] = maskf * maskf;
      } else {
        const double v = vals.p[k][p];
        x.v[k] = fn == SUM ? v * maskf
                           : (valid ? v : (fn == MIN ? INFINITY : -INFINITY));
      }
    }
    x.f = new_segment(lanes, i) ? 1 : 0;
    x.cnt = x.f;
    return x;
  }
};

struct AggSink {
  Lanes lanes;
  Vals vals;
  Out out;
  int64_t n;

  __device__ void operator()(int64_t i, const Item& run, int n_heads) const {
    if (i >= n_heads) {  // no segment lands here: the identities
      for (int q = 1; q < lanes.n; ++q) out.key[q - 1][i] = kKeySentinel;
      for (int k = 0; k < kMaxScanAggs; ++k)
        if (k < vals.n)
          out.val[k][i] = vals.fn[k] == MIN
                              ? INFINITY
                              : (vals.fn[k] == MAX ? -INFINITY : 0.0);
      out.mask[i] = 0;
    }
    if (i + 1 < n && !new_segment(lanes, i + 1)) return;  // not its last row
    const int64_t seg = run.cnt - 1;
    const bool valid = lanes.k[0][i] == 0ULL;
    for (int q = 1; q < lanes.n; ++q)
      out.key[q - 1][seg] = valid ? decode_i64(lanes.k[q][i]) : kKeySentinel;
    for (int k = 0; k < kMaxScanAggs; ++k)
      if (k < vals.n) out.val[k][seg] = run.v[k];
    out.mask[seg] = valid ? 1 : 0;
  }
};

}  // namespace sortnet

// mask: the row mask with the predicate folded in (bool, n). keys: n_keys
// int64 columns. vals: n_aggs f64 columns (a count's pointer is unused),
// fns: program.AGG_CODES. lanes: 1 + n_keys u64 scratch columns, pos: n
// int32 scratch, tile: rows a radix block (roofline.sort_tiling), scratch:
// the radix sort's scratch_bytes (sortnet::radix_layout).
// aux_v: n_aggs * ceil(n / 1024) doubles, aux_i: 2 * ceil(n / 1024) + 1
// ints. out_keys / out_vals / out_mask: n rows each.
extern "C" int sort_agg_launch(const unsigned char* mask, int64_t n,
                               const int64_t* key_ptrs, int n_keys,
                               const int64_t* val_ptrs, const int* fns,
                               int n_aggs, const int64_t* lane_ptrs,
                               int* pos, int tile, void* scratch,
                               int64_t scratch_bytes, double* aux_v,
                               int* aux_i, const int64_t* out_key_ptrs,
                               const int64_t* out_val_ptrs,
                               unsigned char* out_mask, void* stream) {
  using namespace sortnet;
  if (n_keys < 0 || n_keys + 1 > kMaxLanes || n_aggs < 0 ||
      n_aggs > kMaxScanAggs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeySrc src{};
  Lanes lanes{};
  Out out{};
  for (int q = 0; q < n_keys; ++q) {
    src.p[q] = reinterpret_cast<const void*>(key_ptrs[q]);
    src.type[q] = 2;  // int64
    src.desc[q] = 0;
    out.key[q] = reinterpret_cast<long long*>(out_key_ptrs[q]);
  }
  src.n = n_keys;
  for (int q = 0; q <= n_keys; ++q)
    lanes.k[q] = reinterpret_cast<u64*>(lane_ptrs[q]);
  lanes.n = n_keys + 1;
  Vals vals{};
  ScanOps ops{};
  for (int k = 0; k < n_aggs; ++k) {
    vals.p[k] = reinterpret_cast<const double*>(val_ptrs[k]);
    vals.fn[k] = fns[k];
    ops.op[k] = fns[k] == MIN ? SCAN_MIN : (fns[k] == MAX ? SCAN_MAX : SCAN_SUM);
    out.val[k] = reinterpret_cast<double*>(out_val_ptrs[k]);
  }
  vals.n = ops.n = n_aggs;
  out.mask = out_mask;
  int rc = sort(mask, src, lanes, pos, n, tile, scratch, scratch_bytes, s);
  if (rc != 0) return rc;
  return segmented_scan(AggLoad{lanes, pos, vals},
                        AggSink{lanes, vals, out, n}, n, ops, aux_v, aux_i,
                        s);
}
