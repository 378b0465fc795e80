// Sorting network and segmented scan on the card: the Hopper port of
// repro/kernels/sortnet.py (bitonic_sort, segmented_scan), shared by
// sort_agg.cu and topk.cu.
//
// The TPU kernels sort a whole VMEM-resident batch with a select-only
// bitonic network and carry every operand through it. A block here has
// 227 KB of shared memory, and the SF-1 sort-aggregate fragment holds
// 2^23 rows (one key lane, the invalid flag and a position: 168 MB), so
// the network runs in global memory and only its inner stages run in
// shared memory:
//   * keys are encoded once into lanes of unsigned 64-bit "ordered bits"
//     (encode_key): unsigned order of the lanes is the order of the keys,
//     descending keys are complemented, -0.0 ties +0.0 as the reference's
//     float compares do, and NaN sorts above +inf as torch.sort puts it;
//   * the last key is always the int32 position, ascending, so the order
//     is total and the sort stable (sortnet.py's tiebreak). A total order
//     has one sorted permutation, so carrying only the key lanes and the
//     position, and gathering every other column by position afterwards,
//     gives the reference's result lane for lane;
//   * a compare-exchange step whose partner distance j is at least the
//     tile (roofline.sort_tiling's block_rows) is one global launch over
//     n/2 pairs; the steps below the tile run in one launch per stage,
//     each block sorting or merging its tile in shared memory.
// What bounds it: HBM bytes. With a tile of 2^12 rows a sort of 2^23 rows
// makes 66 global passes and 12 shared-memory passes over the lanes.
//
// The segmented scan is reduce-then-scan in three launches: each block
// of kScanTile rows reduces its items, one block scans the block totals
// in order, and each block rescans its rows from that carry. Every sum
// is taken in a fixed order, so a run gives the same bits every time
// (unlike groupby.cu's shared atomics).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace sortnet {

typedef unsigned long long u64;

constexpr int kMaxLanes = 16;      // roofline.SORT_MAX_LANES
constexpr int kMaxScanAggs = 8;    // roofline.SORT_MAX_AGGS
constexpr int kStepThreads = 256;
constexpr int kTileThreads = 512;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kCarryThreads = 256;
constexpr u64 kSign = 0x8000000000000000ULL;

// key lanes in device memory, passed by value
struct Lanes {
  u64* k[kMaxLanes];
  int n;
};

// source columns of the encoded lanes: program.DTYPE_CODES types
struct KeySrc {
  const void* p[kMaxLanes];
  int type[kMaxLanes];
  int desc[kMaxLanes];
  int n;
};

__device__ __forceinline__ u64 encode_f64(double x) {
  if (x != x) return 0xFFF8000000000000ULL;  // every NaN: above +inf
  if (x == 0.0) return kSign;                // -0.0 ties +0.0
  const u64 b = (u64)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | kSign);
}

// Ordered bits of column ``p`` (type code as program.DTYPE_CODES) at
// ``row``: integers sign-extend to 64 bits and flip the sign bit, so an
// integer lane decodes back with decode_i64.
__device__ __forceinline__ u64 encode_key(const void* p, int type,
                                          int64_t row, bool desc) {
  u64 u;
  switch (type) {
    case 0: u = encode_f64(static_cast<const double*>(p)[row]); break;
    case 1: u = encode_f64((double)static_cast<const float*>(p)[row]); break;
    case 2: u = (u64)static_cast<const long long*>(p)[row] ^ kSign; break;
    case 3: u = (u64)(long long)static_cast<const int*>(p)[row] ^ kSign; break;
    case 4: u = (u64)(long long)static_cast<const short*>(p)[row] ^ kSign; break;
    case 5:
      u = (u64)(long long)static_cast<const signed char*>(p)[row] ^ kSign;
      break;
    default:
      u = (u64)static_cast<const unsigned char*>(p)[row] ^ kSign;
      break;
  }
  return desc ? ~u : u;
}

__device__ __forceinline__ long long decode_i64(u64 u) {
  return (long long)(u ^ kSign);
}

// Lane 0: the invalid flag (0 for a valid row, so valid rows sort
// first); lanes 1..: the encoded keys; positions 0..n-1.
__global__ void encode_kernel(const unsigned char* __restrict__ mask,
                              KeySrc src, Lanes lanes,
                              int* __restrict__ pos, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    lanes.k[0][i] = mask[i] ? 0ULL : 1ULL;
    for (int q = 0; q < src.n; ++q)
      lanes.k[q + 1][i] = encode_key(src.p[q], src.type[q], i, src.desc[q]);
    pos[i] = (int)i;
  }
}

// Lower index of compare-exchange pair p at partner distance j (a power
// of two): p with a zero bit inserted at j.
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// One global step of the stage that builds sorted runs of ``size`` rows:
// pairs (i, i + j), put in ascending order where bit ``size`` of i is
// clear, else descending (sortnet.py's ``asc``).
__global__ void step_kernel(Lanes lanes, int* __restrict__ pos,
                            int64_t half, int64_t j, int64_t size) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       p < half; p += stride) {
    const int64_t i = pair_low(p, j);
    const int64_t l = i + j;
    const bool asc = (i & size) == 0;
    int c = 0;
    for (int q = 0; q < lanes.n && c == 0; ++q) {
      const u64 a = lanes.k[q][i], b = lanes.k[q][l];
      c = a < b ? -1 : (a > b ? 1 : 0);
    }
    const int pa = pos[i], pb = pos[l];
    if (c == 0) c = pa < pb ? -1 : 1;
    if ((c > 0) == asc) {
      for (int q = 0; q < lanes.n; ++q) {
        const u64 a = lanes.k[q][i];
        lanes.k[q][i] = lanes.k[q][l];
        lanes.k[q][l] = a;
      }
      pos[i] = pb;
      pos[l] = pa;
    }
  }
}

// The stages of block sizes 2^lo_log .. 2^hi_log with partner distance
// below the tile, on one tile of ``tile`` rows in shared memory: lanes
// (lanes.n * tile u64) then positions (tile int).
__global__ void __launch_bounds__(kTileThreads)
    tile_kernel(Lanes lanes, int* __restrict__ pos, int tile, int lo_log,
                int hi_log) {
  extern __shared__ u64 sk[];
  int* sp = reinterpret_cast<int*>(sk + (size_t)lanes.n * tile);
  const int nl = lanes.n;
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    for (int q = 0; q < nl; ++q) sk[q * tile + r] = lanes.k[q][base + r];
    sp[r] = pos[base + r];
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int s = lo_log; s <= hi_log; ++s) {
    const int64_t size = 1LL << s;
    int j = (int)((size >> 1) < half ? (size >> 1) : half);
    for (; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = (int)pair_low(p, j);
        const int l = i + j;
        const bool asc = ((base + i) & size) == 0;
        int c = 0;
        for (int q = 0; q < nl && c == 0; ++q) {
          const u64 a = sk[q * tile + i], b = sk[q * tile + l];
          c = a < b ? -1 : (a > b ? 1 : 0);
        }
        const int pa = sp[i], pb = sp[l];
        if (c == 0) c = pa < pb ? -1 : 1;
        if ((c > 0) == asc) {
          for (int q = 0; q < nl; ++q) {
            const u64 a = sk[q * tile + i];
            sk[q * tile + i] = sk[q * tile + l];
            sk[q * tile + l] = a;
          }
          sp[i] = pb;
          sp[l] = pa;
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    for (int q = 0; q < nl; ++q) lanes.k[q][base + r] = sk[q * tile + r];
    pos[base + r] = sp[r];
  }
}

inline int ilog2(int64_t n) {
  int l = 0;
  while ((1LL << (l + 1)) <= n) ++l;
  return l;
}

inline int grid_for(int64_t items, int threads) {
  const int64_t b = (items + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

// Encode ``src`` (after the invalid flag) into ``lanes`` and sort them,
// with positions, ascending: n a power of two up to 2^30 (int32
// positions and head counts: roofline.SORT_MAX_ROWS), tile a power of
// two.
inline int sort(const unsigned char* mask, const KeySrc& src,
                const Lanes& lanes, int* pos, int64_t n, int tile,
                cudaStream_t s) {
  if (n < 1 || (n & (n - 1)) || n > (1LL << 30) || tile < 2 ||
      (tile & (tile - 1)) || lanes.n != src.n + 1 || lanes.n > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  encode_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0, s>>>(
      mask, src, lanes, pos, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 1) return (int)e;
  if (tile > n) tile = (int)n;
  const size_t smem = (size_t)tile * (lanes.n * sizeof(u64) + sizeof(int));
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)(n / tile);
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  const int log_n = ilog2(n), log_t = ilog2(tile);
  tile_kernel<<<blocks, threads, smem, s>>>(lanes, pos, tile, 1, log_t);
  for (int st = log_t + 1; st <= log_n; ++st) {
    const int64_t size = 1LL << st;
    for (int64_t j = size >> 1; j >= tile; j >>= 1)
      step_kernel<<<grid_for(n / 2, kStepThreads), kStepThreads, 0, s>>>(
          lanes, pos, n / 2, j, size);
    tile_kernel<<<blocks, threads, smem, s>>>(lanes, pos, tile, st, st);
  }
  return (int)cudaGetLastError();
}

// -- segmented scan -----------------------------------------------------------

enum ScanOp { SCAN_SUM = 0, SCAN_MIN = 1, SCAN_MAX = 2 };

struct ScanOps {
  int op[kMaxScanAggs];
  int n;
};

// One scan element: segment-head flag, the count of heads (an int32
// prefix sum: segment ids) and one f64 value per aggregate.
struct Item {
  double v[kMaxScanAggs];
  int cnt;
  int f;
};

__device__ __forceinline__ double ident(int op) {
  return op == SCAN_MIN ? INFINITY : (op == SCAN_MAX ? -INFINITY : 0.0);
}

// jnp.add / jnp.minimum / jnp.maximum: min and max propagate NaN
__device__ __forceinline__ double apply(int op, double a, double b) {
  if (op == SCAN_SUM) return a + b;
  if (a != a || b != b) return a + b;
  if (op == SCAN_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

__device__ __forceinline__ Item identity(const ScanOps& ops) {
  Item x;
  for (int k = 0; k < kMaxScanAggs; ++k)
    x.v[k] = k < ops.n ? ident(ops.op[k]) : 0.0;
  x.cnt = 0;
  x.f = 0;
  return x;
}

// a then b: b's values restart at a head of b
__device__ __forceinline__ Item combine(const Item& a, const Item& b,
                                        const ScanOps& ops) {
  Item r;
  for (int k = 0; k < kMaxScanAggs; ++k)
    r.v[k] = (k >= ops.n || b.f) ? b.v[k] : apply(ops.op[k], a.v[k], b.v[k]);
  r.cnt = a.cnt + b.cnt;
  r.f = a.f | b.f;
  return r;
}

__device__ __forceinline__ Item shfl_up(const Item& x, int d,
                                        const ScanOps& ops) {
  Item r;
  for (int k = 0; k < kMaxScanAggs; ++k)
    r.v[k] = k < ops.n ? __shfl_up_sync(0xffffffffu, x.v[k], d) : 0.0;
  r.cnt = __shfl_up_sync(0xffffffffu, x.cnt, d);
  r.f = __shfl_up_sync(0xffffffffu, x.f, d);
  return r;
}

// Exclusive scan of one Item per thread over the block, in thread order;
// ``total`` receives the block's inclusive total. ``warp_tot`` is shared
// memory of 32 Items. Every thread of the block must call it.
__device__ Item block_exclusive(const Item& x, const ScanOps& ops,
                                Item* warp_tot, Item* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  Item inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Item up = shfl_up(inc, d, ops);
    if (lane >= d) inc = combine(up, inc, ops);
  }
  if (lane == 31) warp_tot[warp] = inc;
  Item excl = shfl_up(inc, 1, ops);
  if (lane == 0) excl = identity(ops);
  __syncthreads();
  if (warp == 0) {
    Item w = lane < n_warps ? warp_tot[lane] : identity(ops);
    for (int d = 1; d < 32; d <<= 1) {
      const Item up = shfl_up(w, d, ops);
      if (lane >= d) w = combine(up, w, ops);
    }
    if (lane < n_warps) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  if (warp > 0) excl = combine(warp_tot[warp - 1], excl, ops);
  *total = warp_tot[n_warps - 1];
  __syncthreads();  // warp_tot is reused by the caller's next scan
  return excl;
}

// Pass 1: each block's total over rows [b*kScanTile, (b+1)*kScanTile),
// its kScanItems rows per thread in order. ``load(row)`` returns the
// row's Item (rows past n are identities).
template <class Load>
__global__ void __launch_bounds__(kScanThreads)
    scan_reduce_kernel(Load load, int64_t n, ScanOps ops,
                       double* __restrict__ aux_v, int* __restrict__ aux_i) {
  __shared__ Item warp_tot[32];
  const int64_t row0 =
      (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  Item acc = identity(ops);
  for (int r = 0; r < kScanItems; ++r)
    if (row0 + r < n) acc = combine(acc, load(row0 + r), ops);
  Item total;
  block_exclusive(acc, ops, warp_tot, &total);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kMaxScanAggs; ++k)
      if (k < ops.n) aux_v[(int64_t)k * gridDim.x + blockIdx.x] = total.v[k];
    aux_i[2 * blockIdx.x] = total.cnt;
    aux_i[2 * blockIdx.x + 1] = total.f;
  }
}

// Pass 2: one block replaces the nb block totals by their exclusive
// prefixes, in block order; aux_i[2 * nb] gets the total head count.
__global__ void __launch_bounds__(kCarryThreads)
    scan_carry_kernel(int nb, ScanOps ops, double* __restrict__ aux_v,
                      int* __restrict__ aux_i) {
  __shared__ Item warp_tot[32];
  const int chunk = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * chunk;
  const int hi = lo + chunk < nb ? lo + chunk : nb;
  auto at = [&](int b) {
    Item x;
    for (int k = 0; k < kMaxScanAggs; ++k)
      x.v[k] = k < ops.n ? aux_v[(int64_t)k * nb + b] : 0.0;
    x.cnt = aux_i[2 * b];
    x.f = aux_i[2 * b + 1];
    return x;
  };
  Item acc = identity(ops);
  for (int b = lo; b < hi; ++b) acc = combine(acc, at(b), ops);
  Item total;
  Item run = block_exclusive(acc, ops, warp_tot, &total);
  for (int b = lo; b < hi; ++b) {
    const Item x = at(b);
    for (int k = 0; k < kMaxScanAggs; ++k)
      if (k < ops.n) aux_v[(int64_t)k * nb + b] = run.v[k];
    aux_i[2 * b] = run.cnt;
    aux_i[2 * b + 1] = run.f;
    run = combine(run, x, ops);
  }
  if (threadIdx.x == 0) aux_i[2 * nb] = total.cnt;
}

// Pass 3: each row's inclusive scan value, from its block's carry; ``sink
// (row, item, n_heads)`` consumes it (n_heads: the total head count).
template <class Load, class Sink>
__global__ void __launch_bounds__(kScanThreads)
    scan_apply_kernel(Load load, Sink sink, int64_t n, ScanOps ops,
                      const double* __restrict__ aux_v,
                      const int* __restrict__ aux_i) {
  __shared__ Item warp_tot[32];
  const int64_t row0 =
      (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  Item acc = identity(ops);
  for (int r = 0; r < kScanItems; ++r)
    if (row0 + r < n) acc = combine(acc, load(row0 + r), ops);
  Item total;
  const Item excl = block_exclusive(acc, ops, warp_tot, &total);
  Item carry;
  for (int k = 0; k < kMaxScanAggs; ++k)
    carry.v[k] = k < ops.n ? aux_v[(int64_t)k * gridDim.x + blockIdx.x] : 0.0;
  carry.cnt = aux_i[2 * blockIdx.x];
  carry.f = aux_i[2 * blockIdx.x + 1];
  const int n_heads = aux_i[2 * gridDim.x];
  Item run = combine(carry, excl, ops);
  for (int r = 0; r < kScanItems; ++r) {
    if (row0 + r >= n) break;
    run = combine(run, load(row0 + r), ops);
    sink(row0 + r, run, n_heads);
  }
}

inline int64_t scan_blocks(int64_t n) {
  return (n + kScanTile - 1) / kScanTile;
}

// The inclusive segmented scan of ``load``'s items over n rows, fed to
// ``sink``. aux_v holds ops.n * scan_blocks(n) doubles, aux_i
// 2 * scan_blocks(n) + 1 ints.
template <class Load, class Sink>
inline int segmented_scan(const Load& load, const Sink& sink, int64_t n,
                          const ScanOps& ops, double* aux_v, int* aux_i,
                          cudaStream_t s) {
  const int64_t nb = scan_blocks(n);
  if (n < 1 || nb > (1LL << 30) || ops.n > kMaxScanAggs)
    return (int)cudaErrorInvalidValue;
  scan_reduce_kernel<Load><<<(int)nb, kScanThreads, 0, s>>>(load, n, ops,
                                                            aux_v, aux_i);
  scan_carry_kernel<<<1, kCarryThreads, 0, s>>>((int)nb, ops, aux_v, aux_i);
  scan_apply_kernel<Load, Sink><<<(int)nb, kScanThreads, 0, s>>>(
      load, sink, n, ops, aux_v, aux_i);
  return (int)cudaGetLastError();
}

}  // namespace sortnet
