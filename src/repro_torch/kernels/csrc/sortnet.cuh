// Sorting and segmented scan on the card: the Hopper port of
// repro/kernels/sortnet.py (bitonic_sort, segmented_scan), shared by
// sort_agg.cu and topk.cu.
//
// The TPU kernels sort a whole VMEM-resident batch with a select-only
// bitonic network and carry every operand through it. Here the batch is
// up to 2^30 rows in device memory (the SF 1 sort-aggregate fragment
// holds 2^23), and the sort is a stable least-significant-digit radix
// sort that gives the network's order:
//   * keys are encoded once into lanes of unsigned 64-bit "ordered bits"
//     (encode_key): unsigned order of the lanes is the order of the keys,
//     descending keys are complemented, -0.0 ties +0.0 as the reference's
//     float compares do, and NaN sorts above +inf as torch.sort puts it.
//     Lane 0 is the invalid flag, so valid rows sort first;
//   * the network's last key is the int32 position, so its order is
//     total. An LSD radix sort is stable and starts from the identity
//     permutation, so ties keep row order: the same total order, hence
//     the same permutation, and every lane gathered by it is bit-identical
//     to the network's. The position is never sorted;
//   * 8-bit digits, from the last key lane's lowest byte to lane 0 (whose
//     only varying bit is bit 0). The encode kernel also reduces each
//     lane's AND and OR; a digit whose bits are equal in every row is
//     skipped. Every pass's kernels read that on the card and return at
//     once, and count from it the live passes before their own, whose
//     parity picks the half of the ping-pong buffers they read, so the
//     launch never reads back or synchronises. With no live pass the
//     lanes are the encoded input and the positions the identity;
//   * one pass is three launches: a per-block 256-bin histogram of
//     ``rows`` rows (warp-aggregated shared atomics, stored bin-major),
//     an exclusive scan of the bins × blocks counts (one block per bin;
//     with at most 16 blocks the scatter sums the histograms itself and
//     this launch is skipped), and a stable scatter: each block ranks its
//     rows by digit in row order (each warp walks a contiguous chunk 32
//     rows at a time, __match_any_sync ranks within the step, per-warp
//     digit counts are scanned across the warps in order), stages value
//     and position in shared memory in digit order, and writes each
//     digit's run to its global offset. A block has the tile's rows (at
//     most 2^12), halved while there are fewer than 16 blocks;
//   * a pass carries the position with the invalid flag in its bit 31
//     and one 8-byte value: the current lane's (gathered at the position
//     on the lane's first live pass) or, in lane 0's pass, lane 1's. So
//     the flag and lane 1 come out in order with no random gather, and
//     the last launch gathers only lanes 2 and up.
// What bounds it: HBM bytes. A live pass reads value and position twice
// (histogram, scatter) and writes them once: 36 B a row.
// At SF 1's GROUP BY l_orderkey (keys up to 6,000,000: 23 varying bits;
// the padding rows' zero key encodes to the sign bit, as every valid key
// does) 4 of the 9 digit slots are live, where the bitonic network this
// replaces made 66 global passes of 20 B a row.
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
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kCarryThreads = 256;
constexpr u64 kSign = 0x8000000000000000ULL;

// radix sort: kernels/sortnet.py RADIX_* mirror these
constexpr int kBins = 256;                 // 8-bit digits
constexpr int kDigits = 8;                 // per 64-bit lane
constexpr int kRadixThreads = 256;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kMaxBlockRows = 4096;        // roofline.SORT_MAX_TILE
constexpr int kMinBlockRows = 256;         // one row a thread
constexpr int kTargetBlocks = 16;          // blocks a small sort spreads over
constexpr int kSelfScanBlocks = 16;        // up to: no scan launch
constexpr int kMaxSteps = kMaxBlockRows / kRadixThreads;  // rows a thread
constexpr int kMaxGrid = 2048;             // encode CTAs
constexpr int64_t kAlign = 256;
constexpr int64_t kStateBytes = 1024;      // >= sizeof(RadixState)
constexpr unsigned kFlag = 0x80000000u;    // the invalid flag beside a
                                           // carried position (< 2^30)

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

// Each lane's AND and OR over the rows, written by the encode kernel and
// read by every pass: which digits are live, and so how many live passes
// come before a given one (its half of the ping-pong buffers).
struct RadixState {
  u64 and_bits[kMaxLanes];
  u64 or_bits[kMaxLanes];
};

// The radix sort's scratch, carved from one buffer (radix_layout).
struct Radix {
  RadixState* st;
  int* totals;       // per digit slot (lane * kDigits + digit): kBins
  int* hist;         // kBins × nb, bin-major; scanned in place
  u64* val[2];       // ping-pong: the current lane's values
  unsigned* pos[2];  // ping-pong: carried positions, invalid flag in bit 31
  Lanes enc;         // encoded lanes in row order
  int64_t n;
  int rows;          // rows per histogram / scatter block
  int nb;            // blocks
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

__device__ __forceinline__ int digit_of(u64 v, int d) {
  return (int)((v >> (8 * d)) & 0xFF);
}

// The bits of lane q that differ between rows.
__device__ __forceinline__ u64 varying(const RadixState* st, int q) {
  return st->and_bits[q] ^ st->or_bits[q];
}

__device__ __forceinline__ bool live(u64 var, int d) {
  return digit_of(var, d) != 0;
}

// Whether digit d is the lowest live digit of a lane: its first pass.
__device__ __forceinline__ bool first_live(u64 var, int d) {
  return d == (__ffsll((long long)var) - 1) / 8;
}

// Live digits of lane q below digit d (lane 0 has one digit).
__device__ __forceinline__ int live_below(u64 var, int q, int d) {
  int c = 0;
  for (int e = 0; e < (q == 0 ? 1 : kDigits) && e < d; ++e) c += live(var, e);
  return c;
}

// Live passes before digit d of lane q, in the sort's order (the last
// lane first, each lane's digits lowest first): the current half of the
// ping-pong buffers is that count's parity. (q, d) = (-1, 0): all of them.
__device__ __forceinline__ int passes_before(const RadixState* st,
                                             int n_lanes, int q, int d) {
  int c = q >= 0 ? live_below(varying(st, q), q, d) : 0;
  for (int p = n_lanes - 1; p > q; --p)
    c += live_below(varying(st, p), p, p == 0 ? 1 : kDigits);
  return c;
}

// Zero the digit totals; AND = all ones, OR = 0.
__global__ void radix_init_kernel(Radix r, int n_slots) {
  for (int i = threadIdx.x; i < n_slots * kBins; i += blockDim.x)
    r.totals[i] = 0;
  if (threadIdx.x < kMaxLanes) {
    r.st->and_bits[threadIdx.x] = ~0ULL;
    r.st->or_bits[threadIdx.x] = 0ULL;
  }
}

// Lane 0: the invalid flag (0 for a valid row, so valid rows sort
// first); lanes 1..: the encoded keys; each lane's AND and OR over the
// rows into the state (one atomic per lane and block).
__global__ void __launch_bounds__(kRadixThreads)
    encode_kernel(const unsigned char* __restrict__ mask, KeySrc src,
                  Radix r) {
  __shared__ u64 s_and[kRadixWarps][kMaxLanes], s_or[kRadixWarps][kMaxLanes];
  const int nl = r.enc.n;
  u64 a[kMaxLanes], o[kMaxLanes];
#pragma unroll
  for (int q = 0; q < kMaxLanes; ++q) {
    a[q] = ~0ULL;
    o[q] = 0ULL;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < r.n;
       i += stride) {
#pragma unroll
    for (int q = 0; q < kMaxLanes; ++q) {
      if (q >= nl) break;
      const u64 u = q == 0 ? (mask[i] ? 0ULL : 1ULL)
                           : encode_key(src.p[q - 1], src.type[q - 1], i,
                                        src.desc[q - 1]);
      r.enc.k[q][i] = u;
      a[q] &= u;
      o[q] |= u;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kMaxLanes; ++q) {
    if (q >= nl) break;
    for (int off = 16; off > 0; off >>= 1) {
      a[q] &= __shfl_xor_sync(0xffffffffu, a[q], off);
      o[q] |= __shfl_xor_sync(0xffffffffu, o[q], off);
    }
    if (lane == 0) {
      s_and[warp][q] = a[q];
      s_or[warp][q] = o[q];
    }
  }
  __syncthreads();
  if (threadIdx.x < nl) {
    u64 ba = ~0ULL, bo = 0ULL;
    for (int w = 0; w < kRadixWarps; ++w) {
      ba &= s_and[w][threadIdx.x];
      bo |= s_or[w][threadIdx.x];
    }
    atomicAnd(&r.st->and_bits[threadIdx.x], ba);
    atomicOr(&r.st->or_bits[threadIdx.x], bo);
  }
}

// Row i of a pass over lane q, in the order the pass reads: ``pf``, its
// carried position with the invalid flag (lane 0) in bit 31 (the
// identity before the first live pass), and ``v``, the value the pass
// carries: lane q's, gathered at the position on the lane's first live
// pass. Lane 0's pass takes its digit from the flag and carries lane 1's
// value (``live1``: lane 1 had a live pass, so the values half holds it),
// so neither lane is gathered at random at the end.
__device__ __forceinline__ void load_row(const Radix& r, int q, bool first,
                                         bool live1, int before, int64_t i,
                                         u64& v, unsigned& pf) {
  const int src = before & 1;
  pf = before == 0 ? ((unsigned)i | ((unsigned)r.enc.k[0][i] << 31))
                   : r.pos[src][i];
  const unsigned p = pf & ~kFlag;
  if (q == 0)
    v = r.enc.n < 2 ? 0ULL : (live1 ? r.val[src][i] : r.enc.k[1][p]);
  else
    v = first ? r.enc.k[q][p] : r.val[src][i];
}

// The pass's digit of a row: the flag for lane 0, else digit d of v.
__device__ __forceinline__ int pass_digit(int q, int d, u64 v, unsigned pf) {
  return q == 0 ? (int)(pf >> 31) : digit_of(v, d);
}

__device__ __forceinline__ bool lane1_live(const Radix& r) {
  return r.enc.n > 1 && varying(r.st, 1) != 0;
}

// Exclusive sum over the block's threads, in thread order; ``total``
// gets the block's sum. ``warp_s``: 32 ints of shared memory. Every
// thread of the block must call it.
__device__ int block_excl_sum(int x, int* warp_s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_s[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < n_warps) warp_s[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int excl = inc - x + (warp > 0 ? warp_s[warp - 1] : 0);
  *total = warp_s[n_warps - 1];
  __syncthreads();  // warp_s is free again
  return excl;
}

// (a) Digit d of lane q: each block's 256-bin histogram of its rows,
// bin-major, and the digit's totals per bin.
__global__ void __launch_bounds__(kRadixThreads)
    radix_hist_kernel(Radix r, int q, int d, int slot) {
  const u64 var = varying(r.st, q);
  if (!live(var, d)) return;
  const bool first = first_live(var, d), live1 = lane1_live(r);
  const int before = passes_before(r.st, r.enc.n, q, d);
  __shared__ int cnt[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t lo = (int64_t)blockIdx.x * r.rows;
  const int64_t hi = lo + r.rows < r.n ? lo + r.rows : r.n;
  // every load of the block's rows first, then the counts
  int dig[kMaxSteps];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    const int64_t i = lo + (int64_t)s * kRadixThreads + threadIdx.x;
    dig[s] = kBins;  // rows past the block: a bin of their own
    if (i < hi) {
      u64 v;
      unsigned pf;
      load_row(r, q, first, live1, before, i, v, pf);
      dig[s] = pass_digit(q, d, v, pf);
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (lo + (int64_t)s * kRadixThreads >= hi) break;
    const unsigned peers = __match_any_sync(0xffffffffu, dig[s]);
    if (dig[s] < kBins && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[dig[s]], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    r.hist[(int64_t)b * r.nb + blockIdx.x] = cnt[b];
    if (cnt[b]) atomicAdd(&r.totals[slot * kBins + b], cnt[b]);
  }
}

// (b) One block per bin: the bin's offset (the totals of the lower bins)
// plus the exclusive scan of its count over the blocks, in place: each
// (bin, block) gets the first global row of its run.
__global__ void __launch_bounds__(kRadixThreads)
    radix_scan_kernel(Radix r, int q, int d, int slot) {
  if (!live(varying(r.st, q), d)) return;
  __shared__ int warp_s[32];
  const int bin = blockIdx.x;
  const int* tot = r.totals + slot * kBins;
  int below = 0;
  for (int b = threadIdx.x; b < bin; b += blockDim.x) below += tot[b];
  int base;
  block_excl_sum(below, warp_s, &base);
  int* h = r.hist + (int64_t)bin * r.nb;
  const int chunk = (r.nb + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * chunk;
  const int hi = lo + chunk < r.nb ? lo + chunk : r.nb;
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += h[j];
  int all;
  int run = base + block_excl_sum(sum, warp_s, &all);
  for (int j = lo; j < hi; ++j) {
    const int c = h[j];
    h[j] = run;
    run += c;
  }
}

inline size_t scatter_smem(int rows) {
  // staged values and positions, per-warp digit counts, the block's
  // digit offsets and the global ones, scan scratch
  return (size_t)rows * (sizeof(u64) + sizeof(int)) +
         (size_t)(kRadixWarps + 2) * kBins * sizeof(int) + 32 * sizeof(int);
}

// (c) The stable scatter of digit d of lane q: each block ranks its rows
// by digit in row order, stages them in shared memory in that order and
// writes each digit's run at its global offset, into the other half of
// the ping-pong buffers. With ``self_scan`` (few blocks) each block sums
// the histograms itself, in place of (b)'s launch.
__global__ void __launch_bounds__(kRadixThreads)
    radix_scatter_kernel(Radix r, int q, int d, int self_scan) {
  const u64 var = varying(r.st, q);
  if (!live(var, d)) return;
  const bool first = first_live(var, d), live1 = lane1_live(r);
  const int before = passes_before(r.st, r.enc.n, q, d);
  const int dst = (before & 1) ^ 1;
  extern __shared__ u64 smem[];
  u64* sv = smem;
  unsigned* sp = reinterpret_cast<unsigned*>(sv + r.rows);
  int* wcount = reinterpret_cast<int*>(sp + r.rows);  // [warps][kBins]
  int* bexcl = wcount + kRadixWarps * kBins;
  int* goff = bexcl + kBins;
  int* warp_s = goff + kBins;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < kRadixWarps * kBins; b += blockDim.x)
    wcount[b] = 0;
  if (self_scan) {
    // thread b: bin b's rows in all blocks and in the blocks before this
    const int b = threadIdx.x;  // kRadixThreads == kBins
    const int* h = r.hist + (int64_t)b * r.nb;
    int all = 0, below = 0;
    for (int j = 0; j < r.nb; ++j) {
      all += h[j];
      if (j < (int)blockIdx.x) below += h[j];
    }
    int total;
    goff[b] = block_excl_sum(all, warp_s, &total) + below;
  } else {
    for (int b = threadIdx.x; b < kBins; b += blockDim.x)
      goff[b] = r.hist[(int64_t)b * r.nb + blockIdx.x];
  }
  __syncthreads();

  // each warp's contiguous chunk of the block's rows, 32 rows a step
  const int64_t lo = (int64_t)blockIdx.x * r.rows;
  const int64_t hi = lo + r.rows < r.n ? lo + r.rows : r.n;
  const int chunk = ((r.rows + kRadixThreads - 1) / kRadixThreads) * 32;
  const int steps = chunk / 32;
  const int64_t wlo = lo + (int64_t)warp * chunk;
  int* wc = wcount + warp * kBins;
  u64 v[kMaxSteps];
  unsigned pf[kMaxSteps];
  int rank[kMaxSteps];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {  // every load first
    const int64_t i = wlo + s * 32 + lane;
    rank[s] = -1;
    if (s < steps && i < hi) {
      load_row(r, q, first, live1, before, i, v[s], pf[s]);
      rank[s] = 0;
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s >= steps) break;
    const bool ok = rank[s] == 0;
    const int dig = ok ? pass_digit(q, d, v[s], pf[s]) : kBins;
    // the digit's lanes in this step: their leader takes the warp's count
    // so far and adds them; each ranks after the lanes below it
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int leader = __ffs(peers) - 1;
    int before_step = 0;
    if (ok && lane == leader) before_step = atomicAdd(&wc[dig], __popc(peers));
    const int c = __shfl_sync(0xffffffffu, before_step, leader);
    if (ok) rank[s] = c + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  // per digit: the warps' counts to exclusive offsets, in warp order,
  // then the block's digit totals to exclusive offsets, in digit order
  {
    const int b = threadIdx.x;  // kRadixThreads == kBins
    int acc = 0;
    for (int w = 0; w < kRadixWarps; ++w) {
      const int c = wcount[w * kBins + b];
      wcount[w * kBins + b] = acc;
      acc += c;
    }
    int all;
    bexcl[b] = block_excl_sum(acc, warp_s, &all);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s >= steps) break;
    if (rank[s] < 0) continue;
    const int dig = pass_digit(q, d, v[s], pf[s]);
    const int at = bexcl[dig] + wc[dig] + rank[s];
    sv[at] = v[s];
    sp[at] = pf[s];
  }
  __syncthreads();
  const int rows = (int)(hi - lo);
  u64* vout = r.val[dst];
  unsigned* pout = r.pos[dst];
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    const u64 x = sv[k];
    const unsigned y = sp[k];
    const int dig = pass_digit(q, d, x, y);
    const int64_t at = (int64_t)goff[dig] + (k - bexcl[dig]);
    vout[at] = x;
    pout[at] = y;
  }
}

// Every lane and the positions in sorted order: lane 0 from the flag
// bit, lane 1 from the values half where a pass of lane 1 or 0 left it
// there in that order, the other lanes gathered at the positions.
__global__ void radix_gather_kernel(Radix r, Lanes lanes,
                                    int* __restrict__ pos) {
  const int passes = passes_before(r.st, lanes.n, -1, 0);
  const unsigned* cur = r.pos[passes & 1];
  const u64* val = r.val[passes & 1];
  const bool sorted1 =
      lanes.n > 1 && (varying(r.st, 1) | varying(r.st, 0)) != 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < r.n;
       i += stride) {
    const unsigned pf = passes == 0
                            ? ((unsigned)i | ((unsigned)r.enc.k[0][i] << 31))
                            : cur[i];
    const unsigned p = pf & ~kFlag;
    pos[i] = (int)p;
    lanes.k[0][i] = pf >> 31;
    if (lanes.n > 1) lanes.k[1][i] = sorted1 ? val[i] : r.enc.k[1][p];
    for (int q = 2; q < lanes.n; ++q) lanes.k[q][i] = r.enc.k[q][p];
  }
}

inline int grid_for(int64_t items, int threads) {
  const int64_t b = (items + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

// Rows a histogram / scatter block: the tile (at most kMaxBlockRows),
// halved down to kMinBlockRows while there are fewer than kTargetBlocks
// blocks, so a small sort still spreads over the SMs.
inline int radix_rows(int64_t n, int tile) {
  int rows = tile < kMaxBlockRows ? tile : kMaxBlockRows;
  while (rows > kMinBlockRows && n / rows < kTargetBlocks) rows /= 2;
  return rows;
}

inline int64_t align_up(int64_t x) {
  return (x + kAlign - 1) / kAlign * kAlign;
}

// Bytes of the radix scratch for n rows, n_lanes lanes and ``tile``
// rows a block (kernels/sortnet.py radix_scratch_bytes); with ``base``,
// also carves it into ``r``.
inline int64_t radix_layout(int64_t n, int n_lanes, int tile, char* base,
                            Radix* r) {
  const int rows = radix_rows(n, tile);
  const int64_t nb = (n + rows - 1) / rows;
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    const int64_t at = off;
    off += align_up(bytes);
    return base ? base + at : nullptr;
  };
  char* st = take(kStateBytes);
  char* totals = take((int64_t)n_lanes * kDigits * kBins * sizeof(int));
  char* hist = take(nb * kBins * (int64_t)sizeof(int));
  char* val0 = take(n * (int64_t)sizeof(u64));
  char* val1 = take(n * (int64_t)sizeof(u64));
  char* pos0 = take(n * (int64_t)sizeof(int));
  char* pos1 = take(n * (int64_t)sizeof(int));
  char* enc[kMaxLanes];
  for (int q = 0; q < n_lanes; ++q) enc[q] = take(n * (int64_t)sizeof(u64));
  if (r) {
    r->st = reinterpret_cast<RadixState*>(st);
    r->totals = reinterpret_cast<int*>(totals);
    r->hist = reinterpret_cast<int*>(hist);
    r->val[0] = reinterpret_cast<u64*>(val0);
    r->val[1] = reinterpret_cast<u64*>(val1);
    r->pos[0] = reinterpret_cast<unsigned*>(pos0);
    r->pos[1] = reinterpret_cast<unsigned*>(pos1);
    for (int q = 0; q < n_lanes; ++q)
      r->enc.k[q] = reinterpret_cast<u64*>(enc[q]);
    r->enc.n = n_lanes;
    r->n = n;
    r->rows = rows;
    r->nb = (int)nb;
  }
  return off;
}

// Encode ``src`` (after the invalid flag) and sort: ``lanes`` gets every
// lane and ``pos`` the positions in ascending order; n a power of two up
// to 2^30 (int32 positions and head counts: roofline.SORT_MAX_ROWS),
// tile a power of two (rows a radix block; at most kMaxBlockRows are
// used); ``scratch`` holds radix_layout's bytes.
inline int sort(const unsigned char* mask, const KeySrc& src,
                const Lanes& lanes, int* pos, int64_t n, int tile,
                void* scratch, int64_t scratch_bytes, cudaStream_t s) {
  if (n < 1 || (n & (n - 1)) || n > (1LL << 30) || tile < 1 ||
      (tile & (tile - 1)) || lanes.n != src.n + 1 || lanes.n > kMaxLanes ||
      radix_layout(n, lanes.n, tile, nullptr, nullptr) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  Radix r;
  radix_layout(n, lanes.n, tile, static_cast<char*>(scratch), &r);
  const size_t smem = scatter_smem(r.rows);
  cudaError_t e = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int g = grid_for(n, kRadixThreads) < kMaxGrid
                    ? grid_for(n, kRadixThreads)
                    : kMaxGrid;
  radix_init_kernel<<<1, kRadixThreads, 0, s>>>(r, lanes.n * kDigits);
  encode_kernel<<<g, kRadixThreads, 0, s>>>(mask, src, r);
  // few blocks sum the histograms themselves: one launch less a pass
  const int self_scan = r.nb <= kSelfScanBlocks;
  // the last key lane's lowest digit first; lane 0 varies in bit 0 only
  for (int q = lanes.n - 1; q >= 0; --q) {
    for (int d = 0; d < (q == 0 ? 1 : kDigits); ++d) {
      const int slot = q * kDigits + d;
      radix_hist_kernel<<<r.nb, kRadixThreads, 0, s>>>(r, q, d, slot);
      if (!self_scan)
        radix_scan_kernel<<<kBins, kRadixThreads, 0, s>>>(r, q, d, slot);
      radix_scatter_kernel<<<r.nb, kRadixThreads, smem, s>>>(r, q, d,
                                                             self_scan);
    }
  }
  radix_gather_kernel<<<grid_for(n, kRadixThreads), kRadixThreads, 0, s>>>(
      r, lanes, pos);
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
