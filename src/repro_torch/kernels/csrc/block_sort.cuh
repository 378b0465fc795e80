// The whole sort inside one launch: the small-batch path of topk.cu.
//
// sortnet.cuh's radix sort makes two or three launches a digit slot and
// lives in global memory. A batch of at most kBlockMaxRows rows (TPC-H
// Q3's final: capacity 2^14) fits in shared memory instead: one thread-
// block cluster of up to kClusterMax CTAs sorts it in a single launch,
// each CTA holding a slice of at most kCtaRows rows, with the same rules,
// so the same permutation:
//   * the invalid flag and the keys are encoded as sortnet.cuh's
//     encode_key does (descending keys complemented, -0.0 ties +0.0, NaN
//     above +inf);
//   * a stable LSD radix sort of 8-bit digits from the identity
//     permutation, the last key lane's lowest digit first and the flag
//     last; a digit equal in every row (the lane's AND and OR agree) is
//     skipped;
//   * each CTA's shared memory holds the current lane's encoded values of
//     every row, in row order (8 B a row: every CTA encodes the whole
//     lane from the key column, out of L2 after the first, when the sort
//     reaches that lane, and so knows its live digits without the
//     others), and its slice of the permutation (4 B a row: the row, the
//     flag in bit kInvBit). A pass reads each row's value through the
//     permutation, so only the permutation moves;
//   * one pass: each warp ranks a contiguous chunk of its CTA's slice 32
//     rows a step (__match_any_sync finds a step's lanes of one digit, a
//     shared count per warp and digit carries the steps); each CTA
//     publishes its digit counts, the cluster synchronises, and each CTA
//     reads every CTA's counts (all its remote loads in flight at once): a
//     row goes to its digit's offset in the
//     cluster (the digits below it, then its digit in the CTAs below this
//     one, then in this CTA's warps below its own) plus its rank, into
//     the CTA that owns that position. A thread keeps its rows' entries,
//     digits and ranks in registers from the rank to the scatter, so the
//     scatter writes the permutation in place; a second cluster barrier
//     ends the pass.
// The first design was one CTA of 1024 threads; most of its time went to
// the rank steps of one SM. Reading a row's value from its owner CTA each
// pass, or copying the other CTAs' encoded slices once a lane, both cost
// more than every CTA encoding every row (PERF.md, Findings).
// What bounds it: the passes' barriers and rank steps, not bytes: it
// reads each key column once and writes the outputs once.

#pragma once

#include <cooperative_groups.h>

#include "sortnet.cuh"

namespace sortnet {

namespace cg = cooperative_groups;

constexpr int kBlockThreads = 256;          // roofline.TOPK_BLOCK_THREADS
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockSteps = 4;              // rows a thread holds
constexpr int kCtaRows = kBlockThreads * kBlockSteps;  // 1024 a CTA
constexpr int kClusterMax = 16;             // roofline.TOPK_CLUSTER_CTAS
constexpr int kBlockMaxRows = kClusterMax * kCtaRows;  // 2^14
constexpr int kInvBit = 14;                 // an entry: row | inv << 14
constexpr unsigned kRowMask = (1u << kInvBit) - 1u;
constexpr unsigned kEntryMask = (1u << (kInvBit + 1)) - 1u;  // row and flag
constexpr int kDigitShift = kInvBit + 1;    // a thread's row between rank
constexpr int kRankShift = kDigitShift + 8;  // and scatter: entry, digit, rank
static_assert(kBlockMaxRows <= (1 << kInvBit), "rows must fit below the flag");
static_assert(kBlockThreads == kBins, "thread t scans digit t");
static_assert(kCtaRows / kBlockWarps <= 512, "a rank fits 9 bits");

// CTAs of the cluster for n rows (a power of two): kCtaRows rows each.
inline int block_sort_ctas(int64_t n) {
  return n <= kCtaRows ? 1 : (int)(n / kCtaRows);
}

// Dynamic shared memory of a CTA of a cluster sorting n rows, ``rows``
// of them its own: the lane's values of every row, its permutation
// slice, the (warp, digit) counts and the published digit counts, two
// passes' worth (tests/test_torch_topk_block.py mirrors it).
inline size_t block_sort_smem(int64_t n, int64_t rows) {
  return (size_t)n * sizeof(u64) + (size_t)rows * sizeof(unsigned) +
         (size_t)(kBlockWarps + 2) * kBins * sizeof(int);
}

// The bits that differ between the rows, from each thread's AND and OR
// of its rows; ``red``: 2 * kBlockWarps u64 of shared scratch. Every
// thread of the CTA must call it; it ends with a barrier.
__device__ __forceinline__ u64 block_varying(u64 a, u64 o, u64* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, off);
    o |= __shfl_xor_sync(0xffffffffu, o, off);
  }
  if (lane == 0) {
    red[warp] = a;
    red[kBlockWarps + warp] = o;
  }
  __syncthreads();
  a = ~0ULL;
  o = 0ULL;
  for (int w = 0; w < kBlockWarps; ++w) {
    a &= red[w];
    o |= red[kBlockWarps + w];
  }
  __syncthreads();  // red is free again
  return a ^ o;
}

// encode_key's ordered bits of a value already loaded (sortnet.cuh's
// rules: integers sign-extend and flip the sign bit, floats by
// encode_f64), complemented for a descending key.
__device__ __forceinline__ u64 ordered(double x) { return encode_f64(x); }
__device__ __forceinline__ u64 ordered(float x) {
  return encode_f64((double)x);
}
template <class T>
__device__ __forceinline__ u64 ordered(T x) {
  return (u64)(long long)x ^ kSign;
}

// The lane's ordered bits of all n rows into ``ev``, and this thread's
// AND and OR of them; kEncodeBatch loads in flight a thread (64, all of
// a thread's rows at 2^14, made ptxas spill).
constexpr int kEncodeBatch = 16;
template <class T>
__device__ __forceinline__ void encode_lane(const void* p, int n, bool desc,
                                            u64* ev, u64& a, u64& o) {
  const T* __restrict__ col = static_cast<const T*>(p);
  for (int i0 = 0; i0 < n; i0 += kEncodeBatch * kBlockThreads) {
    T x[kEncodeBatch];
#pragma unroll
    for (int s = 0; s < kEncodeBatch; ++s) {
      const int i = i0 + s * kBlockThreads + threadIdx.x;
      if (i < n) x[s] = col[i];
    }
#pragma unroll
    for (int s = 0; s < kEncodeBatch; ++s) {
      const int i = i0 + s * kBlockThreads + threadIdx.x;
      if (i < n) {
        const u64 u = desc ? ~ordered(x[s]) : ordered(x[s]);
        ev[i] = u;
        a &= u;
        o |= u;
      }
    }
  }
}

// Exclusive sum of one int a thread (a digit's total) over the CTA, in
// thread order, with one barrier; ``warp_s``: kBlockWarps ints. Every
// thread must call it, and the next use of ``warp_s`` must follow a
// barrier.
__device__ __forceinline__ int digit_excl_sum(int x, int* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) inc += warp_s[w];
  return inc - x;
}

// A thread's entry of one row between rank and scatter: the permutation
// entry (15 bits), the digit (8) and the rank in its warp's digit (9).
__device__ __forceinline__ unsigned pack_rank(unsigned pf, int dig, int rank) {
  return pf | ((unsigned)dig << kDigitShift) | ((unsigned)rank << kRankShift);
}

// One stable pass over digit d of the lane in the CTAs' ``ev`` (q > 0) or
// over the invalid flag (q == 0), in place on the CTAs' ``perm``; each
// CTA holds ``rows`` = 2^log_rows rows. ``pub``: 2 * kBins ints, this
// pass's half ``buf``; ``doff``: kBins ints.
__device__ __forceinline__ void block_pass(cg::cluster_group& cl, int q,
                                           int d, int rows, int log_rows,
                                           u64* ev, unsigned* perm, int* wc,
                                           int* pub, int* doff, int* warp_s,
                                           int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int me = (int)cl.block_rank();
  for (int b = threadIdx.x; b < kBlockWarps * kBins; b += kBlockThreads)
    wc[b] = 0;
  __syncthreads();
  // each warp's contiguous chunk of the CTA's slice, 32 rows a step
  const int steps = (rows + kBlockThreads - 1) / kBlockThreads;
  const int lo = warp * steps * 32;
  const int hi = lo + steps * 32 < rows ? lo + steps * 32 : rows;
  int* mine = wc + warp * kBins;
  unsigned ent[kBlockSteps];
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s) {  // every load first
    if (s >= steps) break;
    const int i = lo + s * 32 + lane;
    // rows past the chunk: a bin of their own
    ent[s] = (unsigned)kBins << kDigitShift;
    if (i < hi) {
      const unsigned pf = perm[i];
      const unsigned dig =
          q == 0 ? pf >> kInvBit : (unsigned)digit_of(ev[pf & kRowMask], d);
      ent[s] = pf | (dig << kDigitShift);
    }
  }
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s) {
    if (s >= steps) break;
    const int dig = (int)(ent[s] >> kDigitShift);
    const bool ok = dig < kBins;
    // the digit's lanes in this step: their leader takes the warp's count
    // so far and adds them (no other lane of the step has this digit);
    // each ranks after the lanes below it
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (ok && lane == leader) {
      before = mine[dig];
      mine[dig] = before + __popc(peers);
    }
    __syncwarp();
    before = __shfl_sync(0xffffffffu, before, leader);
    if (ok)
      ent[s] = pack_rank(ent[s] & kEntryMask, dig,
                         before + __popc(peers & ((1u << lane) - 1u)));
  }
  __syncthreads();
  // thread t, digit t: its warps' counts to exclusive offsets in warp
  // order, the CTA's total published
  {
    const int dg = threadIdx.x;
    int acc = 0;
    for (int w = 0; w < kBlockWarps; ++w) {
      const int c = wc[w * kBins + dg];
      wc[w * kBins + dg] = acc;
      acc += c;
    }
    pub[buf * kBins + dg] = acc;
  }
  cl.sync();
  // the digit's rows in the CTAs below this one and in all; the digits
  // below it in all CTAs
  {
    const int dg = threadIdx.x, ctas = (int)cl.num_blocks();
    int c[kClusterMax];
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r)  // every load first
      c[r] = r < ctas ? cl.map_shared_rank(pub, r)[buf * kBins + dg] : 0;
    int below = 0, total = 0;
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r) {
      total += c[r];
      below += r < me ? c[r] : 0;
    }
    doff[dg] = digit_excl_sum(total, warp_s) + below;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s) {
    if (s >= steps) break;
    if (lo + s * 32 + lane >= hi) continue;
    const unsigned e = ent[s];
    const int dg = (int)((e >> kDigitShift) & 0xFFu);
    const int at = doff[dg] + mine[dg] + (int)(e >> kRankShift);
    cl.map_shared_rank(perm, at >> log_rows)[at & (rows - 1)] =
        e & kEntryMask;
  }
  cl.sync();
}

// Sort n rows (n <= kBlockMaxRows, a power of two) by [invalid] + the
// keys of ``src``, each ascending or descending, ties in row order, over
// a cluster of block_sort_ctas(n) CTAs of kBlockThreads threads: on
// return each CTA's ``perm`` holds row | inv << kInvBit of its slice of
// the sorted order (its rows = n / CTAs). ``ev``: n u64, ``perm``: rows
// unsigned, ``wc``: kBlockWarps * kBins ints, ``pub``: 2 * kBins ints of
// dynamic shared memory; ``doff`` kBins ints, ``warp_s`` 32 ints and
// ``red`` 2 * kBlockWarps u64 of shared scratch. Every thread of the
// cluster must call it.
__device__ __forceinline__ void block_sort(
    cg::cluster_group& cl, const unsigned char* __restrict__ mask,
    const KeySrc& src, int n, u64* ev, unsigned* perm, int* wc, int* pub,
    int* doff, int* warp_s, u64* red) {
  const int rows = n / (int)cl.num_blocks();
  const int log_rows = 31 - __clz(rows);
  const int lo = (int)cl.block_rank() * rows;
  // the flag of every row (its AND and OR), this CTA's slice of the
  // identity permutation
  u64 a = ~0ULL, o = 0ULL;
  for (int i0 = 0; i0 < n; i0 += kEncodeBatch * kBlockThreads) {
    unsigned char m[kEncodeBatch];
#pragma unroll
    for (int s = 0; s < kEncodeBatch; ++s) {
      const int i = i0 + s * kBlockThreads + threadIdx.x;
      if (i < n) m[s] = mask[i];
    }
#pragma unroll
    for (int s = 0; s < kEncodeBatch; ++s) {
      const int i = i0 + s * kBlockThreads + threadIdx.x;
      if (i < n) {
        const unsigned inv = m[s] ? 0u : 1u;
        if ((unsigned)(i - lo) < (unsigned)rows)
          perm[i - lo] = (unsigned)i | (inv << kInvBit);
        a &= inv;
        o |= inv;
      }
    }
  }
  const u64 var0 = block_varying(a, o, red);
  int buf = 0;
  for (int q = src.n; q >= 1; --q) {
    a = ~0ULL;
    o = 0ULL;
    const void* p = src.p[q - 1];
    const bool desc = src.desc[q - 1];
    switch (src.type[q - 1]) {  // program.DTYPE_CODES
      case 0: encode_lane<double>(p, n, desc, ev, a, o); break;
      case 1: encode_lane<float>(p, n, desc, ev, a, o); break;
      case 2: encode_lane<long long>(p, n, desc, ev, a, o); break;
      case 3: encode_lane<int>(p, n, desc, ev, a, o); break;
      case 4: encode_lane<short>(p, n, desc, ev, a, o); break;
      case 5: encode_lane<signed char>(p, n, desc, ev, a, o); break;
      default: encode_lane<unsigned char>(p, n, desc, ev, a, o); break;
    }
    const u64 var = block_varying(a, o, red);  // its barrier publishes ev
    for (int d = 0; d < kDigits; ++d)
      if (live(var, d)) {
        block_pass(cl, q, d, rows, log_rows, ev, perm, wc, pub, doff, warp_s,
                   buf);
        buf ^= 1;
      }
  }
  if (var0)
    block_pass(cl, 0, 0, rows, log_rows, ev, perm, wc, pub, doff, warp_s,
               buf);
}

}  // namespace sortnet
