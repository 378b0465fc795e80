// TPC-H Q6 with a fixed predicate: the Hopper port of the Pallas kernel
// repro/kernels/filter_agg.py:filter_agg (body _filter_agg_kernel), the
// benchmark half of that file (filter_agg.cu ports its generic half).
// Returns [sum(price * discount), count] over the rows with
//   date_lo <= ship < date_hi, disc_lo <= disc <= disc_hi, qty < qty_hi.
//
// The float bounds arrive as float: the reference compares its float32
// columns with Python floats, which JAX rounds to float32 (0.07f > 0.07,
// so a discount of float32(0.07) passes "<= 0.07" there and must here).
// The revenue is a float32 sum, as the reference gives it; the count is
// kept in integers and written as float32 at the end, so it is exact.
//
// What bounds it: HBM bytes, the predicate's 12 B a row (i32 ship date,
// f32 discount and quantity) and the price's 4 B on the rows that pass
// (about 2 % of them at Q6's bounds), against a few compares, one
// multiply and two adds. Streaming at the card's rate needs many bytes
// in flight on every SM, so the vector path gives each thread a group of
// kGroup = 4 consecutive rows per grid-stride step: one 16-byte load of
// each predicate column, the three issued together before any compare,
// neighbouring lanes on neighbouring vectors, none kept in L1
// (ld.global.nc.L1::no_allocate: each byte is read once). The group's
// price vector is loaded only by a thread with a passing row, behind a
// warp vote that lets a warp with none skip it; its round trip is hidden
// by the other warps' streams (loading the price of every group, or the
// next step's predicate columns before this step's price, measured
// slower on the H100: probes/stream_variants.py). The product is
// selected or 0 after the compare. The grid is as many CTAs as the
// kernel's occupancy fits on every SM (cuda_error.cuh:grid_ctas). Each
// thread keeps its sums in registers; each CTA reduces by warp shuffles
// and a pass over its warps and writes one partial. The TPU kernel's
// sequential grid carried the (1, 2) sum across steps; blocks here run
// in no order, so the last CTA to finish folds the partials, in one
// launch: each CTA takes a ticket (atomicInc, which wraps back to 0 at
// the last, so the counter is ready for the next call) after its partial
// is visible, and the CTA that draws the last ticket folds them in a
// fixed order (thread t taking CTAs t, t + 256, ... in turn, then the
// same shuffle tree), whichever CTA that is, so two calls on one card
// give the same bits. The counter is the wrapper's, one per stream
// (kernels/filter_agg.py:_ticket), so calls on two streams never share
// it.
//
// The host (kernels/filter_agg.py:q6_layout) takes the vector path when
// all four columns are 16-byte aligned at row 0 and passes the number of
// whole groups; the rows past them, and every row of an unaligned view,
// run the scalar loop of the same kernel. Built with -fmad=false:
// price * disc is rounded before it is added, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace q6 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;      // rows per thread per step, vector path

struct Bounds {
  int date_lo, date_hi;
  float disc_lo, disc_hi, qty_hi;
};

__device__ __forceinline__ bool pass(int s, float d, float q,
                                     const Bounds& b) {
  return s >= b.date_lo && s < b.date_hi && d >= b.disc_lo &&
         d <= b.disc_hi && q < b.qty_hi;
}

__device__ __forceinline__ void add(bool ok, float d, float p, float& rev,
                                    unsigned& cnt) {
  const float v = p * d;
  rev += ok ? v : 0.f;
  cnt += ok;
}

// The CTA's sums in a fixed order: a shuffle tree in each warp, then
// thread 0 over the warps in turn. Valid in thread 0.
template <class C>
__device__ __forceinline__ void block_sum(float& rev, C& cnt) {
  __shared__ float warp_rev[kWarps];
  __shared__ C warp_cnt[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    rev += __shfl_down_sync(0xffffffffu, rev, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_rev[warp] = rev;
    warp_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    rev = 0.f;
    cnt = 0;
    for (int w = 0; w < kWarps; ++w) {
      rev += warp_rev[w];
      cnt += warp_cnt[w];
    }
  }
}

// A streamed 16-byte load that L1 does not keep.
__device__ __forceinline__ int4 load_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// partials: per CTA the float32 revenue and the count's 32 bits; ticket:
// 0 at the launch, and again when the kernel ends.
__global__ void __launch_bounds__(kThreads)
q6_kernel(const int* __restrict__ ship, const float* __restrict__ disc,
          const float* __restrict__ qty, const float* __restrict__ price,
          int64_t n, int64_t groups, Bounds b, float* partials,
          unsigned* ticket, float* __restrict__ out) {
  __shared__ bool last;
  float rev = 0.f;
  unsigned cnt = 0;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int4* ship4 = reinterpret_cast<const int4*>(ship);
  const int4* disc4 = reinterpret_cast<const int4*>(disc);
  const int4* qty4 = reinterpret_cast<const int4*>(qty);
  const int4* price4 = reinterpret_cast<const int4*>(price);
  for (int64_t g = tid; g < groups; g += stride) {
    const int4 s = load_stream(ship4 + g);
    const int4 d = load_stream(disc4 + g);
    const int4 q = load_stream(qty4 + g);
    const float d0 = __int_as_float(d.x), d1 = __int_as_float(d.y),
                d2 = __int_as_float(d.z), d3 = __int_as_float(d.w);
    const bool o0 = pass(s.x, d0, __int_as_float(q.x), b),
               o1 = pass(s.y, d1, __int_as_float(q.y), b),
               o2 = pass(s.z, d2, __int_as_float(q.z), b),
               o3 = pass(s.w, d3, __int_as_float(q.w), b);
    const bool need = o0 || o1 || o2 || o3;
    int4 p = make_int4(0, 0, 0, 0);
    if (__any_sync(__activemask(), need) && need)
      p = load_stream(price4 + g);
    add(o0, d0, __int_as_float(p.x), rev, cnt);
    add(o1, d1, __int_as_float(p.y), rev, cnt);
    add(o2, d2, __int_as_float(p.z), rev, cnt);
    add(o3, d3, __int_as_float(p.w), rev, cnt);
  }
  // the scalar loop: the rows past the whole groups (all rows of an
  // unaligned view)
  for (int64_t row = groups * kGroup + tid; row < n; row += stride) {
    const float d = __ldg(disc + row);
    const bool ok = pass(__ldg(ship + row), d, __ldg(qty + row), b);
    add(ok, d, ok ? __ldg(price + row) : 0.f, rev, cnt);
  }
  block_sum(rev, cnt);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = rev;
    partials[2 * blockIdx.x + 1] = __uint_as_float(cnt);
    __threadfence();   // the partial is visible before the ticket is
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every partial is written; read them past L1
  float r = 0.f;
  unsigned long long c = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    r += __ldcg(partials + 2 * i);
    c += __float_as_uint(__ldcg(partials + 2 * i + 1));
  }
  block_sum(r, c);
  if (threadIdx.x == 0) {
    out[0] = r;
    out[1] = (float)c;
  }
}

}  // namespace q6

// groups: the whole groups of four rows the vector path takes (0 for
// the scalar loop alone), which needs all four columns 16-byte aligned;
// partials: room for max_ctas (revenue, count) pairs; ticket: the
// stream's counter, 0 between calls.
extern "C" int filter_agg_q6_launch(const int* ship, const float* disc,
                                    const float* qty, const float* price,
                                    int64_t n, int64_t groups, int date_lo,
                                    int date_hi, float disc_lo,
                                    float disc_hi, float qty_hi,
                                    float* partials, unsigned* ticket,
                                    float* out, int max_ctas,
                                    void* stream) {
  using namespace q6;
  if (max_ctas < 1 || n < 0 || groups < 0 || groups > n / kGroup)
    return (int)cudaErrorInvalidValue;
  if (groups > 0 && ((uintptr_t)ship % 16 || (uintptr_t)disc % 16 ||
                     (uintptr_t)qty % 16 || (uintptr_t)price % 16))
    return (int)cudaErrorMisalignedAddress;
  // a thread for each group or each scalar row
  const int64_t tail = n - groups * kGroup;
  cudaError_t e = cudaSuccess;
  const int ctas = grid_ctas(q6_kernel, kThreads, 0,
                             groups > tail ? groups : tail, max_ctas, &e);
  if (e != cudaSuccess) return (int)e;
  const Bounds b{date_lo, date_hi, disc_lo, disc_hi, qty_hi};
  q6_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ship, disc, qty, price, n, groups, b, partials, ticket, out);
  return (int)cudaGetLastError();
}
