// TPC-H Q6 with a fixed predicate: the Hopper port of the Pallas kernel
// repro/kernels/filter_agg.py:filter_agg (body _filter_agg_kernel), the
// benchmark half of that file (filter_agg.cu ports its generic half).
// Returns [sum(price * discount), count] over the rows with
//   date_lo <= ship < date_hi, disc_lo <= disc <= disc_hi, qty < qty_hi.
//
// The float bounds arrive as float: the reference compares its float32
// columns with Python floats, which JAX rounds to float32 (0.07f > 0.07,
// so a discount of float32(0.07) passes "<= 0.07" there and must here).
// Sums and the count are float32, as the reference gives them.
//
// What bounds it: HBM bytes, 16 B a row (i32 ship date, f32 discount,
// quantity and price) against a few compares, one multiply and two adds.
// The design streams rows grid-stride (neighbouring threads on
// neighbouring rows, so every load coalesces), keeps the two sums in
// registers, reduces each CTA by warp shuffles and a shared-memory pass
// over the warps, and writes per-CTA partials; a second launch folds them
// in CTA order, so the result is the same every run. The TPU kernel's
// sequential grid carried the (1, 2) sum across steps; blocks here run in
// no order, hence the two passes. Built with -fmad=false: price * disc is
// rounded before it is added, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace q6 {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
q6_kernel(const int* __restrict__ ship, const float* __restrict__ disc,
          const float* __restrict__ qty, const float* __restrict__ price,
          int64_t n, int date_lo, int date_hi, float disc_lo,
          float disc_hi, float qty_hi, float* __restrict__ partials) {
  __shared__ float warp_part[kThreads / 32][2];
  float rev = 0.f, cnt = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const int s = __ldg(ship + row);
    const float d = __ldg(disc + row);
    const float q = __ldg(qty + row);
    if (s >= date_lo && s < date_hi && d >= disc_lo && d <= disc_hi &&
        q < qty_hi) {
      rev += __ldg(price + row) * d;
      cnt += 1.f;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    rev += __shfl_down_sync(0xffffffffu, rev, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_part[warp][0] = rev;
    warp_part[warp][1] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = 0.f, c = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      r += warp_part[w][0];
      c += warp_part[w][1];
    }
    partials[2 * blockIdx.x] = r;
    partials[2 * blockIdx.x + 1] = c;
  }
}

// Fold the per-CTA partials in CTA order.
__global__ void fold_kernel(const float* __restrict__ partials, int ctas,
                            float* __restrict__ out) {
  if (threadIdx.x >= 2) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += partials[2 * c + threadIdx.x];
  out[threadIdx.x] = s;
}

}  // namespace q6

extern "C" int filter_agg_q6_launch(const int* ship, const float* disc,
                                    const float* qty, const float* price,
                                    int64_t n, int date_lo, int date_hi,
                                    float disc_lo, float disc_hi,
                                    float qty_hi, float* partials,
                                    float* out, int ctas, void* stream) {
  using namespace q6;
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  q6_kernel<<<ctas, kThreads, 0, s>>>(ship, disc, qty, price, n, date_lo,
                                      date_hi, disc_lo, disc_hi, qty_hi,
                                      partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_kernel<<<1, 32, 0, s>>>(partials, ctas, out);
  return (int)cudaGetLastError();
}
