// Grouped sums by a group id: the Hopper port of the Pallas kernel
// repro/kernels/groupby_onehot.py:groupby_onehot (body _groupby_kernel),
// the fixed-layout benchmark half of that file (groupby.cu ports its
// generic half). gid (n,) int32, values (n, A) float32 row-major;
// out (K, A) float32 with out[g, a] = sum of values[i, a] over gid[i] == g.
// A gid outside [0, K) reaches no group, as its one-hot row is all zero
// in the reference.
//
// The TPU kernel turned grouping into a (block, K) one-hot matmul on the
// MXU. Here each CTA keeps a (K, A) float32 tile in shared memory and adds
// every row's A values into its group's row with shared-memory atomics;
// the tiles go to per-CTA partials that a second launch folds in CTA
// order. What bounds it: HBM bytes, 4 + 4A bytes a row, as long as the
// shared atomics keep up; with a few groups (TPC-H Q1: K = 6) every warp's
// rows land on the same few addresses and the atomics serialize, the slow
// point of this first version. The wrapper raises where the tile exceeds
// one block's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace onehot {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
groupby_onehot_kernel(const int* __restrict__ gid,
                      const float* __restrict__ vals, int64_t n, int A,
                      int K, float* __restrict__ partials) {
  extern __shared__ float tile[];  // (K, A)
  const int width = K * A;
  for (int i = threadIdx.x; i < width; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const int g = __ldg(gid + row);
    if ((unsigned)g >= (unsigned)K) continue;
    const float* v = vals + row * A;
    float* t = tile + g * A;
    for (int a = 0; a < A; ++a) atomicAdd(t + a, __ldg(v + a));
  }
  __syncthreads();
  float* part = partials + (int64_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) part[i] = tile[i];
}

// out[i] = sum of the CTAs' partials[c, i], in CTA order.
__global__ void fold_kernel(const float* __restrict__ partials, int ctas,
                            int width, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += partials[(int64_t)c * width + i];
  out[i] = s;
}

}  // namespace onehot

extern "C" int groupby_onehot_launch(const int* gid, const float* vals,
                                     int64_t n, int A, int K,
                                     float* partials, float* out, int ctas,
                                     void* stream) {
  using namespace onehot;
  if (ctas < 1 || A < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = K * A;
  const size_t smem = (size_t)width * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        groupby_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  groupby_onehot_kernel<<<ctas, kThreads, smem, s>>>(gid, vals, n, A, K,
                                                     partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partials, ctas, width, out);
  return (int)cudaGetLastError();
}
