// Grouped sums by a group id: the Hopper port of the Pallas kernel
// repro/kernels/groupby_onehot.py:groupby_onehot (body _groupby_kernel),
// the fixed-layout benchmark half of that file (groupby.cu ports its
// generic half). gid (n,) int32, values (n, A) float32 row-major;
// out (K, A) float32 with out[g, a] = sum of values[i, a] over gid[i] == g.
// A gid outside [0, K) reaches no group, as its one-hot row is all zero
// in the reference.
//
// The TPU kernel turned grouping into a (block, K) one-hot matmul on the
// MXU. Here a CTA folds its rows into a (K, A) float32 partial that a
// second launch folds in CTA order; two paths, chosen by the wrapper
// (groupby_onehot.onehot_layout):
//   * K·A <= kRegTile (TPC-H Q1: 6 × 5): each thread keeps a (K, A) tile
//     in registers (templated on A and on K's bound, kRegTile / 2 / A or
//     kRegTile / A rows) and folds each row into it by a predicated add
//     over the unrolled groups (no shared atomics: with few groups a
//     warp's 32 rows fall on K addresses, and atomics to them
//     serialise); the tiles meet by warp shuffles, then across the warps
//     in warp order;
//   * above: each warp owns a (K, A) tile in shared memory. A warp takes
//     32 rows at a time, kCols columns at once; __match_any_sync finds
//     the lanes of each group, their leader sums its peers' values by
//     shuffles in lane order (a peer a round, every column in the round)
//     and adds them to the tile, one plain read-add-write per group and
//     column (no other lane writes that address in the step). The warps'
//     tiles are summed in warp order.
// The CTAs' partials are folded by a warp per output, in a fixed tree.
// Every sum is taken in a fixed order, so a call repeats bit for bit.
// What bounds it: HBM bytes, 4 + 4A a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace onehot {

constexpr int kRegTile = 64;     // groupby_onehot.REGISTER_TILE
constexpr int kRegThreads = 256;
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kMaxWarps = 8;     // groupby_onehot.MAX_WARPS
constexpr int kFoldThreads = 256;
constexpr int kCols = 8;         // a row's columns in flight, per-warp path
constexpr int kRegRows = 2;      // rows in flight a thread, register path

// The warp's tile summed into lane 0's: every (g < K, a) by a butterfly
// of shuffles, the same tree in every call.
template <int KM, int A>
__device__ __forceinline__ void warp_sum(float (&acc)[KM][A], int K) {
#pragma unroll
  for (int g = 0; g < KM; ++g) {
    if (g >= K) break;
#pragma unroll
    for (int a = 0; a < A; ++a)
      for (int off = 16; off > 0; off >>= 1)
        acc[g][a] += __shfl_xor_sync(0xffffffffu, acc[g][a], off);
  }
}

// Register path: a (KM, A) tile a thread, of which the first K <= KM
// rows are used. Rows grid-stride, kRegRows in flight a thread.
template <int A, int KM>
__global__ void __launch_bounds__(kRegThreads)
    onehot_regs_kernel(const int* __restrict__ gid,
                       const float* __restrict__ vals, int64_t n, int K,
                       float* __restrict__ partials) {
  __shared__ float part[kRegWarps][KM * A];
  float acc[KM][A];
#pragma unroll
  for (int g = 0; g < KM; ++g)
#pragma unroll
    for (int a = 0; a < A; ++a) acc[g][a] = 0.f;
  // a row into its group's row of the tile: predicated adds, the groups
  // past K skipped by a branch every thread takes alike
  auto fold = [&](int g, const float (&x)[A]) {
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k >= K) break;
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (g == k) acc[k][a] += x[a];
    }
  };
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (; row + (kRegRows - 1) * stride < n; row += kRegRows * stride) {
    int g[kRegRows];
    float x[kRegRows][A];
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {  // every load first
      g[r] = __ldg(gid + row + r * stride);
#pragma unroll
      for (int a = 0; a < A; ++a)
        x[r][a] = __ldg(vals + (row + r * stride) * A + a);
    }
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) fold(g[r], x[r]);
  }
  for (; row < n; row += stride) {
    float x[A];
#pragma unroll
    for (int a = 0; a < A; ++a) x[a] = __ldg(vals + row * A + a);
    fold(__ldg(gid + row), x);
  }
  warp_sum(acc, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < KM; ++g) {
      if (g >= K) break;
#pragma unroll
      for (int a = 0; a < A; ++a) part[warp][g * A + a] = acc[g][a];
    }
  }
  __syncthreads();
  const int width = K * A;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kRegWarps; ++w) s += part[w][j];
    partials[(int64_t)blockIdx.x * width + j] = s;
  }
}

// Per-warp path: ``tiles`` holds one (K, A) tile per warp of the CTA.
__global__ void __launch_bounds__(kMaxWarps * 32)
    onehot_warps_kernel(const int* __restrict__ gid,
                        const float* __restrict__ vals, int64_t n, int A,
                        int K, float* __restrict__ partials) {
  extern __shared__ float tiles[];
  const int width = K * A, warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < warps * width; i += blockDim.x)
    tiles[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* t = tiles + warp * width;
  const int64_t step = (int64_t)gridDim.x * warps * 32;
  int64_t row = ((int64_t)blockIdx.x * warps + warp) * 32 + lane;
  int next = row < n ? __ldg(gid + row) : -1;
  for (; row - lane < n; row += step) {
    int g = next;
    next = row + step < n ? __ldg(gid + row + step) : -1;
    if ((unsigned)g >= (unsigned)K) g = -1;  // no group (or past n)
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const bool lead = g >= 0 && lane == __ffs(peers) - 1;
    // the most lanes of one group: the shuffle rounds every lane takes
    const int rounds = (int)__reduce_max_sync(
        0xffffffffu, g >= 0 ? (unsigned)__popc(peers) : 1u) - 1;
    for (int a0 = 0; a0 < A; a0 += kCols) {
      float x[kCols], s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        x[j] = g >= 0 && a0 + j < A ? __ldg(vals + row * A + a0 + j) : 0.f;
        s[j] = x[j];
      }
      // the leader adds its peers' values in lane order, a peer a round
      unsigned rest = lead ? peers & (peers - 1u) : 0u;
      for (int r = 0; r < rounds; ++r) {
        const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (a0 + j >= A) break;
          const float y = __shfl_sync(0xffffffffu, x[j], src);
          if (rest) s[j] += y;
        }
        rest &= rest - 1u;
      }
      if (lead) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (a0 + j < A) t[g * A + a0 + j] += s[j];
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += tiles[w * width + j];
    partials[(int64_t)blockIdx.x * width + j] = s;
  }
}

// out[i] = sum of the CTAs' partials[c, i]: warp i's lanes each sum
// every 32nd CTA in CTA order, then a butterfly; the same tree each call.
__global__ void fold_kernel(const float* __restrict__ partials, int ctas,
                            int width, float* __restrict__ out) {
  const int i = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= width) return;  // the whole warp
  float s = 0.f;
  for (int c = lane; c < ctas; c += 32) s += partials[(int64_t)c * width + i];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[i] = s;
}

typedef void (*RegsKernel)(const int*, const float*, int64_t, int, float*);

// The register kernel of A columns: K's bound kRegTile / 2 / A where
// K·A fits half the tile (``half``), else kRegTile / A.
template <int A>
RegsKernel regs_kernel(int a, bool half) {
  if constexpr (A > kRegTile) {
    return nullptr;
  } else if constexpr (A <= kRegTile / 2) {
    if (a != A) return regs_kernel<A + 1>(a, half);
    return half ? onehot_regs_kernel<A, kRegTile / 2 / A>
                : onehot_regs_kernel<A, kRegTile / A>;
  } else {
    return a == A ? onehot_regs_kernel<A, kRegTile / A>
                  : regs_kernel<A + 1>(a, half);
  }
}

}  // namespace onehot

// partials: max_ctas (K, A) float32 tiles; warps: the per-warp path's
// warps a CTA (its shared tiles, onehot_layout), ignored by the register
// path (``regs``: K·A <= kRegTile).
extern "C" int groupby_onehot_launch(const int* gid, const float* vals,
                                     int64_t n, int A, int K,
                                     float* partials, float* out,
                                     int max_ctas, int warps, int regs,
                                     void* stream) {
  using namespace onehot;
  if (max_ctas < 1 || A < 1 || K < 1 || n < 0 ||
      (regs && K * A > kRegTile) ||
      (!regs && (warps < 1 || warps > kMaxWarps)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = K * A;
  cudaError_t e = cudaSuccess;
  int ctas;
  if (regs) {
    const RegsKernel k = regs_kernel<1>(A, width <= kRegTile / 2);
    ctas = grid_ctas(k, kRegThreads, 0, n, max_ctas, &e);
    if (e != cudaSuccess) return (int)e;
    k<<<ctas, kRegThreads, 0, s>>>(gid, vals, n, K, partials);
  } else {
    const size_t smem = (size_t)warps * width * sizeof(float);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(onehot_warps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    ctas = grid_ctas(onehot_warps_kernel, warps * 32, smem, n, max_ctas, &e);
    if (e != cudaSuccess) return (int)e;
    onehot_warps_kernel<<<ctas, warps * 32, smem, s>>>(gid, vals, n, A, K,
                                                      partials);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_kernel<<<(width * 32 + kFoldThreads - 1) / kFoldThreads,
                kFoldThreads, 0, s>>>(partials, ctas, width, out);
  return (int)cudaGetLastError();
}
