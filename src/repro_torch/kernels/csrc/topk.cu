// Top-k selection for ORDER BY ... LIMIT: the Hopper port of the Pallas
// kernel repro/kernels/topk.py:fused_topk (body _topk_kernel), the arm of
// the dispatch layer for a final stage with sort keys and a limit (TPC-H
// Q3's).
//
// The predicate is folded into the mask before the launch. Then:
//   1. sortnet::sort orders the rows by [invalid] + the sort keys, each
//      ascending or descending, + the position (a stable LSD radix sort
//      of the key lanes that carries the positions; sortnet.cuh), so
//      invalid rows sort last and ties keep row order, as np.lexsort does;
//   2. one gather writes every column in sorted order, by position,
//      whatever its width (1, 2, 4 or 8 bytes), and the mask
//      valid & (lane < limit).
// The reference narrows every column to 32 bits on the TPU (Mosaic has no
// 64-bit lanes); Hopper has them, so every column keeps its dtype.
// What bounds it: HBM bytes of the radix passes (sortnet.cuh); a float64
// key may keep all eight of its digits live.

#include "sortnet.cuh"

namespace sortnet {

constexpr int kMaxGather = 32;  // columns per gather launch

struct Gather {
  const void* src[kMaxGather];
  void* dst[kMaxGather];
  int elem[kMaxGather];
  int n;
};

template <class T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int64_t to, int from) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

// Columns in sorted order; with ``out_mask``, also the top-k mask.
__global__ void gather_kernel(const int* __restrict__ pos, Gather g,
                              const u64* __restrict__ inv,
                              unsigned char* __restrict__ out_mask,
                              int64_t n, int64_t limit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int p = pos[i];
    for (int c = 0; c < g.n; ++c) {
      switch (g.elem[c]) {
        case 8:
          copy_elem<unsigned long long>(g.src[c], g.dst[c], i, p);
          break;
        case 4: copy_elem<unsigned int>(g.src[c], g.dst[c], i, p); break;
        case 2: copy_elem<unsigned short>(g.src[c], g.dst[c], i, p); break;
        default: copy_elem<unsigned char>(g.src[c], g.dst[c], i, p); break;
      }
    }
    if (out_mask) out_mask[i] = (inv[i] == 0ULL && i < limit) ? 1 : 0;
  }
}

}  // namespace sortnet

// mask: the row mask with the predicate folded in (bool, n). keys:
// n_keys sort-key columns, types program.DTYPE_CODES, desc 0/1 each.
// lanes: 1 + n_keys u64 scratch columns, pos: n int32 scratch, tile: rows
// a radix block (roofline.sort_tiling), scratch: the radix sort's
// scratch_bytes (sortnet::radix_layout). src / dst / elem: n_cols
// columns and their sorted outputs, element sizes 1, 2, 4 or 8 bytes.
extern "C" int topk_launch(const unsigned char* mask, int64_t n,
                           const int64_t* key_ptrs, const int* key_types,
                           const int* key_desc, int n_keys,
                           const int64_t* lane_ptrs, int* pos, int tile,
                           void* scratch, int64_t scratch_bytes,
                           const int64_t* src_ptrs, const int64_t* dst_ptrs,
                           const int* elem, int n_cols, int64_t limit,
                           unsigned char* out_mask, void* stream) {
  using namespace sortnet;
  if (n_keys < 0 || n_keys + 1 > kMaxLanes || n_cols < 0 || limit < 0)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_cols; ++c)
    if (elem[c] != 1 && elem[c] != 2 && elem[c] != 4 && elem[c] != 8)
      return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeySrc src{};
  Lanes lanes{};
  for (int q = 0; q < n_keys; ++q) {
    src.p[q] = reinterpret_cast<const void*>(key_ptrs[q]);
    src.type[q] = key_types[q];
    src.desc[q] = key_desc[q];
  }
  src.n = n_keys;
  for (int q = 0; q <= n_keys; ++q)
    lanes.k[q] = reinterpret_cast<u64*>(lane_ptrs[q]);
  lanes.n = n_keys + 1;
  const int rc =
      sort(mask, src, lanes, pos, n, tile, scratch, scratch_bytes, s);
  if (rc != 0) return rc;
  for (int c0 = 0; c0 == 0 || c0 < n_cols; c0 += kMaxGather) {
    Gather g{};
    g.n = n_cols - c0 < kMaxGather ? n_cols - c0 : kMaxGather;
    for (int c = 0; c < g.n; ++c) {
      g.src[c] = reinterpret_cast<const void*>(src_ptrs[c0 + c]);
      g.dst[c] = reinterpret_cast<void*>(dst_ptrs[c0 + c]);
      g.elem[c] = elem[c0 + c];
    }
    gather_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0, s>>>(
        pos, g, lanes.k[0], c0 == 0 ? out_mask : nullptr, n, limit);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
