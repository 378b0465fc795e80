// Top-k selection for ORDER BY ... LIMIT: the Hopper port of the Pallas
// kernel repro/kernels/topk.py:fused_topk (body _topk_kernel), the arm of
// the dispatch layer for a final stage with sort keys and a limit (TPC-H
// Q3's).
//
// The predicate is folded into the mask before the launch. Then the rows
// are ordered by [invalid] + the sort keys, each ascending or descending,
// + the position, so invalid rows sort last and ties keep row order, as
// np.lexsort does, and every column is written in that order, by
// position, whatever its width (1, 2, 4 or 8 bytes), with the mask
// valid & (lane < limit). Two paths, one order:
//   * up to kBlockMaxRows rows (roofline.topk_block_rows; Q3's final,
//     capacity 2^14): topk_block_kernel, one launch of one thread-block
//     cluster (up to 16 CTAs) that sorts the batch in shared memory
//     (block_sort.cuh) and gathers every column (the first kMaxGather of
//     them; more take a gather launch each kMaxGather);
//   * above: sortnet::sort (a stable LSD radix sort of the key lanes in
//     global memory that carries the positions; sortnet.cuh), then one
//     gather launch.
// The reference narrows every column to 32 bits on the TPU (Mosaic has no
// 64-bit lanes); Hopper has them, so every column keeps its dtype.
// What bounds it: the cluster's passes at the small path (block_sort.cuh);
// HBM bytes of the radix passes above it (sortnet.cuh), where a float64
// key may keep all eight of its digits live.

#include "block_sort.cuh"
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

// Column ``c`` of ``g`` in sorted order at this thread's rows of the
// CTA's slice (from ``lo``), the loads issued together.
template <class T>
__device__ __forceinline__ void gather_rows(const Gather& g, int c,
                                            const int (&p)[kBlockSteps],
                                            int lo, int rows) {
  const T* __restrict__ src = static_cast<const T*>(g.src[c]);
  T* __restrict__ dst = static_cast<T*>(g.dst[c]);
  T x[kBlockSteps];
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s)
    if (s * kBlockThreads + (int)threadIdx.x < rows) x[s] = src[p[s]];
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s) {
    const int j = s * kBlockThreads + threadIdx.x;
    if (j < rows) dst[lo + j] = x[s];
  }
}

// Prefetch rows [lo, lo + rows) of a column of ``bytes``-byte elements
// into L2, a 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes, int lo,
                                            int rows) {
  const char* c = static_cast<const char*>(p) + (int64_t)lo * bytes;
  for (int64_t at = (int64_t)threadIdx.x * 128; at < (int64_t)rows * bytes;
       at += (int64_t)kBlockThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + at));
}

// Bytes of a column of program.DTYPE_CODES type ``t``.
__device__ __forceinline__ int type_bytes(int t) {
  return t == 0 || t == 2 ? 8 : t == 1 || t == 3 ? 4 : t == 4 ? 2 : 1;
}

// The small path in one launch of one cluster: block_sort, then each CTA
// writes its slice of every column of ``g`` and of the mask in sorted
// order; ``pos`` (if not null) gets the positions, for the gather
// launches of the columns past ``g``.
__global__ void __launch_bounds__(kBlockThreads, 1)
    topk_block_kernel(const unsigned char* __restrict__ mask, KeySrc src,
                      int n, Gather g, int* __restrict__ pos, int64_t limit,
                      unsigned char* __restrict__ out_mask) {
  extern __shared__ u64 smem[];
  __shared__ int doff[kBins];
  __shared__ int warp_s[32];
  __shared__ u64 red[2 * kBlockWarps];
  cg::cluster_group cl = cg::this_cluster();
  const int rows = n / (int)cl.num_blocks();
  const int lo = (int)cl.block_rank() * rows;
  u64* ev = smem;
  unsigned* perm = reinterpret_cast<unsigned*>(ev + n);
  int* wc = reinterpret_cast<int*>(perm + rows);
  int* pub = wc + kBlockWarps * kBins;
  // every CTA reads the mask and each key lane whole, and the gather
  // reads every column at random: each CTA brings its slice into L2 first
  prefetch_l2(mask, 1, lo, rows);
  for (int q = 0; q < src.n; ++q)
    prefetch_l2(src.p[q], type_bytes(src.type[q]), lo, rows);
  for (int c = 0; c < g.n; ++c) prefetch_l2(g.src[c], g.elem[c], lo, rows);
  block_sort(cl, mask, src, n, ev, perm, wc, pub, doff, warp_s, red);
  int p[kBlockSteps];
#pragma unroll
  for (int s = 0; s < kBlockSteps; ++s) {
    const int j = s * kBlockThreads + threadIdx.x;
    p[s] = 0;
    if (j < rows) {
      const unsigned e = perm[j];
      p[s] = (int)(e & kRowMask);
      if (pos) pos[lo + j] = p[s];
      out_mask[lo + j] = ((e >> kInvBit) == 0u && lo + j < limit) ? 1 : 0;
    }
  }
  for (int c = 0; c < g.n; ++c) {
    switch (g.elem[c]) {
      case 8: gather_rows<unsigned long long>(g, c, p, lo, rows); break;
      case 4: gather_rows<unsigned int>(g, c, p, lo, rows); break;
      case 2: gather_rows<unsigned short>(g, c, p, lo, rows); break;
      default: gather_rows<unsigned char>(g, c, p, lo, rows); break;
    }
  }
}

// The columns of src / dst / elem from ``c0`` on, at most kMaxGather.
inline Gather gather_from(const int64_t* src_ptrs, const int64_t* dst_ptrs,
                          const int* elem, int n_cols, int c0) {
  Gather g{};
  g.n = n_cols - c0 < kMaxGather ? n_cols - c0 : kMaxGather;
  for (int c = 0; c < g.n; ++c) {
    g.src[c] = reinterpret_cast<const void*>(src_ptrs[c0 + c]);
    g.dst[c] = reinterpret_cast<void*>(dst_ptrs[c0 + c]);
    g.elem[c] = elem[c0 + c];
  }
  return g;
}

inline bool bad_columns(const int* elem, int n_cols) {
  for (int c = 0; c < n_cols; ++c)
    if (elem[c] != 1 && elem[c] != 2 && elem[c] != 4 && elem[c] != 8)
      return true;
  return n_cols < 0;
}

inline KeySrc key_src(const int64_t* key_ptrs, const int* key_types,
                      const int* key_desc, int n_keys) {
  KeySrc src{};
  for (int q = 0; q < n_keys; ++q) {
    src.p[q] = reinterpret_cast<const void*>(key_ptrs[q]);
    src.type[q] = key_types[q];
    src.desc[q] = key_desc[q];
  }
  src.n = n_keys;
  return src;
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
  if (n_keys < 0 || n_keys + 1 > kMaxLanes || bad_columns(elem, n_cols) ||
      limit < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KeySrc src = key_src(key_ptrs, key_types, key_desc, n_keys);
  Lanes lanes{};
  for (int q = 0; q <= n_keys; ++q)
    lanes.k[q] = reinterpret_cast<u64*>(lane_ptrs[q]);
  lanes.n = n_keys + 1;
  const int rc =
      sort(mask, src, lanes, pos, n, tile, scratch, scratch_bytes, s);
  if (rc != 0) return rc;
  for (int c0 = 0; c0 == 0 || c0 < n_cols; c0 += kMaxGather) {
    const Gather g = gather_from(src_ptrs, dst_ptrs, elem, n_cols, c0);
    gather_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0, s>>>(
        pos, g, lanes.k[0], c0 == 0 ? out_mask : nullptr, n, limit);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The small path: n rows, a power of two up to kBlockMaxRows; the
// arguments as topk_launch's, without its lanes and radix scratch; pos:
// n int32 scratch, used only with more than kMaxGather columns.
extern "C" int topk_block_launch(const unsigned char* mask, int64_t n,
                                 const int64_t* key_ptrs, const int* key_types,
                                 const int* key_desc, int n_keys,
                                 const int64_t* src_ptrs,
                                 const int64_t* dst_ptrs, const int* elem,
                                 int n_cols, int* pos, int64_t limit,
                                 unsigned char* out_mask, void* stream) {
  using namespace sortnet;
  if (n < 1 || (n & (n - 1)) || n > kBlockMaxRows || n_keys < 1 ||
      n_keys + 1 > kMaxLanes || bad_columns(elem, n_cols) || limit < 0 ||
      (n_cols > kMaxGather && !pos))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = block_sort_ctas(n);
  // clusters above 8 CTAs are "non-portable": Hopper takes up to 16
  cudaError_t e = cudaFuncSetAttribute(
      topk_block_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(topk_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)block_sort_smem(n, n / ctas));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = block_sort_smem(n, n / ctas);
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, topk_block_kernel, mask,
      key_src(key_ptrs, key_types, key_desc, n_keys), (int)n,
      gather_from(src_ptrs, dst_ptrs, elem, n_cols, 0),
      n_cols > kMaxGather ? pos : nullptr, limit, out_mask);
  if (e != cudaSuccess) return (int)e;
  for (int c0 = kMaxGather; c0 < n_cols; c0 += kMaxGather) {
    gather_kernel<<<grid_for(n, kStepThreads), kStepThreads, 0, s>>>(
        pos, gather_from(src_ptrs, dst_ptrs, elem, n_cols, c0), nullptr,
        nullptr, n, limit);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
