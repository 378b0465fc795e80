// Semi-join Bloom probe: the Hopper port of the Pallas kernel
// repro/kernels/bloom.py:fused_bloom_filter (body _bloom_filter_kernel),
// the bloom_filter arm of the dispatch layer. The scan's predicate has
// already been applied to ``mask`` (by the generic torch operators, as
// the reference's dispatch does); this kernel tests the k double-hashed
// positions of each surviving row's key against the OR-merged filter:
//   ku = key mod 2^32 (numpy's astype(uint32)),
//   h1 = fmix32(ku ^ SEED1), h2 = fmix32(ku ^ SEED2) | 1,
//   pos_i = (h1 + i * h2) & (bits - 1), i < k,
//   out = mask && every bit pos_i of ``words`` is set.
// The hash family, seeds and word layout are kernels/bloom.py's, so a
// filter built by either package on the host is found here.
//
// What bounds it: HBM bytes. The mask and the one-byte verdict over the
// capacity, the key over the valid rows (8 B for int64), the words once.
// The TPU kernel kept the words in VMEM. Filters reach 2^22 bits
// (512 KiB, BLOOM_MAX_BITS), past a block's 227 KB of shared memory, so
// the words stay in global memory, where the L2 holds them; k and bits
// are arguments, so no filter size is baked in. Each valid row's first
// word read is a random 4-byte read of the filter: at 2^21 bits the
// filter outgrows L1 and those reads are served by L2 at about as many
// reads a second as the stream has rows, so the kernel overlaps them
// with the stream instead of waiting on them one row at a time.
//
// The vector path: each warp takes a chunk of kChunk = 256 consecutive
// rows a grid-stride step, eight rows a thread, and every load
// instruction of the warp reads contiguous bytes: lane l holds the rows
// of the 16-byte key vectors j * 32 + l (two int64 or four int32 keys
// each), their mask bytes as one 2- or 4-byte load each, and writes
// their verdicts the same way. The mask of the warp's next chunk is
// loaded before this chunk's work, so a step waits on one HBM round trip
// (the keys), not two. A thread whose rows are all masked (the padding
// past the valid rows, one run at the end of a batch) skips its key
// loads. The keys stream past L1 (ld.global.cs), which keeps the words.
// The probes go in two waves: the first word of every live row at once;
// then, for each row whose first bit is set, its other k - 1 words,
// issued together in batches of kBatch = 8 (one batch for k <= 9, so
// for BLOOM_K = 6). The verdict is the AND of the k bits, so the order
// of the reads changes none of it, and the L2 traffic stays that of an
// early exit.
//
// The host (kernels/bloom.py:vector_layout) takes the vector path when
// the key is 16-byte aligned and the mask and verdicts aligned to their
// 2- or 4-byte loads at row 0 (every tensor a batch allocates) and
// passes the number of whole chunks; the rows past them, and every row
// of an unaligned view, run the scalar loop of the same kernel, one row
// per thread. The grid is as many CTAs as the kernel's occupancy fits on
// every SM (cuda_error.cuh:grid_ctas); it is compiled for at least
// kMinCtas = 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cuda_error.cuh"

namespace bloom {

constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x41C64E6Du;
constexpr int kThreads = 256;
constexpr int kRows = 8;                // rows a thread takes a step
constexpr int kChunk = 32 * kRows;      // rows a warp takes a step
constexpr int kBatch = 8;               // second-wave reads issued at once
// CTAs an SM the kernel is compiled for: with this hint ptxas keeps a
// step's eight key loads in flight before the first word read (56
// registers for int64 keys); with the thread count alone it chose 40
// and issued half the keys after the first word reads, about 4 % slower
// on the semi-join's probe (probes/stream_variants.py)
constexpr int kMinCtas = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* words,
                                            uint32_t pos) {
  return __ldg(words + (pos >> 5));
}

__device__ __forceinline__ bool bit_of(uint32_t word, uint32_t pos) {
  return (word >> (pos & 31u)) & 1u;
}

// A streamed 16-byte load, evicted first (the words keep L1).
__device__ __forceinline__ int4 load_stream(const int4* p) {
  int4 v;
  asm("ld.global.cs.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <class Key>
__global__ void __launch_bounds__(kThreads, kMinCtas)
bloom_kernel(const Key* __restrict__ keys,
             const unsigned char* __restrict__ mask, int64_t n,
             int64_t chunks, const uint32_t* __restrict__ words, uint32_t m,
             int k, unsigned char* __restrict__ out) {
  // R rows a 16-byte key vector, V vectors a thread; the mask and the
  // verdicts of a vector's rows move as one R-byte unit
  constexpr int R = 16 / sizeof(Key), V = kRows / R;
  using Unit = std::conditional_t<R == 2, unsigned short, unsigned>;
  const Unit* mask_u = reinterpret_cast<const Unit*>(mask);
  const int4* key_v = reinterpret_cast<const int4*>(keys);
  Unit* out_u = reinterpret_cast<Unit*>(out);
  const int lane = threadIdx.x % 32;
  const int64_t warp =
      (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int64_t warps = (int64_t)gridDim.x * blockDim.x / 32;

  Unit next[V];
  if (warp < chunks) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      next[j] = __ldg(mask_u + warp * 32 * V + j * 32 + lane);
  }
  for (int64_t c = warp; c < chunks; c += warps) {
    const int64_t base = c * 32 * V + lane;   // this lane's unit, j = 0
    Unit mb[V];
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mb[j] = next[j];
      any |= mb[j];
    }
    if (c + warps < chunks) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        next[j] = __ldg(mask_u + base + warps * 32 * V + j * 32);
    }
    Unit verdict[V];
#pragma unroll
    for (int j = 0; j < V; ++j) verdict[j] = 0;
    if (any) {
      int4 v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = load_stream(key_v + base + j * 32);
      uint32_t h1[kRows], w[kRows], ku[kRows];
      bool live[kRows];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (R == 2) {   // little endian: an int64's low word first
          ku[2 * j] = (uint32_t)v[j].x;
          ku[2 * j + 1] = (uint32_t)v[j].z;
        } else {
          ku[4 * j] = (uint32_t)v[j].x;
          ku[4 * j + 1] = (uint32_t)v[j].y;
          ku[4 * j + 2] = (uint32_t)v[j].z;
          ku[4 * j + 3] = (uint32_t)v[j].w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
          live[j * R + i] = (mb[j] >> (8 * i)) & 0xFFu;
      }
      // wave 1: the first word of every live row
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        h1[r] = fmix32(ku[r] ^ kSeed1);
        w[r] = live[r] ? word_at(words, h1[r] & m) : 0u;
      }
      bool more = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        live[r] = live[r] && bit_of(w[r], h1[r] & m);
        more |= live[r];
      }
      // wave 2: the other k - 1 words of each row still live
      if (more) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!live[r]) continue;
          const uint32_t h2 = fmix32(ku[r] ^ kSeed2) | 1u;
          for (int i0 = 1; i0 < k && live[r]; i0 += kBatch) {
            uint32_t w2[kBatch];
#pragma unroll
            for (int t = 0; t < kBatch; ++t)
              w2[t] = i0 + t < k
                  ? word_at(words, (h1[r] + (uint32_t)(i0 + t) * h2) & m)
                  : ~0u;
#pragma unroll
            for (int t = 0; t < kBatch; ++t)
              live[r] = live[r] &&
                  bit_of(w2[t], (h1[r] + (uint32_t)(i0 + t) * h2) & m);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        uint32_t u = 0;
#pragma unroll
        for (int i = 0; i < R; ++i) u |= (uint32_t)live[j * R + i] << (8 * i);
        verdict[j] = (Unit)u;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) out_u[base + j * 32] = verdict[j];
  }
  // the scalar loop: the rows past the whole chunks (all rows of an
  // unaligned view), one per thread
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = chunks * kChunk + tid; row < n; row += stride) {
    bool hit = false;
    if (mask[row]) {
      const uint32_t ku = (uint32_t)__ldg(keys + row);
      const uint32_t h1 = fmix32(ku ^ kSeed1);
      const uint32_t h2 = fmix32(ku ^ kSeed2) | 1u;
      hit = true;
      for (int i = 0; i < k && hit; ++i) {
        const uint32_t pos = (h1 + (uint32_t)i * h2) & m;
        hit = bit_of(word_at(words, pos), pos);
      }
    }
    out[row] = hit;
  }
}

template <class Key>
cudaError_t launch(const void* keys, const unsigned char* mask, int64_t n,
                   int64_t chunks, const uint32_t* words, uint32_t m, int k,
                   unsigned char* out, cudaStream_t stream) {
  // a thread for each lane of a chunk's warp, or for each scalar row
  const int64_t tail = n - chunks * kChunk;
  cudaError_t e = cudaSuccess;
  const int ctas = grid_ctas(bloom_kernel<Key>, kThreads, 0,
                             chunks * 32 > tail ? chunks * 32 : tail,
                             INT32_MAX, &e);
  if (e != cudaSuccess) return e;
  bloom_kernel<Key><<<ctas, kThreads, 0, stream>>>(
      static_cast<const Key*>(keys), mask, n, chunks, words, m, k, out);
  return cudaGetLastError();
}

}  // namespace bloom

// key_type is program.DTYPE_CODES' (2 int64, 3 int32); bits is a power
// of two with bits / 32 words; chunks: the whole chunks of 256 rows the
// vector path takes (0 for the scalar loop alone), which needs the key
// 16-byte aligned and the mask and the verdicts 2-byte (int64 keys) or
// 4-byte (int32 keys) aligned.
extern "C" int bloom_launch(const void* keys, int key_type,
                            const unsigned char* mask, int64_t n,
                            int64_t chunks, const uint32_t* words,
                            int64_t bits, int k, unsigned char* out,
                            void* stream) {
  using namespace bloom;
  if ((key_type != 2 && key_type != 3) || bits < 32 || bits > (1LL << 32) ||
      (bits & (bits - 1)) || k < 1 || n < 0 || chunks < 0 ||
      chunks > n / kChunk)
    return (int)cudaErrorInvalidValue;
  const uintptr_t unit = key_type == 2 ? 2 : 4;
  if (chunks > 0 && ((uintptr_t)keys % 16 || (uintptr_t)mask % unit ||
                     (uintptr_t)out % unit))
    return (int)cudaErrorMisalignedAddress;
  const uint32_t m = (uint32_t)(bits - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      key_type == 2
          ? launch<long long>(keys, mask, n, chunks, words, m, k, out, s)
          : launch<int>(keys, mask, n, chunks, words, m, k, out, s);
  return (int)e;
}
