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
// The TPU kernel kept the words in VMEM. Filters reach 2^22 bits
// (512 KiB, BLOOM_MAX_BITS), past a block's 227 KB of shared memory, so
// the words stay in global memory, where the L2 holds them. One thread
// per row, grid-stride; k and bits are arguments, so no filter size is
// baked into the build. What bounds it: HBM bytes (the key, the mask and
// the one-byte verdict, 10 B a row for int64 keys); the word reads hit
// L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace bloom {

constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x41C64E6Du;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void bloom_kernel(const void* keys, int key_type,
                             const unsigned char* __restrict__ mask,
                             int64_t n, const uint32_t* __restrict__ words,
                             uint32_t m, int k,
                             unsigned char* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       row < n; row += stride) {
    unsigned char hit = 0;
    if (mask[row]) {
      const uint32_t ku =
          key_type == 2
              ? (uint32_t)__ldg(static_cast<const long long*>(keys) + row)
              : (uint32_t)__ldg(static_cast<const int*>(keys) + row);
      const uint32_t h1 = fmix32(ku ^ kSeed1);
      const uint32_t h2 = fmix32(ku ^ kSeed2) | 1u;
      hit = 1;
      for (int i = 0; i < k; ++i) {
        const uint32_t pos = (h1 + (uint32_t)i * h2) & m;
        if (!((__ldg(words + (pos >> 5)) >> (pos & 31u)) & 1u)) {
          hit = 0;
          break;
        }
      }
    }
    out[row] = hit;
  }
}

}  // namespace bloom

// key_type is program.DTYPE_CODES' (2 int64, 3 int32); bits is a power
// of two with bits / 32 words.
extern "C" int bloom_launch(const void* keys, int key_type,
                            const unsigned char* mask, int64_t n,
                            const uint32_t* words, int64_t bits, int k,
                            unsigned char* out, int ctas, int threads,
                            void* stream) {
  if ((key_type != 2 && key_type != 3) || bits < 32 || bits > (1LL << 32) ||
      (bits & (bits - 1)) || k < 1 || threads % 32)
    return (int)cudaErrorInvalidValue;
  bloom::bloom_kernel<<<ctas, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      keys, key_type, mask, n, words, (uint32_t)(bits - 1), k, out);
  return (int)cudaGetLastError();
}
