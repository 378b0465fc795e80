// Variants of the Q6 and Bloom kernels that the port does not keep, so
// that probes/stream_variants.py can time them beside the kernels it
// keeps on the same inputs, built with the same flags. The kept sources
// are included whole (their helpers are reused, and the kept Bloom
// kernel is launched here at another grid); nothing in the port links
// this file.
//
// Q6 (q6_variant_launch): four rows a thread a step in 16-byte loads, as
// the kept kernel (filter_agg_q6.cu), with
//   price 0: the price vector loaded for every group (the product is
//            selected after the compare);
//   price 1: the price vector loaded only by a thread whose group has a
//            passing row, behind a warp vote (the kept kernel's way);
//   price 2: as 1, with the next step's ship date, discount and quantity
//            loaded before this step's price;
// and the partials folded either by the last CTA behind a ticket (one
// launch, the kept kernel's way; the ticket starts at 0 and atomicInc
// leaves it at 0) or by a second launch of one CTA. Both folds run the
// same fixed-order tree.
//
// Bloom (bloom_variant_launch): a copy of the kept kernel's vector path
// and scalar loop (bloom.cu) whose second wave is
//   wave 0: k = 6 compiled in, the five reads issued at once;
//   wave 1: k at run time, the reads one after another;
//   wave 2: k at run time, in guarded batches of eight (the kept way);
// each compiled either for at least 4 CTAs an SM, as the kept kernel is
// (__launch_bounds__(256, 4)), or with the thread count alone
// (__launch_bounds__(256)).

#include "bloom.cu"
#include "filter_agg_q6.cu"

namespace variants {

using q6::Bounds;
using q6::kThreads;

__device__ __forceinline__ void fold(const float* partials, int ctas,
                                     float* out) {
  float r = 0.f;
  unsigned long long c = 0;
  for (int i = threadIdx.x; i < ctas; i += kThreads) {
    r += __ldcg(partials + 2 * i);
    c += __float_as_uint(__ldcg(partials + 2 * i + 1));
  }
  q6::block_sum(r, c);
  if (threadIdx.x == 0) {
    out[0] = r;
    out[1] = (float)c;
  }
}

// one group's four rows; the price vector loaded as Price says (``p``
// holds it already for price 0)
template <int Price>
__device__ __forceinline__ void group(const int4& s, const int4& d,
                                      const int4& q, const int4* price4,
                                      int64_t g, const Bounds& b, float& rev,
                                      unsigned& cnt, int4 p) {
  const float d0 = __int_as_float(d.x), d1 = __int_as_float(d.y),
              d2 = __int_as_float(d.z), d3 = __int_as_float(d.w);
  const bool o0 = q6::pass(s.x, d0, __int_as_float(q.x), b),
             o1 = q6::pass(s.y, d1, __int_as_float(q.y), b),
             o2 = q6::pass(s.z, d2, __int_as_float(q.z), b),
             o3 = q6::pass(s.w, d3, __int_as_float(q.w), b);
  if constexpr (Price != 0) {
    const bool need = o0 || o1 || o2 || o3;
    if (__any_sync(__activemask(), need) && need)
      p = q6::load_stream(price4 + g);
  }
  q6::add(o0, d0, __int_as_float(p.x), rev, cnt);
  q6::add(o1, d1, __int_as_float(p.y), rev, cnt);
  q6::add(o2, d2, __int_as_float(p.z), rev, cnt);
  q6::add(o3, d3, __int_as_float(p.w), rev, cnt);
}

template <int Price, bool Ticket>
__global__ void __launch_bounds__(kThreads)
q6_variant(const int* __restrict__ ship, const float* __restrict__ disc,
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
  const int4 zero = make_int4(0, 0, 0, 0);
  if constexpr (Price == 2) {
    int4 s = zero, d = zero, q = zero;
    if (tid < groups) {
      s = q6::load_stream(ship4 + tid);
      d = q6::load_stream(disc4 + tid);
      q = q6::load_stream(qty4 + tid);
    }
    for (int64_t g = tid; g < groups; g += stride) {
      const int4 cs = s, cd = d, cq = q;
      if (g + stride < groups) {
        s = q6::load_stream(ship4 + g + stride);
        d = q6::load_stream(disc4 + g + stride);
        q = q6::load_stream(qty4 + g + stride);
      }
      group<2>(cs, cd, cq, price4, g, b, rev, cnt, zero);
    }
  } else {
    for (int64_t g = tid; g < groups; g += stride) {
      const int4 s = q6::load_stream(ship4 + g);
      const int4 d = q6::load_stream(disc4 + g);
      const int4 q = q6::load_stream(qty4 + g);
      const int4 p = Price == 0 ? q6::load_stream(price4 + g) : zero;
      group<Price>(s, d, q, price4, g, b, rev, cnt, p);
    }
  }
  for (int64_t row = groups * q6::kGroup + tid; row < n; row += stride) {
    const float d = __ldg(disc + row);
    const bool ok = q6::pass(__ldg(ship + row), d, __ldg(qty + row), b);
    q6::add(ok, d, ok ? __ldg(price + row) : 0.f, rev, cnt);
  }
  q6::block_sum(rev, cnt);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = rev;
    partials[2 * blockIdx.x + 1] = __uint_as_float(cnt);
    if constexpr (Ticket) {
      __threadfence();
      last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    }
  }
  if constexpr (Ticket) {
    __syncthreads();
    if (last) fold(partials, gridDim.x, out);
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* partials, int ctas, float* __restrict__ out) {
  fold(partials, ctas, out);
}

template <int Price, bool Ticket>
cudaError_t q6_launch(const int* ship, const float* disc, const float* qty,
                      const float* price, int64_t n, int64_t groups,
                      Bounds b, float* partials, unsigned* ticket,
                      float* out, int max_ctas, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const int64_t tail = n - groups * q6::kGroup;
  const int ctas = grid_ctas(q6_variant<Price, Ticket>, kThreads, 0,
                             groups > tail ? groups : tail, max_ctas, &e);
  if (e != cudaSuccess) return e;
  q6_variant<Price, Ticket><<<ctas, kThreads, 0, s>>>(
      ship, disc, qty, price, n, groups, b, partials, ticket, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || Ticket) return e;
  fold_kernel<<<1, kThreads, 0, s>>>(partials, ctas, out);
  return cudaGetLastError();
}

// ---- Bloom -------------------------------------------------------------------

using bloom::bit_of;
using bloom::fmix32;
using bloom::kChunk;
using bloom::kRows;
using bloom::kSeed1;
using bloom::kSeed2;
using bloom::word_at;
constexpr int kK = 6;

// bloom.cu's bloom_kernel body with the second wave ``Wave``
template <class Key, int Wave>
__device__ __forceinline__ void bloom_body(
    const Key* __restrict__ keys, const unsigned char* __restrict__ mask,
    int64_t n, int64_t chunks, const uint32_t* __restrict__ words,
    uint32_t m, int k, unsigned char* __restrict__ out) {
  constexpr int R = 16 / sizeof(Key), V = kRows / R;
  using Unit = std::conditional_t<R == 2, unsigned short, unsigned>;
  const Unit* mask_u = reinterpret_cast<const Unit*>(mask);
  const int4* key_v = reinterpret_cast<const int4*>(keys);
  Unit* out_u = reinterpret_cast<Unit*>(out);
  const int lane = threadIdx.x % 32;
  const int64_t warp =
      (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int64_t warps = (int64_t)gridDim.x * blockDim.x / 32;
  if constexpr (Wave == 0) k = kK;
  Unit next[V];
  if (warp < chunks) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      next[j] = __ldg(mask_u + warp * 32 * V + j * 32 + lane);
  }
  for (int64_t c = warp; c < chunks; c += warps) {
    const int64_t base = c * 32 * V + lane;
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
      for (int j = 0; j < V; ++j)
        v[j] = bloom::load_stream(key_v + base + j * 32);
      uint32_t h1[kRows], w[kRows], ku[kRows];
      bool live[kRows];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (R == 2) {
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
      if (more) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!live[r]) continue;
          const uint32_t h2 = fmix32(ku[r] ^ kSeed2) | 1u;
          if constexpr (Wave == 0) {
            uint32_t w2[kK - 1];
#pragma unroll
            for (int i = 1; i < kK; ++i)
              w2[i - 1] = word_at(words, (h1[r] + (uint32_t)i * h2) & m);
#pragma unroll
            for (int i = 1; i < kK; ++i)
              live[r] = live[r] &&
                  bit_of(w2[i - 1], (h1[r] + (uint32_t)i * h2) & m);
          } else if constexpr (Wave == 1) {
            for (int i = 1; i < k && live[r]; ++i) {
              const uint32_t pos = (h1[r] + (uint32_t)i * h2) & m;
              live[r] = bit_of(word_at(words, pos), pos);
            }
          } else {
            for (int i0 = 1; i0 < k && live[r]; i0 += bloom::kBatch) {
              uint32_t w2[bloom::kBatch];
#pragma unroll
              for (int t = 0; t < bloom::kBatch; ++t)
                w2[t] = i0 + t < k
                    ? word_at(words, (h1[r] + (uint32_t)(i0 + t) * h2) & m)
                    : ~0u;
#pragma unroll
              for (int t = 0; t < bloom::kBatch; ++t)
                live[r] = live[r] &&
                    bit_of(w2[t], (h1[r] + (uint32_t)(i0 + t) * h2) & m);
            }
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

template <class Key, int Wave>
__global__ void __launch_bounds__(kThreads, bloom::kMinCtas)
bloom_variant(const Key* __restrict__ keys,
              const unsigned char* __restrict__ mask, int64_t n,
              int64_t chunks, const uint32_t* __restrict__ words,
              uint32_t m, int k, unsigned char* __restrict__ out) {
  bloom_body<Key, Wave>(keys, mask, n, chunks, words, m, k, out);
}

template <class Key, int Wave>
__global__ void __launch_bounds__(kThreads)
bloom_variant_threads(const Key* __restrict__ keys,
                      const unsigned char* __restrict__ mask, int64_t n,
                      int64_t chunks, const uint32_t* __restrict__ words,
                      uint32_t m, int k, unsigned char* __restrict__ out) {
  bloom_body<Key, Wave>(keys, mask, n, chunks, words, m, k, out);
}

template <class F>
cudaError_t bloom_go(F kernel, const long long* keys,
                     const unsigned char* mask, int64_t n, int64_t chunks,
                     const uint32_t* words, uint32_t m, int k,
                     unsigned char* out, cudaStream_t s) {
  const int64_t tail = n - chunks * kChunk;
  cudaError_t e = cudaSuccess;
  const int ctas = grid_ctas(kernel, kThreads, 0,
                             chunks * 32 > tail ? chunks * 32 : tail,
                             INT32_MAX, &e);
  if (e != cudaSuccess) return e;
  kernel<<<ctas, kThreads, 0, s>>>(keys, mask, n, chunks, words, m, k, out);
  return cudaGetLastError();
}

}  // namespace variants

// price: 0, 1 or 2 (above); ticket: 1 the last CTA folds (``ticket`` at
// 0), 0 a second launch folds. groups and partials as filter_agg_q6.cu.
extern "C" int q6_variant_launch(const int* ship, const float* disc,
                                 const float* qty, const float* price,
                                 int64_t n, int64_t groups, int date_lo,
                                 int date_hi, float disc_lo, float disc_hi,
                                 float qty_hi, float* partials,
                                 unsigned* ticket, float* out, int max_ctas,
                                 int price_mode, int use_ticket,
                                 void* stream) {
  using namespace variants;
  const Bounds b{date_lo, date_hi, disc_lo, disc_hi, qty_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q6(P, T)                                                         \
  q6_launch<P, T>(ship, disc, qty, price, n, groups, b, partials, ticket, \
                  out, max_ctas, s)
  cudaError_t e;
  switch (price_mode * 2 + (use_ticket ? 1 : 0)) {
    case 0: e = Q6(0, false); break;
    case 1: e = Q6(0, true); break;
    case 2: e = Q6(1, false); break;
    case 3: e = Q6(1, true); break;
    case 4: e = Q6(2, false); break;
    case 5: e = Q6(2, true); break;
    default: e = cudaErrorInvalidValue;
  }
#undef Q6
  return (int)e;
}

// int64 keys; wave 0, 1 or 2 (above); min4: compiled for at least 4
// CTAs an SM, else for the thread count alone. The rest as bloom.cu's
// bloom_launch.
extern "C" int bloom_variant_launch(const long long* keys,
                                    const unsigned char* mask, int64_t n,
                                    int64_t chunks, const uint32_t* words,
                                    int64_t bits, int k, unsigned char* out,
                                    int wave, int min4, void* stream) {
  using namespace variants;
  const uint32_t m = (uint32_t)(bits - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BV(K, W) \
  bloom_go(K<long long, W>, keys, mask, n, chunks, words, m, k, out, s)
  cudaError_t e;
  switch (wave * 2 + (min4 ? 1 : 0)) {
    case 0: e = BV(bloom_variant_threads, 0); break;
    case 1: e = BV(bloom_variant, 0); break;
    case 2: e = BV(bloom_variant_threads, 1); break;
    case 3: e = BV(bloom_variant, 1); break;
    case 4: e = BV(bloom_variant_threads, 2); break;
    case 5: e = BV(bloom_variant, 2); break;
    default: e = cudaErrorInvalidValue;
  }
#undef BV
  return (int)e;
}
