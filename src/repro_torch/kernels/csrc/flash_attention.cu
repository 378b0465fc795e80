// Causal, windowed or full GQA attention with an online softmax: the
// Hopper port of the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention (body _flash_kernel).
// q (BH, S, hd); k, v (BHkv, S, hd); query head bh reads KV head
// bh / group; float32 or bf16 inputs, float32 math, out in q's type.
//
// What bounds it: operations. A (64, 64) tile of scores costs 2·64·64·hd
// multiply-adds and reads 2·64·hd values, so it sits far above the HBM
// balance point; the least time is the unmasked work over the tensor
// cores' rate (bf16) or the CUDA cores' float32 rate. This first version
// runs on the CUDA cores: one CTA of 256 threads per (bh, 64-row query
// block); the Q tile and the current K/V tiles sit in shared memory as
// float32 (Q and K transposed, so a thread reads 4 rows or 4 columns as
// one float4); each thread owns a 4×4 block of the score tile and 4 rows
// × hd/16 columns of the output, with the running max m, normalizer l and
// accumulator in registers. Row max and row sums reduce over the 16 lanes
// that share the rows. The S×S scores never leave the SM. Tensor cores
// (mma.sync, wgmma) are a later step.
//
// Semantics kept from the reference: scores are q·k times the scale,
// masked to the finite -1e30 (NEG_INF); k-blocks wholly above the
// diagonal (causal) or wholly before the window are skipped; masked
// entries add nothing (p = 0, where the reference adds garbage that the
// next correction exp(-1e30 - m) wipes, with the same result); the output
// is acc / max(l, 1e-20). The ragged edge (rows or keys at or past S) is
// masked here instead of padded. Built with FMA contraction on: the
// tolerance is the reference's (2e-5 float32, 2e-2 bf16), not bit parity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace flash {

constexpr int kBlock = 64;         // query rows and keys per tile
constexpr int kStride = kBlock + 4;  // row stride of the transposed tiles
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_floats() {
  // qT (HD, kStride), kT (HD, kStride), vs (kBlock, HD), pT (kBlock, kStride)
  return (size_t)2 * HD * kStride + (size_t)kBlock * HD +
         (size_t)kBlock * kStride;
}

// A (kBlock, HD) tile of rows [row0, row0 + kBlock) of a (S, HD) head,
// into shared memory as float32, transposed ((HD, kStride)) or not
// ((kBlock, HD)); rows at or past S are zero.
template <typename T, int HD, bool kTranspose>
__device__ __forceinline__ void load_tile(const T* __restrict__ head,
                                          int row0, int S, float* dst) {
  for (int i = threadIdx.x; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = row0 + r;
    const float x = row < S ? to_f32(head[(int64_t)row * HD + d]) : 0.f;
    if (kTranspose)
      dst[d * kStride + r] = x;
    else
      dst[r * HD + d] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int group,
             float scale, int causal, int window) {
  static_assert(HD % 64 == 0, "head dim: a multiple of 64");
  constexpr int DJ = HD / 64;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + HD * kStride;
  float* vs = kT + HD * kStride;
  float* pT = vs + kBlock * HD;

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int64_t head = (int64_t)S * HD;
  const T* kh = k + (bh / group) * head;
  const T* vh = v + (bh / group) * head;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;  // the thread's 4 query rows
  const int c0 = (tid & 15) * 4;  // its 4 key columns; output cols c0 + 64j

  load_tile<T, HD, true>(q + bh * head, q0, S, qT);

  float acc[4][DJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  const int nk = (S + kBlock - 1) / kBlock;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    // the reference's block skipping: wholly above the diagonal (and so
    // is every later block), or wholly before the window
    if (causal && k0 > q0 + kBlock - 1) break;
    if (window && k0 + kBlock - 1 <= q0 - window) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, true>(kh, k0, S, kT);
    load_tile<T, HD, false>(vh, k0, S, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = ld4(qT + d * kStride + r0);
      const float4 b = ld4(kT + d * kStride + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
    }

    // mask and scale; the row max over the 16 lanes that share the rows
    unsigned ok = 0u;
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r0 + i;
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c0 + j;
        const bool keep = kp < S && (!causal || kp <= qp) &&
                          (!window || kp > qp - window);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        if (keep) ok |= 1u << (4 * i + j);
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));

    float corr[4], rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      rs[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = (ok >> (4 * i + j)) & 1u ? expf(s[i][j] - m[i]) : 0.f;
        rs[i] += p[i];
      }
      st4(pT + (c0 + j) * kStride + r0,
          make_float4(p[0], p[1], p[2], p[3]));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr[i];
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      const float4 p4 = ld4(pT + c * kStride + r0);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float4 v4 = ld4(vs + c * HD + 64 * j + c0);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += pv[i] * vv[e];
      }
    }
  }

  T* oh = o + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(oh + (int64_t)row * HD + 64 * j + c0 + e,
              acc[i][j][e] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int group, int S, float scale, int causal, int window,
           cudaStream_t s) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kBlock - 1) / kBlock, BH);
  flash_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, scale, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 float32, 1 bf16; hd: 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH,
                                      int group, int S, int hd, int dtype,
                                      int causal, int window, float scale,
                                      void* stream) {
  using namespace flash;
  if (BH < 1 || group < 1 || S < 1 || BH > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, BH, group, S, scale, causal,
                             window, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, BH, group, S, scale, causal,
                              window, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, BH, group, S, scale,
                                     causal, window, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, BH, group, S, scale,
                                      causal, window, s);
  return (int)cudaErrorInvalidValue;
}
