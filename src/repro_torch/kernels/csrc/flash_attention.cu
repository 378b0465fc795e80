// Causal, windowed or full GQA attention with an online softmax: the
// Hopper port of the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention (body _flash_kernel).
// q (BH, S, hd); k, v (BHkv, S, hd); query head bh reads KV head
// bh / group; float32 or bf16 inputs, float32 softmax, out in q's type;
// hd 64 or 128.
//
// What bounds it: operations. A (64, 64) tile of scores costs 2·64·64·hd
// multiply-adds and reads 2·64·hd values, far above the HBM balance
// point; the least time is the unmasked work over the tensor cores' rate
// (bf16) or the CUDA cores' float32 rate. Two kernels:
//   * float32 (flash_kernel): the CUDA cores, since TF32 tensor cores
//     would miss the 2e-5 tolerance. One CTA of 256 threads per (bh,
//     64-row query block); the Q tile and the current K/V tiles sit in
//     shared memory as float32 (Q and K transposed, so a thread reads 4
//     rows or 4 columns as one float4); each thread owns a 4×4 block of
//     the score tile and 4 rows × hd/16 columns of the output, with the
//     running max m, normalizer l and accumulator in registers.
//   * bf16 (wg::flash_wgmma_kernel): the tensor cores. One CTA of one
//     warpgroup per (bh, 64 query rows); Q is loaded once, and K and V
//     tiles of 64 keys come through a two-stage ring in shared memory,
//     filled by TMA (3-D tensor maps encoded on the host with
//     cuTensorMapEncodeTiled, 128-byte swizzle, one 64-column box per
//     128-byte row; rows past S read as zero) and counted on mbarriers.
//     S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared memory;
//     the softmax runs on the accumulator registers (row max and sum
//     over the 4 lanes that share a row; exp2 on the special-function
//     unit). P enters the PV product split in two bf16 parts, hi =
//     bf16(p) and lo = bf16(p - hi), as two register-A wgmmas
//     (m64n{hd}k16, V transposed from shared memory) into one float32
//     accumulator: rounding P once to bf16, as SDPA does, puts about a
//     fifth of the outputs outside half a bf16 ulp of the float32
//     result; the split costs a third product, 6·hd executed operations
//     a (query, key) pair against the 4·hd needed. No warp
//     specialisation, no persistent grid, and no overlap of a tile's
//     softmax with the next tile's QKᵀ inside the warpgroup (issued
//     early, ptxas serialises the wgmmas: its warning C7515, as the
//     rescaled accumulator is written while a product is in flight):
//     thread 0 issues the TMA loads, the next tile's load overlaps this
//     tile's products, independent one-warpgroup CTAs share each SM so
//     that one's softmax overlaps another's products, and the longest
//     (causal) query blocks start first.
//
// Semantics kept from the reference: scores are q·k times the scale,
// masked to the finite -1e30 (NEG_INF); k-blocks wholly above the
// diagonal (causal) or wholly before the window are skipped; masked
// entries add nothing (p = 0, where the reference adds garbage that the
// next correction exp(-1e30 - m) wipes, with the same result; the bf16
// kernel masks scores to -inf, so exp2 gives that 0, while m starts at
// the finite -1e30 and never meets an inf - inf); the output
// is acc / max(l, 1e-20). The ragged edge (rows or keys at or past S) is
// masked here instead of padded. Built with FMA contraction on: the
// tolerance is the reference's (2e-5 float32, 2e-2 bf16), not bit parity;
// chip_smoke.py also holds bf16 to half a bf16 ulp of the float32 result.

#include <cuda.h>
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// -- bf16: tensor cores -----------------------------------------------------

namespace wg {

constexpr int kRows = 64;      // query rows a CTA: one warpgroup
constexpr int kKeys = 64;      // keys a tile
constexpr int kBox = 64;       // bf16 columns a TMA box: 128 B, the swizzle
constexpr int kThreads = 128;  // the warpgroup
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int HD>
struct Layout {
  static constexpr int kQBytes = kRows * HD * 2;      // HD/64 boxes
  static constexpr int kTileBytes = kKeys * HD * 2;   // K or V, a stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map (column, row, head) into shared memory;
// completion is counted in bytes on ``bar``. Rows past S are zero.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or reuses of registers that an
// asynchronous wgmma writes or reads across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, float32) (+)= A · Bᵀ, A and B bf16 in shared memory, both
// K-major (128B-swizzled descriptors); ``acc`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, float32) += A · B, A bf16 in registers (four 32-bit
// registers of bf16 pairs a thread), B bf16 in shared memory, MN-major
// (transposed, 128B-swizzled descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A · B, A bf16 in registers (four 32-bit
// registers of bf16 pairs a thread), B bf16 in shared memory, MN-major
// (transposed, 128B-swizzled descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// A bf16 pair as the wgmma A fragment holds it: .x in the low half
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error below 2^-22); -inf
// gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Key tile kb of KV head bkv (K and V, every 64-column box) into one
// stage, K at ``sk`` and V after it; one thread issues it.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* sk, const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* bar,
                                        int kb, int bkv) {
  bf16* sv = sk + kKeys * HD;
  mbar_expect_tx(bar, 2 * Layout<HD>::kTileBytes);
#pragma unroll
  for (int c = 0; c < HD / kBox; ++c) {
    tma_load(sk + c * kKeys * kBox, tk, bar, c * kBox, kb * kKeys, bkv);
    tma_load(sv + c * kKeys * kBox, tv, bar, c * kBox, kb * kKeys, bkv);
  }
}

// One CTA, one warpgroup: 64 query rows of head bh from q0 (the grid's x
// runs the blocks last to first, so the long causal rows start first).
// Thread t holds rows q0 + w·16 + lane/4 and 8 below it (w = its warp)
// and, of every 8 columns j of a score or output tile, columns
// 8j + 2(lane % 4) + {0, 1}: the wgmma accumulator layout. The scores' layout, pair for pair, is the A
// fragment of the next k16 product, so P goes from the scores to the PV
// product without a shuffle.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, int S, int group, float scale,
                       int causal, int window) {
  constexpr int NC = HD / kBox;  // 64-column boxes per row
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  bf16* sq = reinterpret_cast<bf16*>(base);
  // stage st: K at stage(st), V after it
  auto stage = [&](int st) {
    return reinterpret_cast<bf16*>(base + L::kQBytes +
                                   2 * st * L::kTileBytes);
  };
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* bar_kv = bar_q + 1;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, bkv = bh / group;
  const int nk = (S + kKeys - 1) / kKeys;
  const int kb0 = window ? max(0, q0 - window + 1) / kKeys : 0;
  const int kb1 = causal ? min(nk, min(q0 + kRows - 1, S - 1) / kKeys + 1)
                         : nk;
  const int nt = kb1 - kb0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(&bar_kv[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(sq + c * kRows * kBox, &tq, bar_q, c * kBox, q0, bh);
    for (int st = 0; st < kStages && st < nt; ++st)
      load_kv<HD>(stage(st), &tk, &tv, &bar_kv[st], kb0 + st, bkv);
  }

  const int w = tid >> 5, lane = tid & 31;
  const int qa = q0 + 16 * w + (lane >> 2);  // the thread's rows qa, qa+8
  const int c2 = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;          // scores in log2 units

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m: log2 units

  mbar_wait(bar_q, 0);
  for (int i = 0; i < nt; ++i) {
    const int st = i % kStages;
    const int k0 = (kb0 + i) * kKeys;
    const bf16* sk = stage(st);
    const bf16* sv = sk + kKeys * HD;
    mbar_wait(&bar_kv[st], (i / kStages) & 1);
    // S = Q Kᵀ: HD/16 k16 steps, Q and K both K-major
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(s, desc(sq + c * kRows * kBox + 16 * kk, 16, 1024),
                     desc(sk + c * kKeys * kBox + 16 * kk, 16, 1024),
                     (c | kk) != 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // mask (only a tile that crosses the diagonal, the window's edge
    // or S) to -inf, so p = 0 there while m stays finite; row max over
    // the 4 lanes that share a row; scores in log2 units
    const bool full = k0 + kKeys <= S &&
                      (!causal || k0 + kKeys - 1 <= q0) &&
                      (!window || k0 > q0 + kRows - 1 - window);
    if (!full) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + 8 * (e >> 2) + c2 + (e & 1);
        const int qp = qa + 8 * ((e >> 1) & 1);
        if (!(kp < S && (!causal || kp <= qp) &&
              (!window || kp > qp - window)))
          s[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // p in float32 for the normalizer; split into two bf16 parts for
    // the product, hi = bf16(p), lo = bf16(p - hi): one rounding of p
    // to bf16 fails the half-ulp check on about a fifth of the outputs
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = (e >> 1) & 1;
      const float p0 = ex2(fmaf(s[e], sl2, -m[r]));
      const float p1 = ex2(fmaf(s[e + 1], sl2, -m[r]));
      l[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x,
                                                      p1 - hf.y);
      // pair e/2 of the scores: k16 step e/8, register (e/2) % 4
      ahi[e >> 3][(e >> 1) & 3] = bits(hi);
      alo[e >> 3][(e >> 1) & 3] = bits(lo);
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] *= corr[(e >> 1) & 1];

    // O += P_hi V + P_lo V: 4 k16 steps of 16 keys each, V MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(sv + 16 * kk * kBox, kKeys * kBox * 2,
                               1024);
      wgmma_pv<HD>(acc, ahi[kk], dv);
      wgmma_pv<HD>(acc, alo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
    __syncthreads();  // every warp is past this stage's wait and products
    if (tid == 0 && i + kStages < nt)
      load_kv<HD>(stage(st), &tk, &tv, &bar_kv[st], kb0 + i + kStages, bkv);
  }

  // the normalizer over the row's 4 lanes; acc / max(l, 1e-20) in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
  bf16* oh = o + (int64_t)bh * S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qa + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
      *reinterpret_cast<__nv_bfloat162*>(oh + (int64_t)row * HD + 8 * j +
                                         c2) = v;
    }
  }
}

// A 3-D tensor map over (BH, S, HD) bf16: box (64 columns, ``rows``
// rows, one head), 128-byte swizzle, rows past S read as zero.
inline CUresult tensor_map(CUtensorMap* map, const void* p, int heads,
                           int S, int HD, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)S * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int group, int S, float scale, int causal, int window,
           cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (tensor_map(&tq, q, BH, S, HD, kRows) != CUDA_SUCCESS ||
      tensor_map(&tk, k, BH / group, S, HD, kKeys) != CUDA_SUCCESS ||
      tensor_map(&tv, v, BH / group, S, HD, kKeys) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<HD>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kRows - 1) / kRows, BH);
  flash_wgmma_kernel<HD><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), S, group, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
    return wg::launch<64>(q, k, v, o, BH, group, S, scale, causal, window,
                          s);
  if (dtype == 1 && hd == 128)
    return wg::launch<128>(q, k, v, o, BH, group, S, scale, causal, window,
                           s);
  return (int)cudaErrorInvalidValue;
}
