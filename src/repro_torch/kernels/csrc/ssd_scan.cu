// Mamba2 SSD chunked scan: the Hopper port of the Pallas kernel
// repro/kernels/ssd_scan.py:ssd_scan (body _ssd_kernel).
// x (b, S, H, P); dt (b, S, H), softplus'd; A_log (H,); B, C (b, S, N);
// all float32; y (b, S, H, P). Per chunk of Q tokens, with
// cum = the inclusive cumsum of dt·a (a = -exp(A_log)) over the chunk:
//   y_s   = sum_{t<=s} (C_s·B_t) exp(cum_s - cum_t) dt_t x_t
//           + exp(cum_s) C_s · state
//   state = exp(cum_last) state + sum_t exp(cum_last - cum_t) dt_t B_t ⊗ x_t
//
// The TPU kernel made the chunk axis the sequential inner grid axis and
// carried the (N, P) float32 state in VMEM scratch. Blocks here run in no
// order, so one CTA per (b, h) loops over the chunks itself and keeps the
// state in shared memory (32 KB at N 128, P 64). The (Q, Q) masked-decay
// tile does not fit (256 KB at Q 256, above a block's 227 KB), so the
// chunk runs in strips of 64 query rows: for each strip, C·Bᵀ and the
// decay are formed one (64, 64) tile at a time over the key tiles at or
// before it, and multiplied into the strip's x rows at once. Each thread
// owns a 4×4 block of the tile and of the strip's (64, P) output, and
// 8 rows × 4 columns of the state at N 128.
//
// What bounds it: operations. At mamba2-130m's widths a chunk does about
// 2·Q²/2·(N + P) + 4·Q·N·P multiply-adds per head against Q·(P + N)·4
// bytes read, well above the balance point; the CUDA cores' float32 rate
// is the ceiling of this version (no tensor cores yet). Parallelism is
// b·H CTAs of one chunk loop each: 192 at mamba2's (8, 24), 50 for
// hymba's one sequence, below the card's 132 SMs × its occupancy; a
// two-pass design (chunk states in parallel, then a scan) is the next
// step. Positions at or past S read as zero (dt = 0: no decay, no state
// update), as the reference's padding; their outputs are not written.
// Built with FMA contraction on (tolerance, not bit parity).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace ssd {

constexpr int kTile = 64;
constexpr int kStride = kTile + 4;  // row stride of the transposed tiles
constexpr int kP = 64;              // head dim P
constexpr int kThreads = 256;
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int N>
constexpr size_t smem_floats(int Q) {
  // state (N, P), cT and bT (N, kStride), xs (kTile, P), wT (kTile,
  // kStride), and four (Q,) chunk arrays: dt, cum, exp(cum) and
  // exp(cum_last - cum)·dt
  return (size_t)N * kP + 2 * (size_t)N * kStride + (size_t)kTile * kP +
         (size_t)kTile * kStride + 4 * (size_t)Q;
}

struct Seq {          // one (b, h) sequence
  const float* x;     // row t at x + t * x_row (P floats)
  const float* B;     // row t at B + t * N
  const float* C;
  int64_t x_row;
  int S;
};

// Rows [t0, t0 + kTile) of the chunk at ``base`` (local index < Q, position
// < S; others zero) of a (S, N) projection, transposed into (N, kStride).
template <int N>
__device__ __forceinline__ void load_proj(const float* __restrict__ src,
                                          int base, int t0, int Q, int S,
                                          float* dst) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int t = i / N, n = i % N, loc = t0 + t, pos = base + loc;
    dst[n * kStride + t] =
        loc < Q && pos < S ? __ldg(src + (int64_t)pos * N + n) : 0.f;
  }
}

__device__ __forceinline__ void load_x(const Seq& q, int base, int t0, int Q,
                                       float* dst) {
  for (int i = threadIdx.x; i < kTile * kP; i += kThreads) {
    const int t = i / kP, p = i % kP, loc = t0 + t, pos = base + loc;
    dst[i] = loc < Q && pos < q.S ? __ldg(q.x + pos * q.x_row + p) : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A_log, const float* __restrict__ B,
           const float* __restrict__ C, float* __restrict__ y, int S, int H,
           int Q) {
  static_assert(N % 16 == 0, "state size: a multiple of 16");
  constexpr int NR = N / 16;  // state rows per thread
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // (N, P)
  float* cT = st + N * kP;                       // (N, kStride)
  float* bT = cT + N * kStride;                  // (N, kStride)
  float* xs = bT + N * kStride;                  // (kTile, P)
  float* wT = xs + kTile * kP;                   // (kTile, kStride)
  float* dts = wT + kTile * kStride;             // (Q,)
  float* cum = dts + Q;
  float* ecum = cum + Q;                         // exp(cum)
  float* ut = ecum + Q;                          // exp(total - cum)·dt

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t x_row = (int64_t)H * kP;
  const Seq sq{x + ((int64_t)b * S * H + h) * kP, B + (int64_t)b * S * N,
               C + (int64_t)b * S * N, x_row, S};
  float* yh = y + ((int64_t)b * S * H + h) * kP;
  const float* dth = dt + (int64_t)b * S * H + h;
  const float a = -expf(__ldg(A_log + h));
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;   // tile rows (queries s) of the thread
  const int c0 = (tid & 15) * 4;   // tile columns (keys t, or P columns)
  const int n0 = (tid >> 4) * NR;  // state rows of the thread

  for (int i = tid; i < N * kP; i += kThreads) st[i] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int base = c * Q;
    __syncthreads();  // the previous chunk's state is written
    for (int t = tid; t < Q; t += kThreads)
      dts[t] = base + t < S ? __ldg(dth + (int64_t)(base + t) * H) : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt·a: runs per lane, then a scan
      const int per = (Q + 31) / 32, lo = tid * per;
      const int hi = min(lo + per, Q);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) run += dts[t] * a;
      float inc = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += o;
      }
      run = inc - run;
      for (int t = lo; t < hi; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      ecum[t] = expf(cum[t]);
      ut[t] = expf(total - cum[t]) * dts[t];
    }

    for (int s0 = 0; s0 < Q; s0 += kTile) {
      __syncthreads();  // cT's readers are done; ecum and ut are written
      load_proj<N>(sq.C, base, s0, Q, S, cT);
      __syncthreads();
      // inter-chunk term: exp(cum_s) C_s · state
      float yacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cc = ld4(cT + n * kStride + r0);
        const float4 ss = ld4(st + n * kP + c0);
        const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
        const float sv[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + r0 + i;
        const float e = s < Q ? ecum[s] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] *= e;
      }
      // intra-chunk term over the key tiles at or before the strip
      for (int t0 = 0; t0 <= s0; t0 += kTile) {
        __syncthreads();  // bT, xs and wT's readers are done
        load_proj<N>(sq.B, base, t0, Q, S, bT);
        load_x(sq, base, t0, Q, xs);
        __syncthreads();
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cc = ld4(cT + n * kStride + r0);
          const float4 bb = ld4(bT + n * kStride + c0);
          const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + c0 + j;
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s0 + r0 + i;
            w[i] = t <= s && s < Q
                       ? cb[i][j] * expf(cum[s] - cum[t]) * dts[t]
                       : 0.f;
          }
          st4(wT + (c0 + j) * kStride + r0,
              make_float4(w[0], w[1], w[2], w[3]));
        }
        __syncthreads();
#pragma unroll 4
        for (int t = 0; t < kTile; ++t) {
          const float4 ww = ld4(wT + t * kStride + r0);
          const float4 xx = ld4(xs + t * kP + c0);
          const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
          const float xv[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yacc[i][j] += wv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int loc = s0 + r0 + i, pos = base + loc;
        if (loc >= Q || pos >= S) continue;
        st4(yh + pos * x_row + c0,
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]));
      }
    }

    // state update: exp(total) state + sum_t ut_t B_t ⊗ x_t
    __syncthreads();  // every strip has read the state
    const float et = expf(total);
    float sacc[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float4 ss = ld4(st + (n0 + i) * kP + c0);
      sacc[i][0] = ss.x * et;
      sacc[i][1] = ss.y * et;
      sacc[i][2] = ss.z * et;
      sacc[i][3] = ss.w * et;
    }
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();
      load_proj<N>(sq.B, base, t0, Q, S, bT);
      load_x(sq, base, t0, Q, xs);
      __syncthreads();
      const int tn = min(kTile, Q - t0);
      for (int t = 0; t < tn; ++t) {
        const float u = ut[t0 + t];
        const float4 xx = ld4(xs + t * kP + c0);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float bu = bT[(n0 + i) * kStride + t] * u;
          sacc[i][0] += bu * xx.x;
          sacc[i][1] += bu * xx.y;
          sacc[i][2] += bu * xx.z;
          sacc[i][3] += bu * xx.w;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NR; ++i)
      st4(st + (n0 + i) * kP + c0,
          make_float4(sacc[i][0], sacc[i][1], sacc[i][2], sacc[i][3]));
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* A_log,
           const float* B, const float* C, float* y, int bsz, int S, int H,
           int Q, cudaStream_t s) {
  const size_t smem = smem_floats<N>(Q) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<N><<<bsz * H, kThreads, smem, s>>>(x, dt, A_log, B, C, y, S, H,
                                                Q);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// P must be 64; N 16, 32, 64 or 128; 1 <= Q <= 1024.
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A_log, const float* B,
                               const float* C, float* y, int bsz, int S,
                               int H, int P, int N, int Q, void* stream) {
  using namespace ssd;
  if (bsz < 1 || S < 1 || H < 1 || P != kP || Q < 1 || Q > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(x, dt, A_log, B, C, y, bsz, S, H, Q, s);
    case 32: return launch<32>(x, dt, A_log, B, C, y, bsz, S, H, Q, s);
    case 64: return launch<64>(x, dt, A_log, B, C, y, bsz, S, H, Q, s);
    case 128: return launch<128>(x, dt, A_log, B, C, y, bsz, S, H, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
