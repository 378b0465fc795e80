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
// carried the (N, P) state in VMEM scratch. Here the chunks run in
// parallel, in three launches:
//   1. chunk_state_kernel, one CTA per (b, chunk, head): the cumsum of
//      dt·a in float64 (written out with dt for phase 3) and the chunk's
//      own state Bᵀ·(u ⊙ x), u_t = exp(cum_last - cum_t) dt_t, (N, P);
//      none after the last chunk. A float32 cumsum of a 1024-token
//      chunk reaches |cum| ~ 1e3, where a float32 ulp is 1e-4, and every
//      decay is a difference of two cumsums.
//   2. state_pass_kernel, per (b, head, state element), in order over
//      the chunks: the state entering chunk c + 1 is exp(cum_last_c) ·
//      (the state entering c) + chunk c's own; written in place.
//   3. chunk_out_kernel, one 4-warp CTA per (b, chunk, 64-row strip,
//      head group), two to an SM: C·Bᵀ for the strip's rows and the keys
//      at or before them, formed once into shared memory and shared by
//      the group's heads (all H unless that leaves the card under two
//      waves, see ssd_scan.py:head_group); then per head exp(cum_s) C_s ·
//      state plus the masked decay and dt applied to C·Bᵀ, times x. Off
//      the diagonal tile the decay factors through the strip's first
//      row (two factors <= 1, one per row and one per key), so only the
//      diagonal tile takes an exp per element. Each head's state and x
//      tiles are loaded into registers one item ahead of the one that
//      computes.
// The products (C·Bᵀ, W·x, C·state, Bᵀ·(u ⊙ x)) run on the tensor cores
// as mma.sync m16n8k8 TF32, each operand split into hi = tf32(v) and
// lo = tf32(v - hi) (tf32: the low 13 mantissa bits cleared, as the
// tensor cores read a register) and the three products lo·hi + hi·lo +
// hi·hi summed in one float32 accumulator: one TF32 product misses the
// reference's 5e-5 of max |y| by about ten times
// (test_ssd_scan_tf32_needs_split). Staged tiles are split once as they
// land in shared memory. Each warp keeps eight accumulators and issues
// each round of products over all eight, so the dependent products of
// one accumulator do not stall the warp. A chunk's keys past 128 take a
// second C·Bᵀ block; the strip's outputs then accumulate in y.
//
// What bounds it: at mamba2-130m's widths the needed operations over the
// data sheet's TF32 rate come to about 0.6 of the bytes over its HBM
// rate, so bytes; the split triples the products' executed work, and
// the phase scratch (the states written, passed and read) adds bytes
// the bound does not count. Positions at or past S read as zero (dt = 0: no decay,
// no state update), as the reference's padding; their outputs are not
// written. Built with FMA contraction on (tolerance, not bit parity).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cuda_error.cuh"

namespace ssd {

constexpr int kTile = 64;       // rows of a strip; keys of a key tile
constexpr int kP = 64;          // head dim P
constexpr int kXs = kP + 8;     // row stride of x and state tiles (8 mod 32)
constexpr int kThreads = 256;   // 8 warps: phase 1
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// -- TF32 tensor-core products -------------------------------------------

// hi = v with its low 13 mantissa bits cleared (a TF32 value), lo = the
// float32 remainder v - hi, exact. The tensor cores read a TF32 operand's
// register and ignore its low 13 bits, so lo enters the product as
// tf32(lo), and hi + tf32(lo) is v within 2^-20 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A fragment of m16n8k8 (row-major 16×8): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4), with g = lane / 4 and t = lane % 4.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};
// B fragment (8×8, column-major): b0 (k t, n g), b1 (k t+4, n g).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a·b[j] for the NT n8 tiles of a warp's row of tiles, both
// operands split: lo·hi, then hi·lo, then hi·hi, each round over all NT
// tiles, so NT independent accumulators are in flight between dependent
// products. Accumulator d: d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t),
// d3 (g+8, 2t+1).
template <int NT>
__device__ __forceinline__ void mma3(float (&d)[NT][4], const FragA& a,
                                     const FragB (&b)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(d[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(d[j], a.hi, b[j].hi);
}

// A staged (kTile, kP) tile of TF32 parts: the hi parts, then the lo
// parts, row stride kXs.
constexpr int kStagedWords = 2 * kTile * kXs;
__device__ __forceinline__ void st_split4(uint32_t* tile, int row, int col,
                                          float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(tile + row * kXs + col) = h;
  *reinterpret_cast<uint4*>(tile + kTile * kXs + row * kXs + col) = l;
}
// The B fragment of the n8 tile at column n0, k-step at row k0.
__device__ __forceinline__ void ld_fragb(FragB& f, const uint32_t* tile,
                                         int k0, int n0, int g, int tg) {
  const uint32_t* hi = tile + (k0 + tg) * kXs + n0 + g;
  const uint32_t* lo = hi + kTile * kXs;
  f.hi[0] = hi[0];
  f.hi[1] = hi[4 * kXs];
  f.lo[0] = lo[0];
  f.lo[1] = lo[4 * kXs];
}

// Inclusive cumsum of v[0, n) in place by one warp (n <= 1024), in
// float64: a run per lane, a shuffle scan of the runs, each lane's
// exclusive prefix taken from its neighbour's inclusive one.
__device__ __forceinline__ void warp_cumsum(double* v, int n, int lane) {
  const int per = (n + 31) / 32, lo = lane * per;
  const int hi = min(lo + per, n);
  double run = 0.0;
  for (int t = lo; t < hi; ++t) run += v[t];
  double inc = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) run = 0.0;
  for (int t = lo; t < hi; ++t) {
    run += v[t];
    v[t] = run;
  }
}

// -- phase 1: each chunk's cumsum and own state ---------------------------

// Q rounded up to a multiple of 4: the float64 cumsum ahead of the
// float4 tiles keeps them 16-byte aligned
__host__ __device__ constexpr int padded(int Q) { return (Q + 3) & ~3; }

template <int N>
constexpr int state_smem_floats(int Q) {
  // cum (Q,) float64, Bs (kTile, N + 8), u ⊙ x staged as TF32 parts,
  // dt·u (Q,)
  return 2 * padded(Q) + kTile * (N + 8) + kStagedWords + Q;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A_log,
                   const float* __restrict__ B, float* __restrict__ states,
                   double* __restrict__ cumq, float* __restrict__ dtq,
                   float* __restrict__ tot, int S, int H, int Q, int nc) {
  constexpr int kBs = N + 8;   // read transposed by the A fragment
  constexpr int MT = N / 16;   // m16 tiles of the (N, P) state
  constexpr int WN = 8 / MT;   // warps along P
  constexpr int NT = MT;       // n8 tiles of a warp: (P / 8) / WN
  extern __shared__ float4 smem4[];
  double* cum = reinterpret_cast<double*>(smem4);       // (Q,)
  float* Bs = reinterpret_cast<float*>(cum + padded(Q));  // (kTile, kBs)
  uint32_t* xs = reinterpret_cast<uint32_t*>(Bs + kTile * kBs);
  float* us = reinterpret_cast<float*>(xs + kStagedWords);  // dt, dt·u

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc, base = c * Q;
  const float a = -expf(__ldg(A_log + h));
  for (int t = tid; t < Q; t += kThreads) {
    const int pos = base + t;
    const float d = pos < S ? __ldg(dt + ((int64_t)b * S + pos) * H + h)
                            : 0.f;
    us[t] = d;
    cum[t] = (double)(d * a);
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(cum, Q, tid);
  __syncthreads();
  const double total = cum[Q - 1];
  const int64_t row = ((int64_t)bc * H + h) * Q;
  for (int t = tid; t < Q; t += kThreads) {
    cumq[row + t] = cum[t];
    dtq[row + t] = us[t];
  }
  if (tid == 0) tot[(int64_t)bc * H + h] = (float)total;
  if (c == nc - 1) return;  // no state leaves the last chunk
  for (int t = tid; t < Q; t += kThreads)
    us[t] = expf((float)(total - cum[t])) * us[t];

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int m0 = (warp / WN) * 16, n0 = (warp % WN) * NT * 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const float* xh = x + ((int64_t)b * S * H + h) * kP;
  const int64_t x_row = (int64_t)H * kP;
  const float* Bb = B + (int64_t)b * S * N;
  for (int t0 = 0; t0 < Q; t0 += kTile) {
    __syncthreads();  // us is written; the previous tile's readers are done
    for (int i = tid; i < kTile * N / 4; i += kThreads) {
      const int t = i / (N / 4), n4 = (i % (N / 4)) * 4;
      const int loc = t0 + t, pos = base + loc;
      st4(Bs + t * kBs + n4, loc < Q && pos < S
                                 ? ld4(Bb + (int64_t)pos * N + n4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int i = tid; i < kTile * kP / 4; i += kThreads) {
      const int t = i / (kP / 4), p4 = (i % (kP / 4)) * 4;
      const int loc = t0 + t, pos = base + loc;
      st_split4(xs, t, p4,
                loc < Q && pos < S
                    ? scale4(ld4(xh + pos * x_row + p4), us[loc])
                    : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();
    const int kn = min(kTile, Q - t0);
    for (int k0 = 0; k0 < kn; k0 += 8) {
      // A = Bᵀ: (state row n, key t)
      FragA fa;
      const float* b0 = Bs + (k0 + tg) * kBs + m0 + g;
      const float* b4 = b0 + 4 * kBs;
      fa.set(b0[0], b0[8], b4[0], b4[8]);
      FragB fb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ld_fragb(fb[j], xs, k0, n0 + 8 * j, g, tg);
      mma3(acc, fa, fb);
    }
  }
  float* st = states + (((int64_t)b * (nc - 1) + c) * H + h) * N * kP;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + 2 * tg;
    *reinterpret_cast<float2*>(st + (m0 + g) * kP + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(st + (m0 + g + 8) * kP + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// -- phase 2: the states entering the chunks -----------------------------

// states holds chunk c's own state in slot c (c < nc - 1); afterwards
// slot c holds the state entering chunk c + 1.
__global__ void state_pass_kernel(float* __restrict__ states,
                                  const float* __restrict__ tot, int bsz,
                                  int H, int np4, int nc) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= (int64_t)bsz * H * np4) return;
  const int e = (int)(i % np4);
  const int64_t bh = i / np4;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc - 1; ++c) {
    float4* p = reinterpret_cast<float4*>(
                    states + (((int64_t)b * (nc - 1) + c) * H + h) * np4 * 4) +
                e;
    const float d = expf(tot[((int64_t)b * nc + c) * H + h]);
    const float4 l = *p;
    run = make_float4(d * run.x + l.x, d * run.y + l.y, d * run.z + l.z,
                      d * run.w + l.w);
    *p = run;
  }
}

// -- phase 3: each strip's outputs ----------------------------------------

constexpr int kOutThreads = 128;  // 4 warps, 16 strip rows each
constexpr int kKeyBlock = 128;    // keys of one C·Bᵀ block in shared memory

template <int N>
constexpr int out_smem_floats(int kb_cap) {
  // the rows' and the keys' cumsums (float64), Cs (kTile, N + 4), Gs
  // (kTile, kb_cap + 4), then Bs (kTile, N + 4) while C·Bᵀ forms, or an
  // x or state tile staged as TF32 parts; the keys' dt and
  // exp(m - cum_t) dt_t, the rows' exp(cum_s - m)
  return 2 * (kTile + kb_cap) + kTile * (N + 4) + kTile * (kb_cap + 4) +
         (kTile * (N + 4) > kStagedWords ? kTile * (N + 4)
                                         : kStagedWords) +
         2 * kb_cap + kTile;
}

// Warp w owns rows [16w, 16w + 16) of the strip and all 64 columns (of a
// C·Bᵀ key tile, or of P): eight n8 tiles, eight accumulators in flight.
template <int N>
__global__ void __launch_bounds__(kOutThreads, 2)
chunk_out_kernel(const float* __restrict__ x, const float* __restrict__ B,
                 const float* __restrict__ C,
                 const float* __restrict__ states,
                 const double* __restrict__ cumq,
                 const float* __restrict__ dtq, float* __restrict__ y, int S,
                 int H, int Q, int nc, int strips, int group, int groups,
                 int kb_cap) {
  constexpr int kCs = N + 4;  // row stride of C and B tiles (4 mod 32)
  constexpr int NT = kP / 8;  // n8 tiles of a warp
  extern __shared__ float4 smem4[];
  const int kGs = kb_cap + 4;
  double* rowcum = reinterpret_cast<double*>(smem4);  // (kTile,)
  double* keycum = rowcum + kTile;                     // (kb_cap,)
  float* Cs = reinterpret_cast<float*>(keycum + kb_cap);  // (kTile, kCs)
  float* Gs = Cs + kTile * kCs;                            // (kTile, kGs)
  float* U = Gs + kTile * kGs;
  float* Bs = U;                                  // (kTile, kCs)
  uint32_t* xs = reinterpret_cast<uint32_t*>(U);  // the staged tile
  float* keydt = U + (kTile * kCs > kStagedWords ? kTile * kCs
                                                 : kStagedWords);
  float* ekdt = keydt + kb_cap;  // (kb_cap,)
  float* er = ekdt + kb_cap;     // (kTile,)

  int idx = blockIdx.x;
  const int gi = idx % groups;
  idx /= groups;
  const int strip = idx % strips;
  idx /= strips;
  const int c = idx % nc, b = idx / nc;
  const int base = c * Q, s0 = strip * kTile;
  const int h0 = gi * group, h1 = min(h0 + group, H);
  if (s0 >= Q || base + s0 >= S || h0 >= H) return;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // the thread's strip rows
  const bool v0 = s0 + r0 < Q && base + s0 + r0 < S;
  const bool v1 = s0 + r1 < Q && base + s0 + r1 < S;
  const int64_t x_row = (int64_t)H * kP;
  const float* Bb = B + (int64_t)b * S * N;
  const float* Cb = C + (int64_t)b * S * N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < kTile * N / 4; i += kOutThreads) {
    const int r = i / (N / 4), n4 = (i % (N / 4)) * 4;
    const int loc = s0 + r, pos = base + loc;
    st4(Cs + r * kCs + n4,
        loc < Q && pos < S ? ld4(Cb + (int64_t)pos * N + n4) : zero);
  }
  const int nkeys = min(s0 + kTile, Q);
  for (int kb0 = 0; kb0 < nkeys; kb0 += kb_cap) {
    const int kbn = min(kb_cap, nkeys - kb0);
    // C·Bᵀ of the block, once for every head of the group
    for (int kt = 0; kt < kbn; kt += kTile) {
      __syncthreads();  // Cs is written; U's readers are done
      for (int i = tid; i < kTile * N / 4; i += kOutThreads) {
        const int t = i / (N / 4), n4 = (i % (N / 4)) * 4;
        const int loc = kb0 + kt + t, pos = base + loc;
        st4(Bs + t * kCs + n4,
            loc < Q && pos < S ? ld4(Bb + (int64_t)pos * N + n4) : zero);
      }
      __syncthreads();
      float acc[NT][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {
        FragA fa;
        const float* cp = Cs + r0 * kCs + k0 + tg;
        fa.set(cp[0], cp[8 * kCs], cp[4], cp[8 * kCs + 4]);
        FragB fb[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp = Bs + (8 * j + g) * kCs + k0 + tg;
          fb[j].set(bp[0], bp[4]);
        }
        mma3(acc, fa, fb);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = kt + 8 * j + 2 * tg;
        *reinterpret_cast<float2*>(Gs + r0 * kGs + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(Gs + r1 * kGs + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }

    // The heads' work as one list of items, each a 64-column tile staged
    // in shared memory as TF32 parts: per head, the state entering chunk
    // c (N rows, kRows at a time; chunk 0 and later key blocks have
    // none), then the block's key tiles of x. The next item's tile, and
    // at a head's first item its cumsums, are loaded into registers
    // while the current item computes.
    constexpr int kRows = N < kTile ? N : kTile;
    const int n_state = kb0 == 0 && c > 0 ? N / kRows : 0;
    const int n_keyt = (kbn + kTile - 1) / kTile;
    const int per_head = n_state + n_keyt;
    const int n_items = (h1 - h0) * per_head;
    // keys of the block before the strip: their decays factor through
    // the strip's first row; the rest is the diagonal tile
    const int off_keys = min(kbn, s0 - kb0);
    constexpr int kPf = kTile * kP / 4 / kOutThreads;  // float4 per thread
    constexpr int kPa = (kTile + 2 * kKeyBlock + kOutThreads - 1) /
                        kOutThreads;                  // array entries
    float4 pf[kPf];
    double pa[kPa];
    double pm = 0.0;  // the head's m = cum at the strip's first row
    auto fetch = [&](int it) {
      const int h = h0 + it / per_head, k = it % per_head;
      if (k < n_state) {  // rows k·kRows.. of the state
        const float* sp = states +
                          (((int64_t)b * (nc - 1) + c - 1) * H + h) * N * kP +
                          k * kRows * kP;
#pragma unroll
        for (int u = 0; u < kPf; ++u) {
          const int i = tid + u * kOutThreads;
          const int t = i / (kP / 4), p4 = (i % (kP / 4)) * 4;
          pf[u] = t < kRows ? ld4(sp + t * kP + p4) : zero;
        }
      } else {  // keys kb0 + kt.. of x
        const int kt = (k - n_state) * kTile;
        const float* xh = x + ((int64_t)b * S * H + h) * kP;
#pragma unroll
        for (int u = 0; u < kPf; ++u) {
          const int i = tid + u * kOutThreads;
          const int t = i / (kP / 4), p4 = (i % (kP / 4)) * 4;
          const int loc = kb0 + kt + t, pos = base + loc;
          pf[u] = loc < Q && pos < S ? ld4(xh + pos * x_row + p4) : zero;
        }
      }
      if (k == 0) {  // the head's cumsums and dt
        const int64_t row = (((int64_t)b * nc + c) * H + h) * Q;
        pm = __ldg(cumq + row + s0);
#pragma unroll
        for (int u = 0; u < kPa; ++u) {
          const int i = tid + u * kOutThreads;
          double v = 0.0;
          if (i < kTile) {
            if (s0 + i < Q) v = __ldg(cumq + row + s0 + i);
          } else if (i < kTile + kbn) {
            v = __ldg(cumq + row + kb0 + i - kTile);
          } else if (i < kTile + 2 * kbn) {
            v = __ldg(dtq + row + kb0 + i - kTile - kbn);
          }
          pa[u] = v;
        }
      }
    };
    if (n_items > 0) fetch(0);
    float acc[NT][4];
    float* y0 = nullptr;
    float* y1 = nullptr;
    for (int it = 0; it < n_items; ++it) {
      const int h = h0 + it / per_head, k = it % per_head;
      __syncthreads();  // Gs is written; the staged tile's readers done
#pragma unroll
      for (int u = 0; u < kPf; ++u) {
        const int i = tid + u * kOutThreads;
        st_split4(xs, i / (kP / 4), (i % (kP / 4)) * 4, pf[u]);
      }
      if (k == 0) {
        // Off the diagonal (key t < s0 <= row s) the decay factors
        // through m = cum_{s0}: exp(cum_s - cum_t) = exp(cum_s - m) ·
        // exp(m - cum_t), both factors <= 1 (cum falls along the chunk),
        // each from the float64 cumsums: er per row, ekdt = exp(m -
        // cum_t) dt_t per key.
        const double m = pm;
#pragma unroll
        for (int u = 0; u < kPa; ++u) {
          const int i = tid + u * kOutThreads;
          if (i < kTile) {
            rowcum[i] = pa[u];
            er[i] = s0 + i < Q ? expf((float)(pa[u] - m)) : 0.f;
          } else if (i < kTile + kbn) {
            keycum[i - kTile] = pa[u];
          } else if (i < kTile + 2 * kbn) {
            keydt[i - kTile - kbn] = (float)pa[u];
          }
        }
        float* yh = y + ((int64_t)b * S * H + h) * kP;
        y0 = yh + (int64_t)(base + s0 + r0) * x_row;
        y1 = yh + (int64_t)(base + s0 + r1) * x_row;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        if (kb0 > 0) {  // this strip's sums over the earlier blocks
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = 8 * j + 2 * tg;
            if (v0) {
              const float2 o = *reinterpret_cast<const float2*>(y0 + col);
              acc[j][0] = o.x;
              acc[j][1] = o.y;
            }
            if (v1) {
              const float2 o = *reinterpret_cast<const float2*>(y1 + col);
              acc[j][2] = o.x;
              acc[j][3] = o.y;
            }
          }
        }
      }
      if (it + 1 < n_items) fetch(it + 1);
      __syncthreads();
      if (k == 0) {  // ekdt: exp(m - cum_t) times dt_t, now both are in
        for (int t = tid; t < off_keys; t += kOutThreads)
          ekdt[t] = expf((float)(rowcum[0] - keycum[t])) * keydt[t];
        __syncthreads();
      }
      if (k < n_state) {
        // exp(cum_s) C_s · state, rows k·kRows.. of the state
#pragma unroll
        for (int k0 = 0; k0 < kRows; k0 += 8) {
          FragA fa;
          const float* cp = Cs + r0 * kCs + k * kRows + k0 + tg;
          fa.set(cp[0], cp[8 * kCs], cp[4], cp[8 * kCs + 4]);
          FragB fb[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j)
            ld_fragb(fb[j], xs, k0, 8 * j, g, tg);
          mma3(acc, fa, fb);
        }
        if (k == n_state - 1) {
          const float e0 = expf((float)rowcum[r0]);
          const float e1 = expf((float)rowcum[r1]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[j][0] *= e0;
            acc[j][1] *= e0;
            acc[j][2] *= e1;
            acc[j][3] *= e1;
          }
        }
      } else {
        const int kt = (k - n_state) * kTile;
        if (kt < off_keys) {
          // a whole tile before the strip: W = (C·Bᵀ) er_s ekdt_t
          const float e0 = er[r0], e1 = er[r1];
#pragma unroll
          for (int k0 = 0; k0 < kTile; k0 += 8) {
            const int ka = kt + k0 + tg;
            const float* gp = Gs + r0 * kGs + ka;
            const float wa = ekdt[ka], wc = ekdt[ka + 4];
            FragA fa;
            fa.set(gp[0] * e0 * wa, gp[8 * kGs] * e1 * wa, gp[4] * e0 * wc,
                   gp[8 * kGs + 4] * e1 * wc);
            FragB fb[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j)
              ld_fragb(fb[j], xs, k0, 8 * j, g, tg);
            mma3(acc, fa, fb);
          }
        } else {
          // the diagonal tile: W = (C·Bᵀ) exp(cum_s - cum_t) dt_t,
          // t <= s, from the float64 cumsums; keys past the warp's last
          // row add nothing, so the warp stops at its own rows
          const int kend = min(min(kTile, kbn - kt), warp * 16 + 16);
          const double rc0 = rowcum[r0], rc1 = rowcum[r1];
          for (int k0 = 0; k0 < kend; k0 += 8) {
            const int ka = kt + k0 + tg, kc = ka + 4;  // block-local keys
            const float* gp = Gs + r0 * kGs + ka;
            const bool ka_in = ka < kbn, kc_in = kc < kbn;
            const double ca = ka_in ? keycum[ka] : 0.0;
            const double cc = kc_in ? keycum[kc] : 0.0;
            const float da = ka_in ? keydt[ka] : 0.f;
            const float dc = kc_in ? keydt[kc] : 0.f;
            const int ta = kb0 + ka - s0, tc = kb0 + kc - s0;
            FragA fa;
            fa.set(
                ta <= r0 ? gp[0] * __expf((float)(rc0 - ca)) * da : 0.f,
                ta <= r1 ? gp[8 * kGs] * __expf((float)(rc1 - ca)) * da
                         : 0.f,
                tc <= r0 ? gp[4] * __expf((float)(rc0 - cc)) * dc : 0.f,
                tc <= r1 ? gp[8 * kGs + 4] * __expf((float)(rc1 - cc)) * dc
                         : 0.f);
            FragB fb[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j)
              ld_fragb(fb[j], xs, k0, 8 * j, g, tg);
            mma3(acc, fa, fb);
          }
        }
      }
      if (k == per_head - 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * tg;
          if (v0)
            *reinterpret_cast<float2*>(y0 + col) =
                make_float2(acc[j][0], acc[j][1]);
          if (v1)
            *reinterpret_cast<float2*>(y1 + col) =
                make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
  }
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int N>
int launch(const float* x, const float* dt, const float* A_log,
           const float* B, const float* C, float* y, float* states,
           double* cumq, float* dtq, float* tot, int bsz, int S, int H,
           int Q, int group, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q, strips = (Q + kTile - 1) / kTile;
  const int groups = (H + group - 1) / group;
  const int kb_cap = min(kKeyBlock, strips * kTile);
  const size_t smem1 = state_smem_floats<N>(Q) * sizeof(float);
  int rc = allow_smem(chunk_state_kernel<N>, smem1);
  if (rc != 0) return rc;
  chunk_state_kernel<N><<<bsz * nc * H, kThreads, smem1, s>>>(
      x, dt, A_log, B, states, cumq, dtq, tot, S, H, Q, nc);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (nc > 1) {
    const int np4 = N * kP / 4;
    const int64_t n = (int64_t)bsz * H * np4;
    state_pass_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(states, tot,
                                                             bsz, H, np4, nc);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const size_t smem3 = out_smem_floats<N>(kb_cap) * sizeof(float);
  rc = allow_smem(chunk_out_kernel<N>, smem3);
  if (rc != 0) return rc;
  chunk_out_kernel<N><<<bsz * nc * strips * groups, kOutThreads, smem3,
                        s>>>(
      x, B, C, states, cumq, dtq, y, S, H, Q, nc, strips, group, groups,
      kb_cap);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// P must be 64; N 16, 32, 64 or 128; 1 <= Q <= 1024; 1 <= group <= H.
// Scratch from the caller: states (bsz, max(nc - 1, 1), H, N, P) float32,
// cumq (bsz, nc, H, Q) float64, dtq (bsz, nc, H, Q) and tot (bsz, nc, H)
// float32, nc = ceil(S / Q).
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A_log, const float* B,
                               const float* C, float* y, float* states,
                               double* cumq, float* dtq, float* tot, int bsz,
                               int S, int H, int P, int N, int Q, int group,
                               void* stream) {
  using namespace ssd;
  if (bsz < 1 || S < 1 || H < 1 || P != kP || Q < 1 || Q > kMaxChunk ||
      group < 1 || group > H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch<16>(x, dt, A_log, B, C, y, states, cumq, dtq, tot, bsz,
                        S, H, Q, group, s);
    case 32:
      return launch<32>(x, dt, A_log, B, C, y, states, cumq, dtq, tot, bsz,
                        S, H, Q, group, s);
    case 64:
      return launch<64>(x, dt, A_log, B, C, y, states, cumq, dtq, tot, bsz,
                        S, H, Q, group, s);
    case 128:
      return launch<128>(x, dt, A_log, B, C, y, states, cumq, dtq, tot, bsz,
                         S, H, Q, group, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
