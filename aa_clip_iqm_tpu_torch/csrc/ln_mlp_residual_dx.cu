// dx of the fused LayerNorm -> MLP -> residual for frozen parameters, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_mlp.py:
// ln_mlp_residual_frozen (backward) -> _bwd_dx_kernel (row tiles with both
// weight matrices resident in VMEM, hidden axis in chunks, transposed MXU
// products).
//
// What it computes, per row of x and g (M, d), for y = x + c_proj(act(c_fc(
// LN(x)))) with g = dL/dy:
//   mean, rstd, xn = (x - mean) rstd in fp32; xin = xn * ln_g + ln_b cast to
//   x's dtype; per hidden chunk
//     hid = xin . W_fc + b_fc           (fp32, recomputed: never stored)
//     da  = g . W_proj^T                (fp32)
//     dh  = da * act'(hid)              cast to x's dtype
//     du += dh . W_fc^T                 (fp32)
//   then the closed-form LayerNorm backward and the residual:
//     t = du * ln_g;  dx = (t - mean(t) - xn * mean(t * xn)) rstd + g.
// act' is the exact derivative: Phi(v) + v phi(v) with erff for GELU (the TPU
// kernel had an A&S erf polynomial), s + 1.702 v s (1 - s) for QuickGELU.
// W is stored (in, out); b_proj does not enter dx.
//
// What bounds it on the H100: at ViT-L/518 batch 8 (M = 10,960, d = 1024,
// h = 4096) the three products are 6*M*d*h = 2.76e11 FLOP (279 us at 989
// TFLOP/s dense bf16) against ~84 MB of x/g/dx/weight traffic (25 us at 3.35
// TB/s): compute-bound.
//
// What the design does about it: one thread block (8 warps) owns a tile of
// rows for the whole chain; neither the hidden tensor nor du reaches device
// memory. Two kernels:
//   - bf16 with d a multiple of 256 up to 1024 and h a multiple of 256: 32-row
//     tiles; the LayerNorm'd tile and the g tile sit in shared memory as A
//     operands; the fp32 du accumulator (32 x d) lives in registers for the
//     whole hidden loop; all three products are mma.sync m16n8k16 with
//     operands from ldmatrix. The weights stream through a ring of four
//     shared-memory slots with cp.async, 32 k-values a stage, in the
//     orientation each product needs and straight from the (in, out)
//     matrices: W_fc[k][cols] for hid (k-major stage, transposed ldmatrix),
//     W_proj[cols][k] for da and W_fc[cols][k] for du (n-major stages, plain
//     ldmatrix). In every stage a warp owns 32 of the stage's 256 output
//     columns, so du's columns are interleaved over the warps;
//   - anything else (fp32, other widths): 16-row tiles, 128-wide chunks, du in
//     shared memory and plain FMAs.
// Two resident A tiles leave room for 32-k stages only, and each block streams
// three weight passes (24 MB at ViT-L width) from L2 for 32 rows: about
// 8.2 GB a call. Not yet done: wgmma, TMA, sharing the stream across a
// cluster.

#include <math.h>

#include <type_traits>

#include "common.cuh"

using namespace aaclip;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// Derivative of the activation. 0: exact (erf) GELU; 1: QuickGELU.
template <int ACT>
__device__ __forceinline__ float dactivation(float v) {
  if (ACT == 0)
    return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
           v * 0.39894228040143268f * expf(-0.5f * v * v);
  const float s = 1.f / (1.f + expf(-1.702f * v));
  return s + v * 1.702f * s * (1.f - s);
}

// fp32 LayerNorm of rows [row0, row0 + rows) into shared memory (stride ld),
// cast to T, with the row's mean and rstd into stats[2r], stats[2r+1]; the g
// rows are copied beside them. Rows past M are zero. One warp per row.
template <typename T>
__device__ __forceinline__ void prepare_tiles(const T* __restrict__ x,
                                              const T* __restrict__ g,
                                              const float* __restrict__ ln_g,
                                              const float* __restrict__ ln_b,
                                              T* xin, T* gs, float* stats, int ld,
                                              int row0, int rows, int M, int d,
                                              float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NWARPS) {
    const int gr = row0 + r;
    T* dst = xin + r * ld;
    T* gdst = gs + r * ld;
    if (gr < M) {
      const T* src = x + (long)gr * d;
      const T* gsrc = g + (long)gr * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_float(src[c]);
      const float mean = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = to_float(src[c]) - mean;
        v += t * t;
      }
      const float rstd = rsqrtf(warp_sum(v) / d + eps);
      for (int c = lane; c < d; c += 32) {
        dst[c] = from_float<T>((to_float(src[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
        gdst[c] = gsrc[c];
      }
      if (lane == 0) {
        stats[2 * r] = mean;
        stats[2 * r + 1] = rstd;
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        dst[c] = from_float<T>(0.f);
        gdst[c] = from_float<T>(0.f);
      }
      if (lane == 0) {
        stats[2 * r] = 0.f;
        stats[2 * r + 1] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Generic kernel: any width with d % 16 == 0 and h % 128 == 0, plain FMAs.
// ---------------------------------------------------------------------------

constexpr int BM = 16;                 // rows per block
constexpr int CH = 128;                // hidden chunk width
constexpr int LDH = CH + 8;            // hidden chunk row stride

struct Smem {
  size_t du, xin, gs, dh, stats, bytes;
};

template <typename T>
__host__ __device__ Smem smem_layout(int d) {
  Smem s;
  s.du = 0;
  s.xin = s.du + round_up(sizeof(float) * BM * (d + 4), 128);
  s.gs = s.xin + round_up(sizeof(T) * BM * (d + 8), 128);
  s.dh = s.gs + round_up(sizeof(T) * BM * (d + 8), 128);
  s.stats = s.dh + round_up(sizeof(T) * BM * LDH, 128);
  s.bytes = s.stats + round_up(sizeof(float) * BM * 2, 128);
  return s;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_residual_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ ln_g,
                          const float* __restrict__ ln_b,
                          const T* __restrict__ w_fc, const float* __restrict__ b_fc,
                          const T* __restrict__ w_proj, T* __restrict__ dx, int M,
                          int d, int h, float eps) {
  const Smem lay = smem_layout<T>(d);
  extern __shared__ __align__(128) unsigned char smem[];
  float* du = reinterpret_cast<float*>(smem + lay.du);
  T* xin = reinterpret_cast<T*>(smem + lay.xin);
  T* gs = reinterpret_cast<T*>(smem + lay.gs);
  T* dh = reinterpret_cast<T*>(smem + lay.dh);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  const int ldu = d + 4, ldx = d + 8;
  const int row0 = blockIdx.x * BM;

  prepare_tiles(x, g, ln_g, ln_b, xin, gs, stats, ldx, row0, BM, M, d, eps);
  for (int i = threadIdx.x; i < BM * ldu; i += NTHREADS) du[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < h; j0 += CH) {
    // dh = (g . W_proj[chunk, :]^T) * act'(xin . W_fc[:, chunk] + b_fc)
    for (int i = threadIdx.x; i < BM * CH; i += NTHREADS) {
      const int r = i / CH, col = i % CH;
      float s = 0.f, a = 0.f;
      for (int k = 0; k < d; ++k) {
        s = fmaf(to_float(xin[r * ldx + k]), to_float(w_fc[(long)k * h + j0 + col]), s);
        a = fmaf(to_float(gs[r * ldx + k]), to_float(w_proj[(long)(j0 + col) * d + k]), a);
      }
      dh[r * LDH + col] = from_float<T>(a * dactivation<ACT>(s + b_fc[j0 + col]));
    }
    __syncthreads();
    // du += dh . W_fc[:, chunk]^T
    for (int i = threadIdx.x; i < BM * d; i += NTHREADS) {
      const int r = i / d, n = i % d;
      float s = du[r * ldu + n];
      for (int k = 0; k < CH; ++k)
        s = fmaf(to_float(dh[r * LDH + k]), to_float(w_fc[(long)n * h + j0 + k]), s);
      du[r * ldu + n] = s;
    }
    __syncthreads();
  }

  // LayerNorm backward and the residual, one warp per row.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NWARPS) {
    const int gr = row0 + r;
    if (gr >= M) continue;
    const float mean = stats[2 * r], rstd = stats[2 * r + 1];
    const T* src = x + (long)gr * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = du[r * ldu + c] * ln_g[c];
      s1 += t;
      s2 += t * ((to_float(src[c]) - mean) * rstd);
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float xn = (to_float(src[c]) - mean) * rstd;
      const float t = du[r * ldu + c] * ln_g[c];
      dx[(long)gr * d + c] =
          from_float<T>((t - m1 - xn * m2) * rstd + to_float(gs[r * ldx + c]));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, d % 256 == 0, d <= 1024, h % 256 == 0.
// ---------------------------------------------------------------------------

constexpr int TC_BM = 32;              // rows per block
constexpr int TC_CH = 256;             // hidden chunk width, and columns per stage
constexpr int KS = 32;                 // k-values per pipeline stage
constexpr int MAX_Q = 4;               // 256-column groups of d
constexpr int LDKN = TC_CH + 8;        // k-major stage row stride ([k][256 cols])
constexpr int LDNK = KS + 8;           // n-major stage row stride ([256 cols][k])
constexpr int TC_LDH = TC_CH + 8;      // bf16 dh chunk row stride
constexpr int SLOTS = 4;               // weight-stage ring: 3 loads in flight
constexpr int KSUB = TC_CH / KS;       // du stages per column group and chunk

struct TcSmem {
  size_t xin, gs, dh, ring, slot, stats, bytes;
};

__host__ __device__ inline TcSmem tc_layout(int d) {
  TcSmem s;
  s.xin = 0;
  s.gs = s.xin + round_up(sizeof(bf16) * TC_BM * (d + 8), 128);
  s.dh = s.gs + round_up(sizeof(bf16) * TC_BM * (d + 8), 128);
  s.ring = s.dh + round_up(sizeof(bf16) * TC_BM * TC_LDH, 128);
  const size_t kn = sizeof(bf16) * KS * LDKN, nk = sizeof(bf16) * TC_CH * LDNK;
  s.slot = round_up(kn > nk ? kn : nk, 128);
  s.stats = s.ring + SLOTS * s.slot;
  s.bytes = s.stats + round_up(sizeof(float) * TC_BM * 2, 128);
  return s;
}

// acc (32 rows x this warp's 32 columns) += A[:, 0:32] . stage, for a k-major
// stage [k][256 columns]: its transposed 8x8 matrices are the B operands.
__device__ __forceinline__ void mma_stage_kn(float (&acc)[2][4][4], const bf16* A,
                                             int lda, const bf16* buf, int warp) {
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    unsigned a[2][4], b[2][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
      ldsm_x4(a[rt], tile_lane_row(A + rt * 16 * lda + kk * 16, lda));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldsm_x4_t(b[j], tile_lane_row(buf + kk * 16 * LDKN + warp * 32 + j * 16, LDKN));
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma16816(acc[rt][2 * j], a[rt], b[j][0], b[j][1]);
        mma16816(acc[rt][2 * j + 1], a[rt], b[j][2], b[j][3]);
      }
  }
}

// The same for an n-major stage [256 columns][k]: its plain 8x8 matrices are
// the B operands; lane l addresses column (l % 8) + 8 (l / 16), k block
// (l / 8) % 2.
__device__ __forceinline__ void mma_stage_nk(float (&acc)[2][4][4], const bf16* A,
                                             int lda, const bf16* buf, int warp,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    unsigned a[2][4], b[2][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
      ldsm_x4(a[rt], tile_lane_row(A + rt * 16 * lda + kk * 16, lda));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldsm_x4(b[j], buf + (warp * 32 + j * 16 + lane % 8 + (lane / 16) * 8) * LDNK +
                        kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma16816(acc[rt][2 * j], a[rt], b[j][0], b[j][1]);
        mma16816(acc[rt][2 * j + 1], a[rt], b[j][2], b[j][3]);
      }
  }
}

// Per hidden chunk the weights stream as d/32 stages of W_proj (for da), d/32
// stages of W_fc (for hid), then (d/256) * 8 stages of W_fc in the other
// orientation (for du), through a ring of SLOTS slots: while stage t
// multiplies, stages t+1 .. t+3 load. One barrier per stage: after it, every
// warp is done with stage t-1, whose slot is the one refilled for stage t+3.
template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
ln_mlp_residual_dx_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                             const float* __restrict__ ln_g,
                             const float* __restrict__ ln_b,
                             const bf16* __restrict__ w_fc,
                             const float* __restrict__ b_fc,
                             const bf16* __restrict__ w_proj, bf16* __restrict__ dx,
                             int M, int d, int h, float eps) {
  const TcSmem lay = tc_layout(d);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = reinterpret_cast<bf16*>(smem + lay.xin);
  bf16* gs = reinterpret_cast<bf16*>(smem + lay.gs);
  bf16* dh = reinterpret_cast<bf16*>(smem + lay.dh);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  const int ldx = d + 8;
  const int row0 = blockIdx.x * TC_BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ns = d / KS;               // stages of da, and of hid, per chunk
  const int nq = d / TC_CH;            // 256-column groups of du
  const int per_chunk = 2 * ns + nq * KSUB;
  const int total = (h / TC_CH) * per_chunk;

  auto slot = [&](int t) {
    return reinterpret_cast<bf16*>(smem + lay.ring + (t % SLOTS) * lay.slot);
  };
  // Copy a [256 columns][32 k] block of a row-major matrix (n-major stage).
  auto load_nk = [&](bf16* dst, const bf16* src, long ld) {
    for (int i = threadIdx.x; i < TC_CH * (KS / 8); i += NTHREADS) {
      const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
      cp_async16(dst + r * LDNK + c, src + (long)r * ld + c);
    }
  };
  // Start loading stage t (if it exists); always commit, so that group
  // counts stay aligned with stage numbers.
  auto prefetch = [&](int t) {
    if (t < total) {
      const int j0 = (t / per_chunk) * TC_CH, s = t % per_chunk;
      bf16* dst = slot(t);
      if (s < ns) {
        // da: W_proj[j0 + col][s*32 + k]
        load_nk(dst, w_proj + (long)j0 * d + s * KS, d);
      } else if (s < 2 * ns) {
        // hid: W_fc[(s-ns)*32 + k][j0 + col]
        const bf16* src = w_fc + (long)((s - ns) * KS) * h + j0;
        for (int i = threadIdx.x; i < KS * (TC_CH / 8); i += NTHREADS) {
          const int r = i / (TC_CH / 8), c = (i % (TC_CH / 8)) * 8;
          cp_async16(dst + r * LDKN + c, src + (long)r * h + c);
        }
      } else {
        // du: W_fc[q*256 + col][j0 + ks*32 + k]
        const int u = s - 2 * ns, q = u / KSUB, ks = u % KSUB;
        load_nk(dst, w_fc + (long)(q * TC_CH) * h + j0 + ks * KS, h);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < SLOTS - 1; ++t) prefetch(t);
  prepare_tiles(x, g, ln_g, ln_b, xin, gs, stats, ldx, row0, TC_BM, M, d, eps);

  float du[MAX_Q][2][4][4];            // [column group][row tile][n8 tile][fragment]
  float hacc[2][4][4], dacc[2][4][4];  // hid and da: [row tile][n8 tile][fragment]
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q)
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) du[q][rt][n][i] = 0.f;

  for (int t = 0; t < total; ++t) {
    cp_async_wait<SLOTS - 2>();        // stage t has landed (this thread's part)
    __syncthreads();                   // ... everyone's part; stage t-1 is done
    prefetch(t + SLOTS - 1);             // into stage t-1's slot
    const bf16* buf = slot(t);
    const int j0 = (t / per_chunk) * TC_CH, s = t % per_chunk;
    if (s < ns) {
      if (s == 0) {
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) dacc[rt][n][i] = hacc[rt][n][i] = 0.f;
      }
      mma_stage_nk(dacc, gs + s * KS, ldx, buf, warp, lane);
    } else if (s < 2 * ns) {
      mma_stage_kn(hacc, xin + (s - ns) * KS, ldx, buf, warp);
      if (s == 2 * ns - 1) {
        // dh = da * act'(hid + b_fc), cast, for this warp's 32 hidden columns,
        // straight from the accumulators. The first du stage reads dh after
        // the next barrier.
#pragma unroll
        for (int rt = 0; rt < 2; ++rt)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = warp * 32 + n * 8 + 2 * tq;
            const float b0 = b_fc[j0 + col], b1 = b_fc[j0 + col + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = rt * 16 + gq + half * 8;
              *reinterpret_cast<__nv_bfloat162*>(dh + r * TC_LDH + col) =
                  __floats2bfloat162_rn(
                      dacc[rt][n][2 * half] * dactivation<ACT>(hacc[rt][n][2 * half] + b0),
                      dacc[rt][n][2 * half + 1] *
                          dactivation<ACT>(hacc[rt][n][2 * half + 1] + b1));
            }
          }
      }
    } else {
      const int u = s - 2 * ns, q = u / KSUB, ks = u % KSUB;
#pragma unroll
      for (int qq = 0; qq < MAX_Q; ++qq)
        if (qq == q) mma_stage_nk(du[qq], dh + ks * KS, TC_LDH, buf, warp, lane);
    }
  }
  cp_async_wait<0>();                  // only empty groups remain
  __syncthreads();                     // the ring is free: reuse it for the row sums

  // LayerNorm backward. This thread holds, for rows rt*16 + gq + half*8,
  // columns q*256 + warp*32 + n*8 + 2tq (+1) of du.
  float* red = reinterpret_cast<float*>(smem + lay.ring);   // [warp][row][2]
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    if (q < nq) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = q * TC_CH + warp * 32 + n * 8 + 2 * tq;
          const float g0 = ln_g[col], g1 = ln_g[col + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rt * 16 + gq + half * 8, gr = row0 + r;
            const float t0 = du[q][rt][n][2 * half] * g0;
            const float t1 = du[q][rt][n][2 * half + 1] * g1;
            du[q][rt][n][2 * half] = t0;
            du[q][rt][n][2 * half + 1] = t1;
            float2 xv = make_float2(0.f, 0.f);
            if (gr < M)
              xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + (long)gr * d + col));
            const float mean = stats[2 * r], rstd = stats[2 * r + 1];
            s1[rt * 2 + half] += t0 + t1;
            s2[rt * 2 + half] += t0 * ((xv.x - mean) * rstd) + t1 * ((xv.y - mean) * rstd);
          }
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 1);
    s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 2);
    s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 1);
    s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 2);
    if (tq == 0) {
      const int r = (i / 2) * 16 + gq + (i % 2) * 8;
      red[(warp * TC_BM + r) * 2] = s1[i];
      red[(warp * TC_BM + r) * 2 + 1] = s2[i];
    }
  }
  __syncthreads();
  float m1[4], m2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (i / 2) * 16 + gq + (i % 2) * 8;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      a += red[(w * TC_BM + r) * 2];
      b += red[(w * TC_BM + r) * 2 + 1];
    }
    m1[i] = a / d;
    m2[i] = b / d;
  }

  // dx = (t - m1 - xn * m2) * rstd + g in fp32, one cast.
#pragma unroll
  for (int q = 0; q < MAX_Q; ++q) {
    if (q < nq) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = q * TC_CH + warp * 32 + n * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rt * 16 + gq + half * 8, gr = row0 + r;
            if (gr < M) {
              const long off = (long)gr * d + col;
              const float mean = stats[2 * r], rstd = stats[2 * r + 1];
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(x + off));
              const float2 gv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(gs + r * ldx + col));
              const int i = rt * 2 + half;
              const float xn0 = (xv.x - mean) * rstd, xn1 = (xv.y - mean) * rstd;
              *reinterpret_cast<__nv_bfloat162*>(dx + off) = __floats2bfloat162_rn(
                  (du[q][rt][n][2 * half] - m1[i] - xn0 * m2[i]) * rstd + gv.x,
                  (du[q][rt][n][2 * half + 1] - m1[i] - xn1 * m2[i]) * rstd + gv.y);
            }
          }
        }
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, size_t smem, int grid,
                             cudaStream_t stream, Args... args) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch(const void* x, const void* g, const float* ln_g, const float* ln_b,
                   const void* w_fc, const float* b_fc, const void* w_proj, void* dx,
                   int M, int d, int h, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* wf = static_cast<const T*>(w_fc);
  const T* wp = static_cast<const T*>(w_proj);
  T* out = static_cast<T*>(dx);
  if constexpr (std::is_same<T, bf16>::value) {
    if (d % TC_CH == 0 && d <= TC_CH * MAX_Q && h % TC_CH == 0)
      return launch_with_smem(ln_mlp_residual_dx_tc_kernel<ACT>, tc_layout(d).bytes,
                              (M + TC_BM - 1) / TC_BM, stream, xt, gt, ln_g, ln_b, wf,
                              b_fc, wp, out, M, d, h, eps);
  }
  return launch_with_smem(ln_mlp_residual_dx_kernel<T, ACT>, smem_layout<T>(d).bytes,
                          (M + BM - 1) / BM, stream, xt, gt, ln_g, ln_b, wf, b_fc, wp,
                          out, M, d, h, eps);
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const void* g, const float* ln_g,
                         const float* ln_b, const void* w_fc, const float* b_fc,
                         const void* w_proj, void* dx, int M, int d, int h, float eps,
                         cudaStream_t stream) {
  if (act == 0)
    return launch<T, 0>(x, g, ln_g, ln_b, w_fc, b_fc, w_proj, dx, M, d, h, eps, stream);
  if (act == 1)
    return launch<T, 1>(x, g, ln_g, ln_b, w_fc, b_fc, w_proj, dx, M, d, h, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 = exact GELU, 1 = QuickGELU.
// LayerNorm scale/bias and b_fc are fp32; x, g, dx and the weights share
// dtype. Returns the launch's cudaError_t.
extern "C" int aaclip_ln_mlp_residual_dx(const void* x, const void* g, const void* ln_g,
                                         const void* ln_b, const void* w_fc,
                                         const void* b_fc, const void* w_proj, void* dx,
                                         int M, int d, int h, float eps, int act,
                                         int dtype, void* stream) {
  if (M <= 0 || d <= 0 || h <= 0 || d % 16 != 0 || h % CH != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(b_fc);
  if (dtype == 0)
    return dispatch_act<float>(act, x, g, lg, lb, w_fc, bf, w_proj, dx, M, d, h, eps, s);
  if (dtype == 1)
    return dispatch_act<bf16>(act, x, g, lg, lb, w_fc, bf, w_proj, dx, M, d, h, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* aaclip_ln_mlp_residual_dx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
