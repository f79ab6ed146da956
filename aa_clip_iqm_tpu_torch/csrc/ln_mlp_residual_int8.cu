// Fused LayerNorm -> int8 MLP -> residual forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_mlp.py:
// ln_mlp_residual_int8 -> _int8_kernel (row tiles with both int8 weight
// matrices resident in VMEM, hidden axis in chunks, int8 x int8 -> int32
// products).
//
// What it computes, per row of x (M, d), with CH the hidden chunk width:
//   xin = LayerNorm(x) in fp32 (kept in fp32);
//   sx  = max(amax |xin|, 1e-6) * (1/127);  x_q = clip(rint(xin / sx), +-127);
//   for each chunk j of CH hidden units:
//     hid = act(int32(x_q . Wfc_q[:, j]) * (sx * s_fc[j]) + b_fc[j])   (fp32)
//     sh  = max(amax |hid|, 1e-6) * (1/127) over this chunk only;
//     h_q = clip(rint(hid / sh), +-127);
//     acc += float(int32(h_q . Wp_q[j, :])) * sh;
//   y = x + acc * s_proj + b_proj in fp32, cast once to bf16.
// The chunk width is part of the numerics (one hidden scale per row and
// chunk). rint is round-half-to-even, the scales divide (the correctly
// rounded quotient, from the row's reciprocal and two fma corrections:
// gemm90::div_rn), and every fp32 epilogue multiplies and adds in separate
// roundings, in the order of the plain PyTorch twin, so that the two differ
// only by the order of the LayerNorm's fp32 sums. GELU is the exact erff.
//
// What bounds it on the H100: at ViT-L/518 batch 8 (M = 10,960, d = 1024,
// h = 4096) a layer is 4*M*d*h = 1.84e11 int8 operations (93 us at
// 1979 TOP/s dense int8) against ~53 MB of x/y/weight traffic (16 us at
// 3.35 TB/s): operation-bound, so the products must run on int8 wgmma.
//
// What the design does about it. The TPU kernel keeps a row tile's whole
// chain in VMEM; on this card a tile that holds its fp32 output accumulator
// in registers is 16 rows, and every such tile streams both weights from L2
// (2.4 ms a call at ViT-L/518 batch 8 on an H100, 26 times the bound). So
// the chain runs as three stages on the int8 form of the wgmma GEMM core
// (csrc/gemm_sm90.cuh: persistent blocks, a producer warp feeding a TMA
// ring, consumer warpgroups on wgmma m64nNk32 s8), with the quantized
// operands in device memory:
//   1. ln_quant_rows: xin, sx and x_q (M, d) int8; it also zeroes the chunk
//      maxima amax (M, h / CH) and GEMM 1's counters. xin is recomputed from
//      the row (in L1) between the sweep that takes its maximum and the
//      sweep that quantizes, with one explicit fma, so both see the same
//      values and no register array caps d;
//   2. GEMM 1 (hidden_epilogue): x_q . Wfc^T in 192 x 128 tiles on three
//      consumer warpgroups, hid = act(u) on the s32 accumulator, and h_q (M,
//      h) int8 with sh (M, h / CH). A chunk spans CH / 128 tiles that
//      different blocks own, and h_q needs the chunk's maximum: the tiles
//      exchange their row maxima through amax and a counter per (row block,
//      chunk) in one cooperative launch (see hidden_epilogue), hid waiting
//      in the accumulator's registers. On an H100 this one pass beat two
//      launches (the maxima, then the products again and h_q; PERF.md);
//      spilling hid in fp32 instead would move 180 MB at batch 8
//      (about 107 us at 3.35 TB/s) through a buffer of that size;
//   3. GEMM 2 (proj_epilogue): h_q . Wp^T over K = h, 128 x 128 tiles on two
//      consumer warpgroups. After each chunk's k-slices the s32 accumulator
//      is folded into an fp32 one, f = f + float(acc) * sh[row, chunk] (sh
//      loaded a chunk ahead), and the next chunk restarts it with scale-d =
//      0; then y = (x + f * s_proj) + b_proj, one rounding. The two
//      accumulators take 64 registers each.
// |acc| <= 1024 * 127^2 < 2^24 within a chunk, so float(acc) is exact there.
// The weights are read K-major, (out, in): the wrapper lays them out once
// per weight tensor. What holds it now: GEMM 1's epilogue (the exact-erf
// activation and the quantizer on 45M elements a call, on the consumer warps
// while the tensor cores wait) and its wait for the chunk's slowest tile.
// Not yet done: the next tile's products under that wait (a second
// accumulator), ping-pong consumers, TMA multicast of the shared operand.
//
// The same source carries B9, the int8 probe's kernel: it replaces
// tools/probe_mlp_int8_sweep.py: make_fused -> _kernel_var (pl.pallas_call
// at :92), the sweep's variants of _int8_kernel. It is this three-stage
// chain with three differences, each a template or run-time argument here:
//   - the activation is code 2, GELU on Abramowitz-Stegun 7.1.26 with a
//     compare-free sign, erf(x) ~ x / (|x| + 1e-3) * (1 - poly(k) e^(-x^2)),
//     k = 1 / (1 + p |x|); that factor is not +-1 near 0 and is part of the
//     numerics, so it must not become copysign;
//   - with ep_bf16 the pre-activation t is rounded to bf16 and the whole
//     GELU runs on bf16 values: every operation rounds to bf16, each
//     constant rounded to bf16 first (JAX's weak-typed scalars on a bf16
//     array), in the plain version's order;
//   - the chunk width ch is 1024 or 2048. At 2048 a chunk spans 16 of GEMM
//     1's 128-wide tiles: the cooperative grid holds whole groups of 16
//     (128 blocks on 132 SMs), the counters' target doubles, and GEMM 2's
//     s32 chunk sums may pass 2^24, where float(acc) rounds to nearest as
//     the plain version's int32 -> float32 cast does.
// Its stages carry their own tag (ln_mlp_residual_int8_probe_stage), so
// that a profiler tells them from B3's. Bound: 4 M d h int8 operations, as
// B3's (0.191 ms a layer at the probe's M = 22528, 0.0929 ms at M = 10,960,
// at 1979 TOP/s).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;
using gemm90::INV127;
using gemm90::quantize_s8;

namespace {

// Names the stage kernels after this source, so that a profiler tells them
// from B2's, which build the same core.
struct ln_mlp_residual_int8_stage {};
struct ln_mlp_residual_int8_probe_stage {};

// What the stages read and write.
struct Int8Params {
  const float* sx;                     // (M) row scales of x_q
  const float* s_fc;                   // (h) c_fc weight scales
  const float* b_fc;                   // (h)
  float* amax;                         // (M, nch) chunk maxima of |hid|
  float* sh;                           // (M, nch) hidden scales
  int* count;                          // (m-tiles of GEMM 1, nch) warps done with a chunk
  int8_t* h_q;                         // (M, h)
  const float* s_proj;                 // (d) c_proj weight scales
  const float* b_proj;                 // (d)
  const bf16* x;                       // (M, d), the residual
  bf16* y;                             // (M, d)
  int h, d, ch, nch;
};

// v rounded to bf16 and back (round to nearest even).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// B9's GELU, 0.5 t (1 + erf(t / sqrt 2)) with erf on Abramowitz-Stegun
// 7.1.26 and the compare-free sign x / (|x| + 1e-3), one rounding per
// operation in the plain version's order (fused_mlp.gelu_nocmp): in fp32,
// or with BF16 every result and constant rounded to bf16 (R).
template <bool BF16>
__device__ __forceinline__ float gelu_nocmp(float t) {
  auto R = [](float v) { return BF16 ? bf16_round(v) : v; };
  const float x = R(__fmul_rn(t, R(0.70710678118654752f)));
  const float ax = fabsf(x);
  const float k = R(__fdiv_rn(1.f, R(__fadd_rn(1.f, R(__fmul_rn(R(0.3275911f), ax))))));
  float p = R(__fmul_rn(k, R(1.061405429f)));
  p = R(__fmul_rn(k, R(__fadd_rn(R(-1.453152027f), p))));
  p = R(__fmul_rn(k, R(__fadd_rn(R(1.421413741f), p))));
  p = R(__fmul_rn(k, R(__fadd_rn(R(-0.284496736f), p))));
  p = R(__fmul_rn(k, R(__fadd_rn(R(0.254829592f), p))));
  const float e = R(expf(R(__fmul_rn(-ax, ax))));
  const float y = R(__fsub_rn(1.f, R(__fmul_rn(p, e))));
  const float sign = R(__fdiv_rn(x, R(__fadd_rn(ax, R(1e-3f)))));
  const float erf = R(__fmul_rn(sign, y));
  return R(__fmul_rn(R(__fmul_rn(0.5f, t)), R(__fadd_rn(1.f, erf))));
}

// 0: exact (erf) GELU; 1: QuickGELU x * sigmoid(1.702 x), the sigmoid as
// 1 / (1 + exp(-t)); 2: B9's compare-free GELU, with EP_BF16 on the
// pre-activation rounded to bf16.
template <int ACT, bool EP_BF16 = false>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (ACT == 2) return gelu_nocmp<EP_BF16>(EP_BF16 ? bf16_round(v) : v);
  return v * (1.f / (1.f + expf(-(1.702f * v))));
}

__device__ __forceinline__ void load8(float (&out)[8], const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// GEMM 1's epilogue on the s32 accumulator of a BN-wide tile (which lies in
// one chunk): hid = act(u), u = float(acc) * (sx * s_fc) + b_fc. preact
// gives the u of the eight columns col .. col + 7 (col = n0 + 32 j + 8 (lane
// % 4)) of row row0 + 8 hh that the lane holds after its quad's exchange.
template <int BN>
__device__ __forceinline__ void preact(const int (&acc)[BN / 2], int j, int hh, float sx,
                                       const float (&sf)[8], const float (&bf)[8],
                                       float (&u)[8]) {
  float2 v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    v[t] = make_float2((float)acc[4 * (4 * j + t) + 2 * hh],
                       (float)acc[4 * (4 * j + t) + 2 * hh + 1]);
  gemm90::quad_transpose(v);
  const float a[8] = {v[0].x, v[0].y, v[1].x, v[1].y, v[2].x, v[2].y, v[3].x, v[3].y};
#pragma unroll
  for (int e = 0; e < 8; ++e) u[e] = __fadd_rn(__fmul_rn(a[e], __fmul_rn(sx, sf[e])), bf[e]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float ld_acquire(const float* p) {
  float v;
  asm volatile("ld.acquire.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// GEMM 1 in one pass. A chunk's CH / 128 tiles of a row block belong to
// consecutive tile numbers, so different blocks of one round of the
// persistent grid hold them at the same time (the launch is cooperative:
// all blocks resident). Each tile computes hid = act(u) into its
// accumulator's registers, takes each row's maximum of |hid| over its
// columns into amax[row, chunk] (atomicMax on the fp32 bits, non-negative so
// an unsigned compare orders them), and counts its warps as done on the
// chunk's counter; it then waits for the counter to reach every warp of the
// chunk's tiles, reads the chunk's maxima, and quantizes its hid from the
// registers: h_q = clip(rint(hid / sh), +-127), sh = max(amax, 1e-6) / 127,
// which the chunk's first tile also writes. A tile waits only on tiles of
// its own chunk, which are numbered no later than one round on, so the
// lowest chunk not yet done always completes. A wait that outlasts 2^26
// polls (far beyond any tile) traps rather than hang.
template <int BN, int ACT, bool EP_BF16 = false>
struct hidden_epilogue {
  using Params = Int8Params;
  static constexpr int F = 1;

  static __device__ __forceinline__ void fold(int (&)[BN / 2], float (&)[F], const Params&, int,
                                              int, int, int) {}

  static __device__ __forceinline__ void begin(float (&)[F], const Params&, int, int, int) {}

  static __device__ __forceinline__ void finish(int (&acc)[BN / 2], float (&)[F], const Params& p,
                                                int row0, int n0, int M) {
    const int q = threadIdx.x % 4, lane = threadIdx.x % 32;
    const int chunk = n0 / p.ch;
    float sx[2], amax[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sx[hh] = row0 + 8 * hh < M ? p.sx[row0 + 8 * hh] : 0.f;
    // hid in place of the accumulator: register 4 (4j + t) + 2hh + e now
    // holds column n0 + 32j + 8q + 2t + e of row row0 + 8hh.
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      float sf[8], bf[8];
      load8(sf, p.s_fc + n0 + 32 * j + 8 * q);
      load8(bf, p.b_fc + n0 + 32 * j + 8 * q);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float u[8];
        preact<BN>(acc, j, hh, sx[hh], sf, bf, u);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float h0 = activation<ACT, EP_BF16>(u[2 * t]);
          const float h1 = activation<ACT, EP_BF16>(u[2 * t + 1]);
          amax[hh] = fmaxf(amax[hh], fmaxf(fabsf(h0), fabsf(h1)));
          acc[4 * (4 * j + t) + 2 * hh] = __float_as_int(h0);
          acc[4 * (4 * j + t) + 2 * hh + 1] = __float_as_int(h1);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float a = quad_max(amax[hh]);
      const int row = row0 + 8 * hh;
      if (q == 0 && row < M)
        atomicMax(reinterpret_cast<unsigned*>(p.amax) + (long)row * p.nch + chunk,
                  __float_as_uint(a));
    }
    // This warp's maxima are out: count it, then wait for the chunk's other
    // warps (consumer warps per tile: (blockDim.x - 128) / 32).
    const int bm = (blockDim.x - 128) / 2;
    int* count = p.count + (long)(row0 / bm) * p.nch + chunk;
    const int target = p.ch / BN * ((blockDim.x - 128) / 32);
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      __threadfence();
      atomicAdd(count, 1);
      for (int polls = 0; ld_acquire(count) < target; ++polls) {
        if (polls == (1 << 26)) __trap();
        __nanosleep(32);
      }
    }
    __syncwarp();
    float sh[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      sh[hh] = row < M ? fmaxf(ld_acquire(p.amax + (long)row * p.nch + chunk), 1e-6f) * INV127
                       : 1.f;
      inv[hh] = __frcp_rn(sh[hh]);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = n0 + 32 * j + 8 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        int r[8];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          r[2 * t] = quantize_s8(__int_as_float(acc[4 * (4 * j + t) + 2 * hh]), sh[hh], inv[hh]);
          r[2 * t + 1] =
              quantize_s8(__int_as_float(acc[4 * (4 * j + t) + 2 * hh + 1]), sh[hh], inv[hh]);
        }
        if (row < M)
          *reinterpret_cast<uint2*>(p.h_q + (long)row * p.h + col) =
              make_uint2(gemm90::pack_s8x4(r[0], r[1], r[2], r[3]),
                         gemm90::pack_s8x4(r[4], r[5], r[6], r[7]));
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (q == 0 && row0 + 8 * hh < M && n0 % p.ch == 0)
        p.sh[(long)(row0 + 8 * hh) * p.nch + chunk] = sh[hh];
  }
};

// GEMM 2's epilogue: the chunk fold into f, then the residual.
template <int BN>
struct proj_epilogue {
  using Params = Int8Params;
  // f, then the sh of both rows for the chunk to fold next, loaded one chunk
  // ahead so that a fold never waits for it.
  static constexpr int F = BN / 2 + 2;

  static __device__ __forceinline__ void load_sh(float (&f)[F], const Params& p, int row0,
                                                 int chunk, int M) {
    f[BN / 2] = row0 < M ? p.sh[(long)row0 * p.nch + chunk] : 0.f;
    f[BN / 2 + 1] = row0 + 8 < M ? p.sh[(long)(row0 + 8) * p.nch + chunk] : 0.f;
  }

  // Chunk 0's sh; the lines of s_proj and b_proj towards L1 and the tile's
  // rows of x (BN / 64 lines each) towards L2.
  static __device__ __forceinline__ void begin(float (&f)[F], const Params& p, int row0, int n0,
                                               int M) {
    load_sh(f, p, row0, 0, M);
    const int i = threadIdx.x % 128, q = threadIdx.x % 4;
    if (i < BN / 32) gemm90::prefetch_l1(p.s_proj + n0 + 32 * i);
    else if (i < BN / 16) gemm90::prefetch_l1(p.b_proj + n0 + 32 * (i - BN / 32));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (q < BN / 64 && row0 + 8 * hh < M)
        gemm90::prefetch_l2(p.x + (long)(row0 + 8 * hh) * p.d + n0 + 64 * q);
  }

  static __device__ __forceinline__ void fold(int (&acc)[BN / 2], float (&f)[F], const Params& p,
                                              int row0, int n0, int chunk, int M) {
    const float sh0 = f[BN / 2], sh1 = f[BN / 2 + 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      f[i] = __fadd_rn(f[i], __fmul_rn((float)acc[i], i & 2 ? sh1 : sh0));
    if (chunk + 1 < p.nch) load_sh(f, p, row0, chunk + 1, M);
  }

  static __device__ __forceinline__ void finish(int (&)[BN / 2], float (&f)[F], const Params& p,
                                                int row0, int n0, int M) {
    const int q = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = n0 + 32 * j + 8 * q;
      float sp[8], bp[8];
      load8(sp, p.s_proj + col);
      load8(bp, p.b_proj + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = make_float2(f[4 * (4 * j + t) + 2 * hh], f[4 * (4 * j + t) + 2 * hh + 1]);
        gemm90::quad_transpose(v);
        const int row = row0 + 8 * hh;
        if (row >= M) continue;
        const float acc[8] = {v[0].x, v[0].y, v[1].x, v[1].y, v[2].x, v[2].y, v[3].x, v[3].y};
        const long off = (long)row * p.d + col;
        const uint4 xr = *reinterpret_cast<const uint4*>(p.x + off);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
        uint4 packed;
        unsigned* pw = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xv[e]);
          pw[e] = pack_bf16x2(
              __fadd_rn(__fadd_rn(xf.x, __fmul_rn(acc[2 * e], sp[2 * e])), bp[2 * e]),
              __fadd_rn(__fadd_rn(xf.y, __fmul_rn(acc[2 * e + 1], sp[2 * e + 1])), bp[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(p.y + off) = packed;
      }
    }
  }
};

using Tag = ln_mlp_residual_int8_stage;

// GEMM 1: 192 x 128 tiles on three consumer warpgroups (its epilogue, not
// the products, takes most of the time, and three warpgroups holding half
// the accumulator of two at 128 x 256 get through it faster), in one
// cooperative launch of whole chunks of tiles.
constexpr int FC_BM = 192;

template <int ACT, bool EP_BF16 = false, class T = Tag>
cudaError_t hidden_pass(const int8_t* xq, const int8_t* wfc_t, const Int8Params& p, int M,
                        cudaStream_t s) {
  return gemm90::launch_gemm_s8<T, 128, FC_BM / 64, hidden_epilogue<128, ACT, EP_BF16>>(
      xq, p.d, wfc_t, p.d, p, M, p.h, p.d, p.d / gemm90::BK8, s, p.ch / 128);
}

// The three stages for the entries below: T tags the stage kernels, hidden
// runs GEMM 1 (hidden_pass with the activation chosen).
template <class T, class Hidden>
cudaError_t run_chain(const void* x, const void* ln_g, const void* ln_b, const void* wfc_t,
                      const void* s_fc, const void* b_fc, const void* wp_t, const void* s_proj,
                      const void* b_proj, void* xq, void* sx, void* amax, void* sh, void* count,
                      void* hq, void* y, int M, int d, int h, int ch, float eps, cudaStream_t s,
                      Hidden hidden) {
  const Int8Params p{static_cast<const float*>(sx),     static_cast<const float*>(s_fc),
                     static_cast<const float*>(b_fc),   static_cast<float*>(amax),
                     static_cast<float*>(sh),           static_cast<int*>(count),
                     static_cast<int8_t*>(hq),          static_cast<const float*>(s_proj),
                     static_cast<const float*>(b_proj), static_cast<const bf16*>(x),
                     static_cast<bf16*>(y),             h, d, ch, h / ch};
  cudaError_t err = gemm90::ln_quant_rows<T>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq), static_cast<float*>(sx),
      static_cast<float*>(amax), h / ch, static_cast<int*>(count),
      (M + FC_BM - 1) / FC_BM * (h / ch), M, d, eps, s);
  if (err == cudaSuccess)
    err = hidden(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wfc_t), p);
  if (err == cudaSuccess)
    err = gemm90::launch_gemm_s8<T, 128, 2, proj_epilogue<128>>(
        static_cast<const int8_t*>(hq), h, static_cast<const int8_t*>(wp_t), h, p, M, d, h,
        ch / gemm90::BK8, s);
  return err;
}

}  // namespace

// x, y: (M, d) bf16. wfc_t: (h, d) int8, the c_fc weight transposed; wp_t:
// (d, h) int8, the c_proj weight transposed. LayerNorm scale/bias, the
// per-output-channel weight scales and both biases are fp32. The caller's
// scratch: xq (M, d) int8, sx (M) fp32, amax and sh (M, h / ch) fp32, count
// (ceil(M / 192), h / ch) int32, hq (M, h) int8. ch: the hidden chunk width (128, 256, 512 or 1024, dividing
// h). act: 0 = exact GELU, 1 = QuickGELU. d must be a multiple of 128; every
// pointer 16-byte aligned. Returns the first failing launch's cudaError_t.
extern "C" int aaclip_ln_mlp_residual_int8(
    const void* x, const void* ln_g, const void* ln_b, const void* wfc_t, const void* s_fc,
    const void* b_fc, const void* wp_t, const void* s_proj, const void* b_proj, void* xq,
    void* sx, void* amax, void* sh, void* count, void* hq, void* y, int M, int d, int h, int ch,
    float eps, int act, void* stream) {
  if (M <= 0 || d <= 0 || d % 128 != 0 || act < 0 || act > 1) return cudaErrorInvalidValue;
  if ((ch != 128 && ch != 256 && ch != 512 && ch != 1024) || h <= 0 || h % ch != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_chain<Tag>(x, ln_g, ln_b, wfc_t, s_fc, b_fc, wp_t, s_proj, b_proj, xq, sx, amax, sh,
                        count, hq, y, M, d, h, ch, eps, s,
                        [&](const int8_t* xq8, const int8_t* wf, const Int8Params& p) {
                          return act == 0 ? hidden_pass<0>(xq8, wf, p, M, s)
                                          : hidden_pass<1>(xq8, wf, p, M, s);
                        });
}

// B9, the int8 probe's kernel: the chain above with the compare-free GELU
// (activation 2), its epilogue in fp32 or, with ep_bf16, on bf16 values,
// and a hidden chunk ch of 1024 or 2048. Operands, scratch and alignment as
// for aaclip_ln_mlp_residual_int8; amax, sh and count sized for this ch.
extern "C" int aaclip_ln_mlp_residual_int8_probe(
    const void* x, const void* ln_g, const void* ln_b, const void* wfc_t, const void* s_fc,
    const void* b_fc, const void* wp_t, const void* s_proj, const void* b_proj, void* xq,
    void* sx, void* amax, void* sh, void* count, void* hq, void* y, int M, int d, int h, int ch,
    float eps, int ep_bf16, void* stream) {
  if (M <= 0 || d <= 0 || d % 128 != 0 || (ch != 1024 && ch != 2048) || h <= 0 || h % ch != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using T = ln_mlp_residual_int8_probe_stage;
  return run_chain<T>(x, ln_g, ln_b, wfc_t, s_fc, b_fc, wp_t, s_proj, b_proj, xq, sx, amax, sh,
                      count, hq, y, M, d, h, ch, eps, s,
                      [&](const int8_t* xq8, const int8_t* wf, const Int8Params& p) {
                        return ep_bf16 ? hidden_pass<2, true, T>(xq8, wf, p, M, s)
                                       : hidden_pass<2, false, T>(xq8, wf, p, M, s);
                      });
}

extern "C" const char* aaclip_ln_mlp_residual_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
