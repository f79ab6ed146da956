// Fused LayerNorm -> SwiGLU MLP with its sub-LN -> residual forward for
// Hopper (sm_90a): the MLP half of EVA-02's block.
//
// Replaces no TPU kernel: the JAX package has no EVA-02 tower. It is the
// EVA-02 counterpart of B2 (csrc/ln_mlp_residual.cu), which cannot take this
// MLP: B2 has one product into the hidden layer and one GELU, needs a hidden
// width that divides into 256-wide tiles, and has no reduction over the
// hidden layer's row between its two products.
//
// What it computes, per row of x (M, d), with h the hidden width:
//   u  = LN2(x), fp32 statistics, rounded to bf16;
//   g  = SiLU(u . W1 + b1) * (u . W2 + b2), fp32, rounded to bf16;
//   y  = x + LN_ffn(g) . W3 + b3, where LN_ffn normalises g over its h real
//        columns, in fp32, rounded once.
// The wrapper (ops/swiglu.py, which has the plain version of each stage)
// hands over the weights laid out once per weight tensor:
//   w12t (2 hp, d): [W1 | W2]^T, each padded with zero rows from h to hp, a
//        multiple of 128, and b12 (2 hp) with zeros there; the padded
//        columns of g are then exactly 0;
//   w3t (d, hp): W3'^T with W3' = diag(gamma) W3, zero past h; s3 = 1^T W3'
//        (fp32, from the bf16 W3'); b3' = b3 + beta . W3 (fp32),
// so that LN_ffn(g) . W3 + b3 = ((g . W3') - mu * s3) * rstd + b3' with
// mu and rstd the statistics of g's row. The hidden layer is written once
// and read once, and LN_ffn never makes a pass of its own.
//
// What bounds it on the H100: at EVA02-CLIP-L/518 batch 32 (M = 43,840,
// d = 1024, h = 2730) a call is 2 * M * 3 * d * h = 7.36e11 FLOP (0.744 ms
// at 989 TFLOP/s dense bf16) against 0.68 GB of x, weights, the hidden
// round trip and y (0.20 ms at 3.35 TB/s): compute-bound, so both products
// run on wgmma, as csrc/gemm_sm90.cuh's core does.
//
// What the design does. Three launches on one stream:
//   1. the core's LayerNorm pass, LN2(x) into the (M, d) scratch xin;
//   2. the dual product: 128 x 128 tiles of the hidden layer, each with two
//      accumulators (W1's columns and W2's) over one A box, so a stage of
//      the TMA ring holds one 128 x 64 box of u and two 128 x 64 K-major
//      weight boxes (48 KB; 4 stages). The epilogue forms g, rounds it,
//      stores it into the (M, hp) scratch hid, and sums each row's g and
//      g^2 over the tile's 128 columns (quad shuffles): one float2 per (row,
//      tile) into stats (M, hp / 128), so that no atomics make the sums'
//      order, and the result, vary from run to run;
//   3. the out product: hid . W3' on 128 x 256 tiles (128 where d allows no
//      256), K = hp. Before its products each consumer sums its two rows'
//      partials in tile order (the statistics over h, never hp), and the
//      epilogue writes x + ((acc - mu s3) * rstd + b3').
// Both products use the core's producer / two-consumer warpgroup split,
// 128-byte swizzle, descriptors and persistent tiles (gemm_sm90.cuh's
// header), with the weight read K-major.

#include <math.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

using gemm90::BK;
using gemm90::BM;

// Names the stage kernels after this source in a profiler.
struct ln_swiglu_residual_stage {};
// Names the LayerNorm pass when the block's other LayerNorms run it alone.
struct eva02_layer_norm {};

// The ring of a product with NW K-major weight operands over one A box:
// per stage an A box (BM x 64) and NW weight boxes (BN x 64), 1 KB aligned.
template <int BN, int NW>
struct Ring {
  static constexpr int W_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = gemm90::A_BOX + NW * W_BYTES;
  static constexpr int STAGES = 196608 / STAGE_BYTES;
  static constexpr int BARRIERS = STAGES * STAGE_BYTES;   // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BARRIERS + 2 * STAGES * 8 + 1024;
};

// The tiles t = blockIdx.x, + gridDim.x, ... of the (M / BM) x (N / BN)
// grid, N-tiles fastest: acc[o] = A . W_o for the weight rows n0 + o *
// w_offset .. + BN of the K-major w. Epi supplies:
//   Epi::Params, Epi::F (registers of its own),
//   Epi::begin(f, p, row0, M) at the tile's start, before its products;
//   Epi::finish(acc, f, p, row0, n0, tile_n, M) at its end.
// row0 is the thread's first row (m0 + 64 wg + 16 warp + lane / 4; it also
// holds row0 + 8); register 4i + 2h + e of acc[o] is row row0 + 8h, column
// n0 + 8i + 2 (lane % 4) + e. Rows past M read as zero (TMA).
template <int BN, int NW, class Epi>
__device__ __forceinline__ void product_tiles(const CUtensorMap& map_a, const CUtensorMap& map_w,
                                      const typename Epi::Params& p, int M, int N, int K,
                                      int w_offset) {
  using R = Ring<BN, NW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BARRIERS);
  uint64_t* empty = full + R::STAGES;
  auto stage_a = [&](int s) { return smem + s * R::STAGE_BYTES; };
  auto stage_w = [&](int s, int o) { return stage_a(s) + gemm90::A_BOX + o * R::W_BYTES; };

  const int n_tiles = N / BN, tiles = n_tiles * ((M + BM - 1) / BM);
  const int nk = K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      gemm90::mbar_init(&full[s], 1);
      gemm90::mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % R::STAGES;
          gemm90::mbar_wait(&empty[s], ((it / R::STAGES) & 1) ^ 1);
          gemm90::mbar_expect_tx(&full[s], R::STAGE_BYTES);
          gemm90::tma_load(stage_a(s), map_a, &full[s], kt * BK, m0);
#pragma unroll
          for (int o = 0; o < NW; ++o)
            gemm90::tma_load(stage_w(s, o), map_w, &full[s], kt * BK, n0 + o * w_offset);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const bool leader = threadIdx.x % 128 == 0;
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * BM, tile_n = t % n_tiles, n0 = tile_n * BN;
      const int row0 = m0 + wg * 64 + (threadIdx.x % 128 / 32) * 16 + lane / 4;
      float f[Epi::F];
      Epi::begin(f, p, row0, M);
      float acc[NW][BN / 2];
#pragma unroll
      for (int o = 0; o < NW; ++o) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[o][i] = 0.f;
        gemm90::fence_regs(acc[o]);
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % R::STAGES;
        gemm90::mbar_wait(&full[s], (it / R::STAGES) & 1);
        const unsigned char* a = stage_a(s) + wg * 64 * 128;
        gemm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int o = 0; o < NW; ++o)
            gemm90::wgmma_bf16<BN, 0>(acc[o], gemm90::smem_desc(a + kk * 32, 16, 1024),
                                      gemm90::smem_desc(stage_w(s, o) + kk * 32, 16, 1024));
        gemm90::wgmma_commit();
        // The products of the previous k-slice are done: hand its slot back.
        gemm90::wgmma_wait<1>();
        if (kt > 0 && leader) gemm90::mbar_arrive(&empty[(it - 1) % R::STAGES]);
      }
      gemm90::wgmma_wait<0>();
#pragma unroll
      for (int o = 0; o < NW; ++o) gemm90::fence_regs(acc[o]);
      if (leader) gemm90::mbar_arrive(&empty[(it - 1) % R::STAGES]);
      Epi::finish(acc, f, p, row0, n0, tile_n, M);
    }
  }
}

// v * sigmoid(v); the quotient by the fast reciprocal path (its divisor
// is never beyond 2^126 but as +inf, where the quotient is the exact 0).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + expf(-v)); }

// Eight bf16 at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = v[e];
}

// Row h of the thread's two (row0 + 8h) in group j of 32 columns: the four
// column pairs of acc that the quad holds, traded (gemm90::quad_transpose)
// so that the lane holds the 8 columns n0 + 8 (4j + lane % 4) .. + 7.
template <int R>
__device__ __forceinline__ void columns8(const float (&acc)[R], int j, int h, float (&out)[8]) {
  float2 v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    v[t] = make_float2(acc[4 * (4 * j + t) + 2 * h], acc[4 * (4 * j + t) + 2 * h + 1]);
  gemm90::quad_transpose(v);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    out[2 * t] = v[t].x;
    out[2 * t + 1] = v[t].y;
  }
}

// The dual product's epilogue: g = SiLU(acc0 + b1) * (acc1 + b2) rounded
// into hid, and each row's sum and sum of squares of the rounded g over the
// tile's columns into stats[row * n_stats + tile_n].
struct SwigluParams {
  const float* b12;                    // (2 hp): b1 then b2, zero past h
  bf16* hid;                           // (M, hp)
  float2* stats;                       // (M, n_stats)
  int hp, n_stats;
};

template <int BN>
struct SwigluEpi {
  using Params = SwigluParams;
  static constexpr int F = 1;
  static __device__ __forceinline__ void begin(float (&)[F], const Params&, int, int) {}
  static __device__ __forceinline__ void finish(float (&acc)[2][BN / 2], float (&)[F],
                                                const Params& p, int row0, int n0, int tile_n,
                                                int M) {
    const int q = threadIdx.x % 4;
    float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = n0 + 8 * (4 * j + q);
      float b1[8], b2[8];
      load8(p.b12 + col, b1);
      load8(p.b12 + p.hp + col, b2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float u1[8], u2[8];
        columns8(acc[0], j, h, u1);
        columns8(acc[1], j, h, u2);
        uint4 packed;
        unsigned* pw = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pw[e] = pack_bf16x2(silu(u1[2 * e] + b1[2 * e]) * (u2[2 * e] + b2[2 * e]),
                              silu(u1[2 * e + 1] + b1[2 * e + 1]) * (u2[2 * e + 1] + b2[2 * e + 1]));
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pw[e]));
          sum[h] += g.x + g.y;
          sq[h] += g.x * g.x + g.y * g.y;
        }
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<uint4*>(p.hid + (long)row * p.hp + col) = packed;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], o);
      }
      const int row = row0 + 8 * h;
      if (q == 0 && row < M) p.stats[(long)row * p.n_stats + tile_n] = make_float2(sum[h], sq[h]);
    }
  }
};

// The out product's epilogue: y = x + ((acc - mu s3) * rstd + b3'), one
// rounding; begin() takes each of the thread's rows' mu and rstd from the
// partial sums (f = {mu0, rstd0, mu1, rstd1}).
struct OutParams {
  const float2* stats;                 // (M, n_stats)
  const float* s3;                     // (d)
  const float* b3;                     // (d): b3'
  const bf16* x;                       // (M, d), the residual
  bf16* y;                             // (M, d)
  int d, n_stats;
  float inv_h, eps;
};

template <int BN>
struct OutEpi {
  using Params = OutParams;
  static constexpr int F = 4;
  static __device__ __forceinline__ void begin(float (&f)[F], const Params& p, int row0, int M) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float sum = 0.f, sq = 0.f;
      if (row < M)
        for (int t = 0; t < p.n_stats; ++t) {
          const float2 v = p.stats[(long)row * p.n_stats + t];
          sum += v.x;
          sq += v.y;
        }
      const float mu = sum * p.inv_h;
      f[2 * h] = mu;
      f[2 * h + 1] = rsqrtf(fmaxf(sq * p.inv_h - mu * mu, 0.f) + p.eps);
    }
  }
  static __device__ __forceinline__ void finish(float (&acc)[1][BN / 2], float (&f)[F],
                                                const Params& p, int row0, int n0, int, int M) {
    const int q = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = n0 + 8 * (4 * j + q);
      float s3[8], b3[8];
      load8(p.s3 + col, s3);
      load8(p.b3 + col, b3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8];
        columns8(acc[0], j, h, v);
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float r[8];
        load8(p.x + (long)row * p.d + col, r);
        uint4 packed;
        unsigned* pw = reinterpret_cast<unsigned*>(&packed);
        const float mu = f[2 * h], rstd = f[2 * h + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[e] = pack_bf16x2(r[2 * e] + ((v[2 * e] - mu * s3[2 * e]) * rstd + b3[2 * e]),
                              r[2 * e + 1] +
                                  ((v[2 * e + 1] - mu * s3[2 * e + 1]) * rstd + b3[2 * e + 1]));
        *reinterpret_cast<uint4*>(p.y + (long)row * p.d + col) = packed;
      }
    }
  }
};

constexpr int DUAL_BN = 128;

template <class Tag>
__global__ void __launch_bounds__(gemm90::THREADS, 1)
swiglu_dual_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const SwigluParams p, int M,
                   int d) {
  product_tiles<DUAL_BN, 2, SwigluEpi<DUAL_BN>>(map_a, map_w, p, M, p.hp, d, p.hp);
}

template <class Tag, int BN>
__global__ void __launch_bounds__(gemm90::THREADS, 1)
swiglu_out_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const OutParams p, int M,
                  int hp) {
  product_tiles<BN, 1, OutEpi<BN>>(map_a, map_w, p, M, p.d, hp, 0);
}

// One persistent launch of a product: at most one block per SM.
template <int BN, int NW, typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, const bf16* a, int K, const bf16* w, int w_rows,
                   const Params& p, int M, int N, cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  int dev = 0, sms = 0;
  cudaError_t err = gemm90::tensor_map(&map_a, a, M, K, K, BM);
  if (err == cudaSuccess) err = gemm90::tensor_map(&map_w, w, w_rows, K, K, BN);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = gemm90::set_smem(kernel, Ring<BN, NW>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = N / BN * ((M + BM - 1) / BM);
  kernel<<<std::min(tiles, sms), gemm90::THREADS, Ring<BN, NW>::SMEM, stream>>>(map_a, map_w, p,
                                                                                M, K);
  return cudaGetLastError();
}

}  // namespace

// x, y (M, d) bf16; ln_g, ln_b (d) fp32 (LN2, eps); w12t (2 hp, d) bf16, b12
// (2 hp) fp32; w3t (d, hp) bf16, s3 and b3 (d) fp32 (the wrapper's layout,
// above; eps_ffn is LN_ffn's); the caller's scratch xin (M, d) and hid (M,
// hp) bf16 and stats (M, hp / 128) float2. d a multiple of 128, hp of 128,
// 0 < h <= hp; every pointer 16-byte aligned. Returns the first failing
// launch's cudaError_t.
extern "C" int aaclip_ln_swiglu_residual(const void* x, const void* ln_g, const void* ln_b,
                                         const void* w12t, const void* b12, const void* w3t,
                                         const void* s3, const void* b3, void* xin, void* hid,
                                         void* stats, void* y, int M, int d, int h, int hp,
                                         float eps, float eps_ffn, void* stream) {
  using Tag = ln_swiglu_residual_stage;
  const void* ptrs[] = {x, ln_g, ln_b, w12t, b12, w3t, s3, b3, xin, hid, stats, y};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || gemm90::misaligned(ptr)) return cudaErrorInvalidValue;
  if (M <= 0 || d <= 0 || d % 128 || hp <= 0 || hp % DUAL_BN || h <= 0 || h > hp ||
      (long)hp / DUAL_BN * ((M + BM - 1) / BM) > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* u = static_cast<bf16*>(xin);
  bf16* g = static_cast<bf16*>(hid);
  float2* st = static_cast<float2*>(stats);
  const int n_stats = hp / DUAL_BN;
  cudaError_t err = gemm90::layer_norm_rows<Tag>(xb, static_cast<const float*>(ln_g),
                                                 static_cast<const float*>(ln_b), u, d, M, d,
                                                 eps, s);
  if (err != cudaSuccess) return err;
  const SwigluParams pd{static_cast<const float*>(b12), g, st, hp, n_stats};
  err = launch<DUAL_BN, 2>(swiglu_dual_kernel<Tag>, u, d, static_cast<const bf16*>(w12t), 2 * hp,
                           pd, M, hp, s);
  if (err != cudaSuccess) return err;
  const OutParams po{st, static_cast<const float*>(s3), static_cast<const float*>(b3), xb,
                          static_cast<bf16*>(y), d, n_stats, 1.f / h, eps_ffn};
  const bf16* w3 = static_cast<const bf16*>(w3t);
  if (d % 256 == 0) return launch<256, 1>(swiglu_out_kernel<Tag, 256>, g, hp, w3, d, po, M, d, s);
  return launch<128, 1>(swiglu_out_kernel<Tag, 128>, g, hp, w3, d, po, M, d, s);
}

// The LayerNorm pass alone (the block's LN1 and attention sub-LN): y (M, d)
// bf16 = LayerNorm(x (M, d) bf16) with fp32 statistics, g and b (d) fp32,
// one rounding. d a multiple of 8; pointers 16-byte aligned.
extern "C" int aaclip_ln_swiglu_residual_layer_norm(const void* x, const void* g,
                                                    const void* b, void* y, int M, int d,
                                                    float eps, void* stream) {
  if (M <= 0 || d <= 0 || gemm90::misaligned(x) || gemm90::misaligned(y)) return cudaErrorInvalidValue;
  return gemm90::layer_norm_rows<eva02_layer_norm>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(y), d, M, d, eps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* aaclip_ln_swiglu_residual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
