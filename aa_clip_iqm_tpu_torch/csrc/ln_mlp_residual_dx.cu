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
//   x's dtype;
//     hid = xin . W_fc + b_fc           (fp32, recomputed: never rounded)
//     da  = g . W_proj^T                (fp32)
//     dh  = da * act'(hid)              cast to x's dtype
//     du  = dh . W_fc^T                 (fp32, never rounded)
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
// What the design does about it. The TPU kernel keeps a row tile's fp32 du
// (rows x d) in VMEM across the hidden loop; on this card a 128-row tile of
// it is 512 KB against the SM's 256 KB of registers, and the 32-row tiles
// that fit made every block stream all three weight passes from L2 (about
// 8.2 GB a call). So dh and du go through device memory and the products run
// on the wgmma GEMM core (csrc/gemm_sm90.cuh), four launches on one stream
// for bf16 with d and h multiples of 128 (both CLIP towers):
//   1. the core's LayerNorm pass: xin (M, d) bf16, the TPU kernel's xin;
//   2. the dual mode over (M, h) tiles of 128 x 128: two fp32 accumulators
//      over K = d, xin . W_fc (W_fc read N-major) and g . W_proj^T (W_proj
//      (h, d) read K-major), and the epilogue dh = da * act'(hid + b_fc)
//      rounded once into the (M, h) scratch dh: hid is never rounded;
//   3. du = dh . W_fc^T over K = h (W_fc read K-major), stored as t = du *
//      ln_g in fp32 into the (M, d) scratch t: du is never rounded;
//   4. a row pass: mean and rstd of x again, the two row means of t and
//      t * xn, and dx, rounded once.
// The scratch round trips (dh 180 MB, t 90 MB at batch 8) lie under the
// products. Anything else (fp32, other widths): a generic kernel with 16-row
// tiles, 128-wide chunks, du in shared memory and plain FMAs.

#include <math.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

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
      dh[r * LDH + col] = from_float<T>(a * gemm90::dactivation<ACT>(s + b_fc[j0 + col]));
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
// The bf16 path on the GEMM core.
// ---------------------------------------------------------------------------

// Names the stage kernels after this source, so that a profiler tells them
// from B2's and B8's (the same core).
struct ln_mlp_residual_dx_stage {};

// Row r: mean and rstd of x (two passes, as the LayerNorm pass), then
// dx = (t - mean(t) - xn mean(t xn)) rstd + g rounded once, t = du * ln_g
// the fp32 scratch. One warp per row, 8 columns a lane at a time; d % 8 == 0.
template <class Tag>
__global__ void __launch_bounds__(gemm90::LN_WARPS * 32)
ln_dx_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ t,
                  const bf16* __restrict__ g, bf16* __restrict__ dx, int M, int d, float eps) {
  const int row = blockIdx.x * gemm90::LN_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (long)row * d;
  const float* tr = t + (long)row * d;
  auto load8 = [](const bf16* p, float (&f)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 p2 = __bfloat1622float2(v[e]);
      f[2 * e] = p2.x;
      f[2 * e + 1] = p2.y;
    }
  };
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) q += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    load8(xr + c, f);
    const float4 t0 = *reinterpret_cast<const float4*>(tr + c);
    const float4 t1 = *reinterpret_cast<const float4*>(tr + c + 4);
    const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1 += tv[e];
      s2 += tv[e] * ((f[e] - mean) * rstd);
    }
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8], gv[8];
    load8(xr + c, f);
    load8(g + (long)row * d + c, gv);
    const float4 t0 = *reinterpret_cast<const float4*>(tr + c);
    const float4 t1 = *reinterpret_cast<const float4*>(tr + c + 4);
    const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    uint4 packed;
    unsigned* pw = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xn0 = (f[2 * e] - mean) * rstd, xn1 = (f[2 * e + 1] - mean) * rstd;
      pw[e] = pack_bf16x2((tv[2 * e] - m1 - xn0 * m2) * rstd + gv[2 * e],
                          (tv[2 * e + 1] - m1 - xn1 * m2) * rstd + gv[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(dx + (long)row * d + c) = packed;
  }
}

// The four stages, the two products' tiles in bands of group1 and group2
// M-tiles; xin (M, d) bf16, dh (M, h) bf16 and t (M, d) fp32 are the
// caller's scratch.
cudaError_t launch_gemm_path(const bf16* x, const bf16* g, const float* ln_g, const float* ln_b,
                             const bf16* w_fc, const float* b_fc, const bf16* w_proj, bf16* xin,
                             bf16* dh, float* t, bf16* dx, int M, int d, int h, float eps,
                             int act, int group1, int group2, cudaStream_t s) {
  using Tag = ln_mlp_residual_dx_stage;
  cudaError_t err = gemm90::layer_norm_rows<Tag>(x, ln_g, ln_b, xin, d, M, d, eps, s);
  if (err == cudaSuccess)
    err = gemm90::gemm_dual_dact<Tag>(xin, d, w_fc, h, b_fc, g, d, w_proj, d, dh, h, M, h, d,
                                      act, group1, s);
  if (err == cudaSuccess)
    err = gemm90::gemm_f32<Tag>(dh, h, w_fc, h, 1, ln_g, t, d, M, d, h, 0, group2, s);
  if (err != cudaSuccess) return err;
  ln_dx_rows_kernel<Tag><<<(M + gemm90::LN_WARPS - 1) / gemm90::LN_WARPS, gemm90::LN_WARPS * 32, 0,
                      s>>>(x, t, g, dx, M, d, eps);
  return cudaGetLastError();
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
  return launch_with_smem(ln_mlp_residual_dx_kernel<T, ACT>, smem_layout<T>(d).bytes,
                          (M + BM - 1) / BM, stream, static_cast<const T*>(x),
                          static_cast<const T*>(g), ln_g, ln_b, static_cast<const T*>(w_fc),
                          b_fc, static_cast<const T*>(w_proj), static_cast<T*>(dx), M, d, h,
                          eps);
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
// dtype. bf16 with d and h multiples of 128 takes the GEMM path and needs
// the scratch xin (M, d) bf16, dh (M, h) bf16 and t (M, d) fp32, its two
// products' tiles in bands of group1 and group2 M-tiles; anything else
// ignores them. Returns the first failing launch's cudaError_t.
extern "C" int aaclip_ln_mlp_residual_dx(const void* x, const void* g, const void* ln_g,
                                         const void* ln_b, const void* w_fc,
                                         const void* b_fc, const void* w_proj, void* xin,
                                         void* dh, void* t, void* dx, int M, int d, int h,
                                         float eps, int act, int dtype, int group1, int group2,
                                         void* stream) {
  if (M <= 0 || d <= 0 || h <= 0 || d % 16 != 0 || h % CH != 0 || act < 0 || act > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(b_fc);
  if (dtype == 1 && d % 128 == 0 && h % 128 == 0) {
    if (xin == nullptr || dh == nullptr || t == nullptr) return cudaErrorInvalidValue;
    return launch_gemm_path(static_cast<const bf16*>(x), static_cast<const bf16*>(g), lg, lb,
                            static_cast<const bf16*>(w_fc), bf, static_cast<const bf16*>(w_proj),
                            static_cast<bf16*>(xin), static_cast<bf16*>(dh),
                            static_cast<float*>(t), static_cast<bf16*>(dx), M, d, h, eps, act,
                            group1, group2, s);
  }
  if (dtype == 0)
    return dispatch_act<float>(act, x, g, lg, lb, w_fc, bf, w_proj, dx, M, d, h, eps, s);
  if (dtype == 1)
    return dispatch_act<bf16>(act, x, g, lg, lb, w_fc, bf, w_proj, dx, M, d, h, eps, s);
  return cudaErrorInvalidValue;
}

// The core's two modes that B5 adds, alone (csrc/gemm_sm90.cuh), bf16
// operands: out32 (M, N) fp32 = (a . W) * scale (scale may be null), W = w
// (K, N) or with w_kmajor w (N, K); tile_n 0, 128 or 256; tiles in bands of
// `group` M-tiles.
extern "C" int aaclip_ln_mlp_residual_dx_gemm_f32(const void* a, int lda, const void* w, int ldw,
                                                  int w_kmajor, const void* scale, void* out32,
                                                  int ld_out, int M, int N, int K, int tile_n,
                                                  int group, void* stream) {
  return gemm90::gemm_f32<ln_mlp_residual_dx_stage>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(w), ldw, w_kmajor,
      static_cast<const float*>(scale), static_cast<float*>(out32), ld_out, M, N, K, tile_n,
      group, static_cast<cudaStream_t>(stream));
}

// ... and the dual mode: out (M, N) bf16 = (a2 . w2^T) * act'(a . w + bias),
// w (K, N), w2 (N, K); act 0 GELU, 1 QuickGELU; tiles in bands of `group`
// M-tiles.
extern "C" int aaclip_ln_mlp_residual_dx_gemm_dual(const void* a, int lda, const void* w,
                                                   int ldw, const void* bias, const void* a2,
                                                   int lda2, const void* w2, int ldw2, void* out,
                                                   int ld_out, int M, int N, int K, int act,
                                                   int group, void* stream) {
  return gemm90::gemm_dual_dact<ln_mlp_residual_dx_stage>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(w), ldw,
      static_cast<const float*>(bias), static_cast<const bf16*>(a2), lda2,
      static_cast<const bf16*>(w2), ldw2, static_cast<bf16*>(out), ld_out, M, N, K, act, group,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* aaclip_ln_mlp_residual_dx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
