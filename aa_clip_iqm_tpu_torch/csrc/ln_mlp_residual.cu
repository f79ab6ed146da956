// Fused LayerNorm -> MLP -> residual forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_mlp.py:
// ln_mlp_residual -> _kernel (row tiles with both weight matrices resident in
// VMEM, hidden axis in chunks).
//
// What it computes, per row of x (M, d):
//   xin = LayerNorm(x) in fp32, cast to x's dtype;
//   hid = act(xin . W_fc + b_fc) in fp32 (exact erf GELU, QuickGELU or the
//         tanh GELU), cast to x's dtype;
//   y   = x + hid . W_proj + b_proj in fp32, cast once.
// W is stored (in, out). GELU is the exact erff (the TPU kernel used an A&S
// erf polynomial because Mosaic has no erf; the XLA chain it stands for is
// exact).
//
// What bounds it on the H100: at ViT-L/518 batch 8 (M = 10,960, d = 1024,
// h = 4096) a layer is 4*M*d*h = 1.84e11 FLOP (186 us at 989 TFLOP/s dense
// bf16) against ~61 MB of x/y/weight traffic (18 us at 3.35 TB/s):
// compute-bound.
//
// What the design does about it. The TPU kernel keeps a row tile's fp32
// (rows x d) output accumulator in VMEM over the whole hidden loop; on this
// card a 128-row tile of it would take 512 KB of registers against the SM's
// 256 KB, and the 32-row tile that fits makes every block stream both
// weights from L2. So the hidden layer goes through device memory and both
// products run on the wgmma GEMM core (csrc/gemm_sm90.cuh), three launches
// on one stream for bf16 with d % 128 == 0 and h % 256 == 0 (both CLIP
// towers):
//   1. the LayerNorm pass: LN(x) rounded to bf16 into the (M, d) scratch xin,
//      the TPU kernel's xin;
//   2. GEMM 1, xin . W_fc with epilogue (a): act(acc + b_fc) rounded to bf16
//      into the (M, h) scratch hid, the TPU kernel's hid.astype(xin.dtype);
//   3. GEMM 2, hid . W_proj with epilogue (b): x + (acc + b_proj), the whole
//      K = h accumulated in fp32 before the one rounding, as the TPU
//      kernel's acc.
// The hidden layer's round trip (2 * M * h * 2 bytes, 180 MB at batch 8) is
// the price; it lies under the products. Anything else (fp32, other widths):
// a generic kernel with 16-row tiles, 128-wide chunks, the accumulator in
// shared memory and plain FMAs.

#include <math.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// 0: exact (erf) GELU; 1: QuickGELU x * sigmoid(1.702 x); 3: the tanh GELU
// (the core's numbering, gemm90::ACT_*).
template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (ACT == 3) return gemm90::activation<gemm90::ACT_GELU_TANH>(v);
  return v / (1.f + expf(-1.702f * v));
}

// fp32 LayerNorm of rows [row0, row0 + rows) into shared memory (stride ld),
// cast to T; rows past M are zero. One warp per row.
template <typename T>
__device__ __forceinline__ void layer_norm_tile(const T* __restrict__ x,
                                                const float* __restrict__ ln_g,
                                                const float* __restrict__ ln_b,
                                                T* xin, int ld, int row0,
                                                int rows, int M, int d,
                                                float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NWARPS) {
    const int gr = row0 + r;
    T* dst = xin + r * ld;
    if (gr < M) {
      const T* src = x + (long)gr * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_float(src[c]);
      const float mean = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = to_float(src[c]) - mean;
        v += t * t;
      }
      const float rstd = rsqrtf(warp_sum(v) / d + eps);
      for (int c = lane; c < d; c += 32)
        dst[c] = from_float<T>((to_float(src[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = from_float<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Generic kernel: any width with d % 16 == 0 and h % 128 == 0, plain FMAs.
// ---------------------------------------------------------------------------

constexpr int BM = 16;                 // rows per block
constexpr int CH = 128;                // hidden chunk width
constexpr int LDHT = CH + 8;           // hidden chunk row stride

struct Smem {
  size_t acc, xin, hidt, bytes;
};

template <typename T>
__host__ __device__ Smem smem_layout(int d) {
  Smem s;
  s.acc = 0;
  s.xin = s.acc + round_up(sizeof(float) * BM * (d + 4), 128);
  s.hidt = s.xin + round_up(sizeof(T) * BM * (d + 8), 128);
  s.bytes = s.hidt + round_up(sizeof(T) * BM * LDHT, 128);
  return s;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
ln_mlp_residual_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                       const float* __restrict__ ln_b,
                       const T* __restrict__ w_fc,
                       const float* __restrict__ b_fc,
                       const T* __restrict__ w_proj,
                       const float* __restrict__ b_proj, T* __restrict__ y,
                       int M, int d, int h, float eps) {
  const Smem lay = smem_layout<T>(d);
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  T* xin = reinterpret_cast<T*>(smem + lay.xin);
  T* hidt = reinterpret_cast<T*>(smem + lay.hidt);
  const int lda = d + 4, ldx = d + 8;
  const int row0 = blockIdx.x * BM;

  layer_norm_tile(x, ln_g, ln_b, xin, ldx, row0, BM, M, d, eps);
  for (int i = threadIdx.x; i < BM * lda; i += NTHREADS) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < h; j0 += CH) {
    // hid = act(xin . W_fc[:, j0:j0+CH] + b_fc), cast to the input dtype.
    for (int i = threadIdx.x; i < BM * CH; i += NTHREADS) {
      const int r = i / CH, col = i % CH;
      float s = 0.f;
      for (int k = 0; k < d; ++k)
        s = fmaf(to_float(xin[r * ldx + k]), to_float(w_fc[(long)k * h + j0 + col]), s);
      hidt[r * LDHT + col] = from_float<T>(activation<ACT>(s + b_fc[j0 + col]));
    }
    __syncthreads();

    // acc += hid . W_proj[j0:j0+CH, :]
    for (int i = threadIdx.x; i < BM * d; i += NTHREADS) {
      const int r = i / d, n = i % d;
      float s = acc[r * lda + n];
      for (int k = 0; k < CH; ++k)
        s = fmaf(to_float(hidt[r * LDHT + k]), to_float(w_proj[(long)(j0 + k) * d + n]), s);
      acc[r * lda + n] = s;
    }
    __syncthreads();
  }

  // y = x + acc + b_proj in fp32, one cast.
  for (int i = threadIdx.x; i < BM * d; i += NTHREADS) {
    const int r = i / d, c = i % d, gr = row0 + r;
    if (gr < M) {
      const long off = (long)gr * d + c;
      y[off] = from_float<T>(to_float(x[off]) + acc[r * lda + c] + b_proj[c]);
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
cudaError_t launch(const void* x, const float* ln_g, const float* ln_b,
                   const void* w_fc, const float* b_fc, const void* w_proj,
                   const float* b_proj, void* y, int M, int d, int h, float eps,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wf = static_cast<const T*>(w_fc);
  const T* wp = static_cast<const T*>(w_proj);
  T* yt = static_cast<T*>(y);
  return launch_with_smem(ln_mlp_residual_kernel<T, ACT>,
                          smem_layout<T>(d).bytes, (M + BM - 1) / BM, stream,
                          xt, ln_g, ln_b, wf, b_fc, wp, b_proj, yt, M, d, h, eps);
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const float* ln_g,
                         const float* ln_b, const void* w_fc, const float* b_fc,
                         const void* w_proj, const float* b_proj, void* y, int M,
                         int d, int h, float eps, cudaStream_t stream) {
  if (act == 0)
    return launch<T, 0>(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, y, M, d,
                            h, eps, stream);
  if (act == 1)
    return launch<T, 1>(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, y, M, d,
                            h, eps, stream);
  if (act == 3)
    return launch<T, 3>(x, ln_g, ln_b, w_fc, b_fc, w_proj, b_proj, y, M, d,
                            h, eps, stream);
  return cudaErrorInvalidValue;
}

// Names the stage kernels after this source, so that a profiler tells them
// from B8's (csrc/ln_attn_residual.cu builds the same core).
struct ln_mlp_residual_stage {};

// The bf16 path: the LayerNorm pass and the two GEMMs, their tiles in bands
// of group1 and group2 M-tiles; xin (M, d) and hid (M, h) are the caller's
// bf16 scratch.
cudaError_t launch_gemm_path(const bf16* x, const float* ln_g, const float* ln_b,
                             const bf16* w_fc, const float* b_fc, const bf16* w_proj,
                             const float* b_proj, bf16* xin, bf16* hid, bf16* y, int M, int d,
                             int h, float eps, int act, int group1, int group2, cudaStream_t s) {
  using Tag = ln_mlp_residual_stage;
  cudaError_t err = gemm90::layer_norm_rows<Tag>(x, ln_g, ln_b, xin, d, M, d, eps, s);
  if (err == cudaSuccess)
    err = gemm90::gemm<Tag>(xin, d, w_fc, h, b_fc, nullptr, 0, hid, h, M, h, d, act, 0, group1,
                            s);
  if (err == cudaSuccess)
    err = gemm90::gemm<Tag>(hid, h, w_proj, d, b_proj, x, d, y, d, M, d, h, act, 0, group2, s);
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 = exact GELU, 1 = QuickGELU,
// 3 = the tanh GELU.
// LayerNorm scale/bias and both biases are fp32; x, y and weights share dtype.
// bf16 with d % 128 == 0 and h % 256 == 0 takes the GEMM path and needs the
// bf16 scratch xin (M, d) and hid (M, h), its GEMMs' tiles in bands of
// group1 and group2 M-tiles; anything else ignores them. Returns the first
// failing launch's cudaError_t.
extern "C" int aaclip_ln_mlp_residual(const void* x, const void* ln_g,
                                      const void* ln_b, const void* w_fc,
                                      const void* b_fc, const void* w_proj,
                                      const void* b_proj, void* xin, void* hid,
                                      void* y, int M, int d, int h, float eps,
                                      int act, int dtype, int group1, int group2,
                                      void* stream) {
  if (M <= 0 || d <= 0 || h <= 0 || d % 16 != 0 || h % CH != 0 ||
      (act != 0 && act != 1 && act != 3))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* bf = static_cast<const float*>(b_fc);
  const float* bp = static_cast<const float*>(b_proj);
  if (dtype == 1 && d % 128 == 0 && h % 256 == 0) {
    if (xin == nullptr || hid == nullptr) return cudaErrorInvalidValue;
    return launch_gemm_path(static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(w_fc),
                            bf, static_cast<const bf16*>(w_proj), bp, static_cast<bf16*>(xin),
                            static_cast<bf16*>(hid), static_cast<bf16*>(y), M, d, h, eps, act,
                            group1, group2, s);
  }
  if (dtype == 0)
    return dispatch_act<float>(act, x, g, b, w_fc, bf, w_proj, bp, y, M, d,
                                   h, eps, s);
  if (dtype == 1)
    return dispatch_act<bf16>(act, x, g, b, w_fc, bf, w_proj, bp,
                                           y, M, d, h, eps, s);
  return cudaErrorInvalidValue;
}

// One product of the GEMM core alone (csrc/gemm_sm90.cuh): out (M, N) =
// act(a . w + bias) (act 0 GELU, 1 QuickGELU, 2 none, 3 the tanh GELU) or, where res is
// given, res + (a . w + bias); row strides lda, ldw, ld_res, ld_out; tile_n
// 0 (the core's choice), 128 or 256; tiles in bands of `group` M-tiles.
// bf16 operands, fp32 bias.
extern "C" int aaclip_ln_mlp_residual_gemm(const void* a, int lda, const void* w, int ldw,
                                           const void* bias, const void* res, int ld_res,
                                           void* out, int ld_out, int M, int N, int K, int act,
                                           int tile_n, int group, void* stream) {
  return gemm90::gemm<ln_mlp_residual_stage>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(w), ldw,
      static_cast<const float*>(bias), static_cast<const bf16*>(res), ld_res,
      static_cast<bf16*>(out), ld_out, M, N, K, act, tile_n, group,
      static_cast<cudaStream_t>(stream));
}

namespace {

// Floats whose bit patterns are base + i, i < n: the GEMM core's erf and
// exact GELU against the same through CUDA's erff; each float at which
// either differs (one NaN against another counts as equal) adds 1 to *count.
__global__ void gelu_check_kernel(unsigned base, unsigned n, unsigned long long* count) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = __uint_as_float(base + i);
  const float e0 = erff(a), e1 = gemm90::erf_exact(a);
  const float g0 = 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
  const float g1 = gemm90::activation<gemm90::ACT_GELU>(a);
  auto same = [](float x, float y) {
    return __float_as_uint(x) == __float_as_uint(y) || (x != x && y != y);
  };
  if (!same(e0, e1) || !same(g0, g1)) atomicAdd(count, 1ull);
}

}  // namespace

// The count of floats (bit patterns base .. base + n - 1, n <= 2^31) at
// which the core's exact GELU or its erf differ from CUDA's erff, added to
// count (device, one unsigned 64-bit integer).
extern "C" int aaclip_ln_mlp_residual_gelu_check(long base, long n, void* count, void* stream) {
  if (base < 0 || n <= 0 || n > (1L << 31) || base + n > (1L << 32)) return cudaErrorInvalidValue;
  gelu_check_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (unsigned)base, (unsigned)n, static_cast<unsigned long long*>(count));
  return cudaGetLastError();
}

extern "C" const char* aaclip_ln_mlp_residual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
