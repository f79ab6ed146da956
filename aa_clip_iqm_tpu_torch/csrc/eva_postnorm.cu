// The post-norm EVA block's kernels for Hopper (sm_90a): EVA02-CLIP-E/14+'s
// vision blocks, x = x + LN1(attn(x)) then x = x + LN2(MLP(x)).
//
// No TPU kernel stands behind them: the JAX package has no EVA tower.
//
// What the block computes (models/clip.py, _run_eva_postnorm_block), per
// row of x (M, d) bf16:
//   qkv = x . W_qkv + [q_b | 0 | v_b]            (rounded once to bf16)
//   o   = attention of the heads of qkv           (csrc/packed_attention.cu)
//   x   = x + LN1(o . W_o + b_o)                  (rounded once)
//   h   = GELU(x . W1 + b1)                       (exact erf; rounded once)
//   x   = x + LN2(h . W2 + b2)                    (rounded once)
// every LayerNorm with fp32 statistics.
//
// What bounds it on the H100: at 518 px and batch 16 (M = 21,920, d =
// 1,792, hidden 15,360) the block's four products are 2.94e12 FLOP (3.0 ms
// at 989 TFLOP/s dense bf16) against about 0.6 GB of activations and 0.2 GB
// of weights (0.25 ms at 3.35 TB/s): compute-bound. The two row passes read
// an fp32 branch output and x and write x, 0.31 GB each (94 us at 3.35
// TB/s): bound by bytes, about 6% of the block.
//
// What the design does about it. The products run on the wgmma GEMM core
// (csrc/gemm_sm90.cuh, whose header has the design), instantiated here
// under this source's tag so that a profiler tells the block's products
// from B2's and B8's:
//   - aaclip_eva_postnorm_gemm: epilogue (a), act(acc + bias) rounded once,
//     for the qkv product (no activation, the bias [q_b | 0 | v_b]) and W1
//     (exact GELU);
//   - aaclip_eva_postnorm_gemm_f32: epilogue (d), the product kept in fp32
//     with no bias, for the out-projection and W2, so that the branch output
//     reaches its LayerNorm unrounded;
//   - aaclip_ln_residual_rows: the row pass y = x + LN(z + bias), one warp a
//     row with the row's z + bias held in registers (16-byte loads, up to
//     2,048 columns), the mean and then the variance about it in fp32 from
//     those registers, and one rounding of x + LN into y. The LayerNorm
//     cannot ride in the product's epilogue: its statistics span the whole
//     row, which the core's 256-wide tiles split.

#include <math.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

// Names the block's kernels after this source in a profiler.
struct eva_postnorm_stage {};

constexpr int ROW_WARPS = 8;           // one row per warp

// Row r of y = x + LN(z + bias): z (M, d) fp32, x and y (M, d) bf16, bias, g
// and b (d,) fp32; d a multiple of 4 and at most 128 NV. Lane l holds the
// float4 chunks l, l + 32, ... of its row.
template <class Tag, int NV>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_residual_rows_kernel(const float* __restrict__ z, const float* __restrict__ bias,
                        const float* __restrict__ g, const float* __restrict__ b,
                        const bf16* __restrict__ x, bf16* __restrict__ y, int M, int d,
                        float eps) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int n4 = d / 4;
  const float4* zr = reinterpret_cast<const float4*>(z + (long)row * d);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  float4 v[NV];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < n4) {
      const float4 a = __ldcs(zr + c), e = b4[c];
      v[i] = make_float4(a.x + e.x, a.y + e.y, a.z + e.z, a.w + e.w);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < n4) {
      const float a = v[i].x - mean, c = v[i].y - mean, e = v[i].z - mean, f = v[i].w - mean;
      q += (a * a + c * c) + (e * e + f * f);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  const long at = (long)row * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c >= n4) continue;
    const float4 gg = reinterpret_cast<const float4*>(g)[c];
    const float4 bb = reinterpret_cast<const float4*>(b)[c];
    const uint2 raw = *reinterpret_cast<const uint2*>(x + at + 4 * c);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    uint2 out;
    out.x = pack_bf16x2(x01.x + ((v[i].x - mean) * rstd * gg.x + bb.x),
                        x01.y + ((v[i].y - mean) * rstd * gg.y + bb.y));
    out.y = pack_bf16x2(x23.x + ((v[i].z - mean) * rstd * gg.z + bb.z),
                        x23.y + ((v[i].w - mean) * rstd * gg.w + bb.w));
    *reinterpret_cast<uint2*>(y + at + 4 * c) = out;
  }
}

template <int NV>
cudaError_t launch_rows(const float* z, const float* bias, const float* g, const float* b,
                        const bf16* x, bf16* y, int M, int d, float eps, cudaStream_t s) {
  ln_residual_rows_kernel<eva_postnorm_stage, NV>
      <<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(z, bias, g, b, x, y, M, d, eps);
  return cudaGetLastError();
}

}  // namespace

// out (M, N) bf16 = act(a (M, K) . w (K, N) + bias), one rounding; act 0
// exact GELU, 2 none. Row strides lda, ldw, ld_out; N a multiple of 128, K
// of 64, pointers 16-byte aligned.
extern "C" int aaclip_eva_postnorm_gemm(const void* a, int lda, const void* w, int ldw,
                                        const void* bias, void* out, int ld_out, int M, int N,
                                        int K, int act, void* stream) {
  if (act != gemm90::ACT_GELU && act != gemm90::ACT_NONE) return cudaErrorInvalidValue;
  return gemm90::gemm<eva_postnorm_stage>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(w), ldw,
      static_cast<const float*>(bias), nullptr, 0, static_cast<bf16*>(out), ld_out, M, N, K, act,
      0, static_cast<cudaStream_t>(stream));
}

// out32 (M, N) fp32 = a (M, K) . w (K, N), no bias, not rounded.
extern "C" int aaclip_eva_postnorm_gemm_f32(const void* a, int lda, const void* w, int ldw,
                                            void* out32, int ld_out, int M, int N, int K,
                                            void* stream) {
  return gemm90::gemm_f32<eva_postnorm_stage>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(w), ldw, 0, nullptr,
      static_cast<float*>(out32), ld_out, M, N, K, 0, static_cast<cudaStream_t>(stream));
}

// y (M, d) bf16 = x + LN(z + bias) with scale g and shift b: z (M, d) fp32,
// x (M, d) bf16, the vectors fp32; d a multiple of 4, at most 2,048;
// contiguous rows, pointers 16-byte aligned.
extern "C" int aaclip_ln_residual_rows(const void* z, const void* bias, const void* g,
                                       const void* b, const void* x, void* y, int M, int d,
                                       float eps, void* stream) {
  const void* ptrs[] = {z, bias, g, b, x, y};
  for (const void* p : ptrs)
    if (p == nullptr || gemm90::misaligned(p)) return cudaErrorInvalidValue;
  if (M <= 0 || d <= 0 || d % 4 || d > 2048) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto zf = static_cast<const float*>(z);
  auto bf = static_cast<const float*>(bias);
  auto gf = static_cast<const float*>(g);
  auto sf = static_cast<const float*>(b);
  auto xb = static_cast<const bf16*>(x);
  auto yb = static_cast<bf16*>(y);
  const int nv = (d / 4 + 31) / 32;
  if (nv <= 1) return launch_rows<1>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
  if (nv <= 2) return launch_rows<2>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
  if (nv <= 4) return launch_rows<4>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
  if (nv <= 8) return launch_rows<8>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
  if (nv <= 14) return launch_rows<14>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
  return launch_rows<16>(zf, bf, gf, sf, xb, yb, M, d, eps, s);
}

extern "C" const char* aaclip_eva_postnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
