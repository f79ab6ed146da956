// Fused attention half of a transformer block for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_attn_block.py:
// ln_attn_residual -> _kernel (one program per (batch item, 2-head panel):
// LayerNorm of the whole item into VMEM once, the panel's q/k/v projected
// from it, whole-row attention, and the out-projection accumulated across
// panels in an fp32 (L, d) VMEM scratch, flushed once with the residual).
//
// What it computes, for x (B, L, d) bf16:
//   xn  = LayerNorm(x) in fp32, rounded to bf16;
//   qkv = xn . W_qkv + b_qkv (bf16 products, fp32 accumulation, fp32 bias,
//         one rounding); for vv only the value section, which is q, k and v;
//   O   = softmax(scale * Q K^T) V per head (fp32 scores and softmax, exact
//         up to the online rescale, P rounded to bf16 before P.V, O rounded
//         to bf16), keys >= valid_len masked;
//   y   = x + (O . W_out + b_out), the out-projection accumulated in fp32
//         over all heads, the bias and the residual added once, one rounding.
//
// What bounds it on the H100: at ViT-L/518 batch 8 (L = 1370, d = 1024, 16
// heads of 64) 8*B*L*d^2 + 4*B*H*L^2*hd = 9.19e10 + 6.15e10 = 1.53e11 FLOP
// (155 us at 989 TFLOP/s dense bf16) against ~52 MB of x, y and weight
// traffic (16 us at 3.35 TB/s): compute-bound.
//
// What the design does about it. The TPU program keeps a whole item's LN(x)
// and the fp32 (L, d) out-projection accumulator in VMEM. On this card an
// accumulator that spans d across all heads caps a block at 32 query rows
// (32 x 1024 fp32 is half the register file), so every block re-reads every
// head's K/V and all of W_out. So the attention output goes through device
// memory, and the projections run on the wgmma GEMM core that B2 uses
// (csrc/gemm_sm90.cuh). Four launches on one stream, all through one bf16
// scratch of (B*L, ncols + d), ncols = 3d (d for vv):
//   1. the LayerNorm pass: xn into the scratch's last d columns;
//   2. the qkv GEMM with epilogue (a) without an activation into its first
//      ncols columns; for vv only the value section, a tensor map over
//      W_qkv[:, 2d:3d] with row stride 3d;
//   3. attention with B1's tile walk (csrc/attention_fwd.cuh: one block per
//      128-query tile and head on wgmma, online softmax over 128-key tiles
//      streamed by TMA, keys >= valid_len masked): O, rounded to bf16, over
//      xn, which launch 2 has read;
//   4. the out-projection GEMM with epilogue (b): x + (O . W_out + b_out).
// Head width 64 only (ViT-L: 16 heads of 64), d a multiple of 128.
// Two more entries run launches 1-2 (front) and 4 (back) alone, with the
// caller's attention kernel between them: the model's route at inference,
// whose attention stays B1 (or B7). The whole entry is the port of the TPU
// kernel, held to it and to its plain twin by the tests.

#include "attention_fwd.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

using namespace aaclip;

namespace {

constexpr int HD = 64;

// Names the stage kernels after this source, so that a profiler tells them
// from B1's and B2's.
struct ln_attn_residual_stage {
  static constexpr int hd = 64;        // the attention walk's head width
};

}  // namespace

// x, y: (B, L, d) bf16; LayerNorm scale/bias and both biases fp32; w_qkv
// (d, 3d) and w_out (d, d) bf16, (in, out); scratch: bf16 (B*L, 4d), or
// (B*L, 2d) for vv. Four launches on `stream`, the two products' tiles in
// bands of group1 and group2 M-tiles. Returns the first failing launch's
// cudaError_t.
extern "C" int aaclip_ln_attn_residual(const void* x, const void* ln_g, const void* ln_b,
                                       const void* w_qkv, const void* b_qkv,
                                       const void* w_out, const void* b_out, void* scratch,
                                       void* y, int B, int L, int d, int num_heads,
                                       int valid_len, float eps, float scale, int vv,
                                       int group1, int group2, void* stream) {
  if (B <= 0 || L <= 0 || B > 65535 || valid_len <= 0 || d % 128 != 0 || num_heads * HD != d)
    return cudaErrorInvalidValue;
  using Tag = ln_attn_residual_stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const int ncols = vv ? d : 3 * d;
  const int ld = ncols + d;            // the scratch's row stride
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(w_qkv) + (vv ? 2 * d : 0);
  const float* bq = static_cast<const float*>(b_qkv) + (vv ? 2 * d : 0);
  bf16* proj = static_cast<bf16*>(scratch);
  bf16* xn_o = proj + ncols;           // xn, then O

  cudaError_t err = gemm90::layer_norm_rows<Tag>(xb, static_cast<const float*>(ln_g),
                                                 static_cast<const float*>(ln_b), xn_o, ld, M, d,
                                                 eps, s);
  if (err == cudaSuccess)
    err = gemm90::gemm<Tag>(xn_o, ld, wq, 3 * d, bq, nullptr, 0, proj, ld, M, ncols, d,
                            gemm90::ACT_NONE, 0, group1, s);
  if (err != cudaSuccess) return err;

  // Heads of q, k and v at column offsets 0, d and 2d of the projection
  // (all at 0 for vv); O at the xn columns.
  const attn_fwd::Layout lay{(long)L * ld, HD, ld, (long)L * ld, HD, ld};
  const int n_keys = valid_len < L ? valid_len : L;
  err = attn_fwd::launch<Tag>(1, proj, proj + (vv ? 0 : d), proj + (vv ? 0 : 2 * d), xn_o,
                              nullptr, lay, L, num_heads, B, n_keys, scale, s);
  if (err != cudaSuccess) return err;

  return gemm90::gemm<Tag>(xn_o, ld, static_cast<const bf16*>(w_out), d,
                           static_cast<const float*>(b_out), xb, d, static_cast<bf16*>(y), d, M,
                           d, d, gemm90::ACT_NONE, 0, group2, s);
}

// The kernel's halves around an attention launch of the caller's, each its
// stages of the same name on the same core: the model's unfused route
// (models/clip.py), which keeps its own attention kernel between them.
//
// front: xn = LayerNorm(x) into the caller's bf16 scratch (M, d), then qkv =
// xn . w_qkv + b_qkv with epilogue (a) and no activation into qkv (M, 3d),
// the packed (B, L, 3d) layout that B1 reads, its tiles in bands of `group`
// M-tiles. x (M, d) bf16, LayerNorm scale/bias and b_qkv fp32, w_qkv (d,
// 3d) bf16. Two launches.
extern "C" int aaclip_ln_attn_residual_front(const void* x, const void* ln_g, const void* ln_b,
                                             const void* w_qkv, const void* b_qkv, void* xn,
                                             void* qkv, int M, int d, float eps, int group,
                                             void* stream) {
  if (M <= 0 || d % 128 != 0) return cudaErrorInvalidValue;
  using Tag = ln_attn_residual_stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xn_b = static_cast<bf16*>(xn);
  cudaError_t err = gemm90::layer_norm_rows<Tag>(static_cast<const bf16*>(x),
                                                 static_cast<const float*>(ln_g),
                                                 static_cast<const float*>(ln_b), xn_b, d, M, d,
                                                 eps, s);
  if (err != cudaSuccess) return err;
  return gemm90::gemm<Tag>(xn_b, d, static_cast<const bf16*>(w_qkv), 3 * d,
                           static_cast<const float*>(b_qkv), nullptr, 0,
                           static_cast<bf16*>(qkv), 3 * d, M, 3 * d, d, gemm90::ACT_NONE, 0,
                           group, s);
}

// back: y = x + (o . w_out + b_out), epilogue (b), rounded once, its tiles
// in bands of `group` M-tiles. o, x and y (M, d) bf16, w_out (d, d) bf16,
// b_out fp32. One launch.
extern "C" int aaclip_ln_attn_residual_back(const void* o, const void* w_out, const void* b_out,
                                            const void* x, void* y, int M, int d, int group,
                                            void* stream) {
  if (M <= 0 || d % 128 != 0) return cudaErrorInvalidValue;
  return gemm90::gemm<ln_attn_residual_stage>(
      static_cast<const bf16*>(o), d, static_cast<const bf16*>(w_out), d,
      static_cast<const float*>(b_out), static_cast<const bf16*>(x), d, static_cast<bf16*>(y),
      d, M, d, d, gemm90::ACT_NONE, 0, group, static_cast<cudaStream_t>(stream));
}

extern "C" const char* aaclip_ln_attn_residual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
