// Unpacked (B*H, L, hd) self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels aa_clip_iqm_tpu/ops/pallas_attention.py:
// flash_mha -> _flash_forward -> _row_kernel (whole-row softmax while the
// padded length is at most ROW_KERNEL_MAX_TOKENS = 8192) and _flash_kernel
// (online softmax over 128-key blocks above it). On the TPU the split is a
// VMEM budget for the (BLK_Q, L) score row; a Hopper block holds neither
// row, so one online-softmax kernel computes both.
//
// What it computes, per (batch*head i): softmax(scale * Q K^T) V from
// contiguous q, k, v (BH, L, hd) into out (BH, L, hd).
//
// What bounds it on the H100: 4*BH*L^2*hd FLOP against 4*BH*L*hd elements of
// traffic. At ViT-L/14 1274 px (BH = 16 at batch 1, L = 8282, hd = 64) that is
// 2.81e11 FLOP (284 us at 989 TFLOP/s dense bf16) against 68 MB (20 us at
// 3.35 TB/s); at 518 px (BH = 128, L = 1370) 6.15e10 FLOP (62 us) against
// 90 MB (27 us): compute-bound at both.
//
// What the design does about it: the tile walk of attention_fwd.cuh, B1's
// (csrc/packed_attention.cu) own, on the plain layout: one plane of rows
// (stride hd) per (batch, head). For bf16, 128-query blocks walk 128-key
// tiles (the TPU online kernel's blk_k) on wgmma, fed by a TMA ring under a
// producer warp, with the exponentials of one tile run under the previous
// tile's P.V; the (L, L) scores never leave the SM, and TMA's zero fill and
// the kernel's mask of the last tile stand in for padding.

#include <stdint.h>

#include "attention_fwd.cuh"

using namespace aaclip;

// The kernels' tag: their names read attention_wgmma_kernel<flash_attention>.
struct flash_attention {
  static constexpr int hd = 64;
};

// q, k, v, out: contiguous (BH, L, head_dim). dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int aaclip_flash_attention(const void* q, const void* k, const void* v, void* out,
                                      int BH, int L, int head_dim, float scale, int dtype,
                                      void* stream) {
  // Head width 64 only: the one width on the port's path (ViT-L's 16 heads).
  if (BH <= 0 || L <= 0 || BH > 65535 || head_dim != flash_attention::hd)
    return cudaErrorInvalidValue;
  const attn_fwd::Layout lay{0, (long)L * head_dim, head_dim, 0, (long)L * head_dim, head_dim};
  return attn_fwd::launch<flash_attention>(dtype, q, k, v, out, nullptr, lay, L, BH, 1, L, scale,
                                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* aaclip_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
