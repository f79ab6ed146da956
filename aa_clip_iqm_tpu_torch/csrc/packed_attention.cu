// Packed-qkv self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aa_clip_iqm_tpu/ops/pallas_attention.py:
// flash_mha_packed -> _row_kernel_grouped (whole-row softmax over 2-head
// 128-lane panels of the packed (B, L, 3W) qkv projection).
//
// What it computes, per (batch b, head h): softmax(scale * Q K^T) V with keys
// >= valid_len masked, written in merged-head (B, L, W) layout, and where
// asked each row's log-sum-exp (B, H, L) fp32 for the backward (B4, B6). q, k, v are
// read strided straight out of the packed tensor at column offset
// sec*W + h*hd, sec = (0, 1, 2), or (2, 2, 2) for the CLIP-Surgery
// value-value variant, so no head split or merge copies exist.
//
// What bounds it on the H100: at ViT-L/518 (B=8, L=1370, 16 heads of 64)
// a layer is 4*B*H*L^2*hd = 6.2e10 FLOP (62 us at 989 TFLOP/s dense bf16)
// against ~90 MB of qkv/out traffic (27 us at 3.35 TB/s): compute-bound.
//
// What the design does about it: the tile walk of attention_fwd.cuh
// (shared with the unpacked kernel, csrc/flash_attention.cu, and B8's
// attention stage) keeps the (L, L) scores on the SM: for bf16, 128-query
// blocks on wgmma walk 128-key tiles streamed by TMA (3-D tensor maps over
// (B, L, W) from each section's first column, so a head is a 64-column box,
// or two at head width 112), for fp32 plain FMAs; here the layout is the
// packed one: row stride 3W, head stride hd. Two instances, one per head
// width (64, and 112 for EVA02-CLIP-E/14+'s 16 heads of 112), each a C
// entry of its own.

#include <stdint.h>

#include "attention_fwd.cuh"

using namespace aaclip;

// The kernels' tags, which carry the head width: their names read
// attention_wgmma_kernel<packed_attention> (heads of 64: ViT-L, EVA-02-L)
// and attention_wgmma_kernel<packed_attention_hd112> (EVA02-CLIP-E/14+).
struct packed_attention {
  static constexpr int hd = 64;
};
struct packed_attention_hd112 {
  static constexpr int hd = 112;
};

namespace {

// The walk of tag Tag over the packed (B, L, 3W) qkv.
template <class Tag>
int launch_packed(const void* qkv, void* out, void* lse, int B, int L, int W, int num_heads,
                  int head_dim, int valid_len, float scale, int vv, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || head_dim * num_heads != W || valid_len <= 0 ||
      (W % 8) != 0 || head_dim != Tag::hd)
    return cudaErrorInvalidValue;
  const int n_keys = valid_len < L ? valid_len : L;
  const size_t elem = dtype == 1 ? sizeof(bf16) : sizeof(float);
  const char* base = static_cast<const char*>(qkv);
  auto section = [&](int sec) { return base + (size_t)sec * W * elem; };
  const attn_fwd::Layout lay{(long)L * 3 * W, head_dim, 3 * W, (long)L * W, head_dim, W};
  return attn_fwd::launch<Tag>(dtype, section(vv ? 2 : 0), section(vv ? 2 : 1), section(2), out,
                               static_cast<float*>(lse), lay, L, num_heads, B, n_keys, scale,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: (B, H, L) fp32, written only when
// non-null. Returns the launch's cudaError_t. Heads of 64.
extern "C" int aaclip_packed_attention(const void* qkv, void* out, void* lse, int B, int L,
                                       int W, int num_heads, int head_dim, int valid_len,
                                       float scale, int vv, int dtype, void* stream) {
  return launch_packed<packed_attention>(qkv, out, lse, B, L, W, num_heads, head_dim, valid_len,
                                         scale, vv, dtype, stream);
}

// The same for heads of 112.
extern "C" int aaclip_packed_attention_hd112(const void* qkv, void* out, void* lse, int B, int L,
                                             int W, int num_heads, int head_dim, int valid_len,
                                             float scale, int vv, int dtype, void* stream) {
  return launch_packed<packed_attention_hd112>(qkv, out, lse, B, L, W, num_heads, head_dim,
                                               valid_len, scale, vv, dtype, stream);
}

extern "C" const char* aaclip_packed_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
