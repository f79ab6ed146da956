// EVA-02's 2-D rotary embedding of q and k, in place on the packed
// projection (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no EVA-02 tower. It sits
// between the packed qkv projection (cuBLAS) and the attention kernels (B1,
// or B7 above 8,192 tokens), which read the projection as it is.
//
// What it computes: for qkv (B, L, 3w) bf16 and each row l >= 1 (a patch;
// row 0, the class token, is left as it is), each of the 2w columns of q and
// k, in pairs (2i, 2i + 1) of a head of width hd:
//   out[2i]     = z[2i] * cos - z[2i + 1] * sin,
//   out[2i + 1] = z[2i + 1] * cos + z[2i] * sin,
// in fp32 with cos and sin of the pair's angle (the table's column 2i of
// row l - 1, fp32, (L - 1, hd) for the batch or one such block per sample,
// batch stride table_stride), rounded once. ops/rope.py has the table and
// the plain version.
//
// What bounds it: nothing but bytes. At EVA02-CLIP-L/518, batch 32, a call
// reads and writes 43,808 rows x 2,048 bf16 (359 MB), 0.107 ms at 3.35 TB/s;
// the table (5.6 MB for 1,369 rows) stays in L2 across the batch.
//
// What the design does: one thread takes 8 neighbouring columns (four
// pairs) of one row: a 16-byte load and store of bf16, two float4 loads of
// cos and of sin (the two columns of a pair share an angle, so cos[2i] =
// cos[2i + 1], and the 8 columns lie in one head as hd is a multiple of 8).
// Neighbouring threads take neighbouring columns, so a warp moves whole
// sectors.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

using namespace aaclip;

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rope_qk_kernel(bf16* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, long table_stride, int B, int L, int w, int hd) {
  const int per_row = 2 * w / 8;                       // 8-column groups of q and k
  const long total = (long)B * (L - 1) * per_row;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long)gridDim.x * THREADS) {
    const int g = (int)(i % per_row);
    const long r = i / per_row;                        // patch row over the batch
    const int b = (int)(r / (L - 1)), p = (int)(r % (L - 1));
    const int col = 8 * g, j = col % hd;
    bf16* z = qkv + ((long)b * L + p + 1) * 3 * w + col;
    const float* c = cos_t + b * table_stride + (long)p * hd + j;
    const float* s = sin_t + b * table_stride + (long)p * hd + j;
    const uint4 raw = *reinterpret_cast<const uint4*>(z);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 c0 = *reinterpret_cast<const float4*>(c), c1 = *reinterpret_cast<const float4*>(c + 4);
    const float4 s0 = *reinterpret_cast<const float4*>(s), s1 = *reinterpret_cast<const float4*>(s + 4);
    const float cv[4] = {c0.x, c0.z, c1.x, c1.z}, sv[4] = {s0.x, s0.z, s1.x, s1.z};
    uint4 packed;
    unsigned* pw = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(v[e]);
      pw[e] = pack_bf16x2(f.x * cv[e] - f.y * sv[e], f.y * cv[e] + f.x * sv[e]);
    }
    *reinterpret_cast<uint4*>(z) = packed;
  }
}

}  // namespace

// qkv (B, L, 3w) bf16, contiguous, rotated in place; cos and sin fp32 (L -
// 1, hd) blocks, table_stride elements apart per sample (0: one block for
// the batch). w a multiple of hd, hd of 8; pointers 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int aaclip_rope_qk(void* qkv, const void* cos_t, const void* sin_t,
                              long table_stride, int B, int L, int w, int hd, void* stream) {
  if (B <= 0 || L < 1 || w <= 0 || hd <= 0 || hd % 8 || w % hd ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(cos_t) % 16 ||
      reinterpret_cast<uintptr_t>(sin_t) % 16 || table_stride % 4)
    return cudaErrorInvalidValue;
  if (L == 1) return cudaSuccess;
  const long total = (long)B * (L - 1) * (2 * w / 8);
  const int grid = (int)std::min<long>((total + THREADS - 1) / THREADS, 132L * 16);
  rope_qk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), table_stride, B, L, w, hd);
  return cudaGetLastError();
}

extern "C" const char* aaclip_rope_qk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
