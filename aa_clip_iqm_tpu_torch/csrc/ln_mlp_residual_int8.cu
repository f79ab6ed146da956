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
// chunk). rint is round-half-to-even, the scales divide (no reciprocal), and
// every fp32 epilogue multiplies and adds in separate roundings, in the order
// of the plain PyTorch twin, so that the two differ only by the order of the
// LayerNorm's fp32 sums. GELU is the exact erff.
//
// What bounds it on the H100: at ViT-L/518 batch 8 (M = 10,960, d = 1024,
// h = 4096) a layer is 4*M*d*h = 1.84e11 int8 operations (93 us at
// 1979 TOP/s dense int8) against ~53 MB of x/y/weight traffic (16 us at
// 3.35 TB/s): operation-bound.
//
// What the design does about it: one thread block (8 warps) owns 16 rows for
// the whole chain. The quantized LayerNorm tile sits in shared memory as
// int8. A hidden chunk is produced 256 columns at a time by
// mma.sync.m16n8k32 (int8, int32 accumulators in registers), scaled, biased
// and activated on the accumulator registers and written to shared memory
// as fp32 (16 x CH x 4 bytes): its row maximum is needed before any of it
// can be quantized. Then a warp per row takes the maximum and quantizes the
// row in place (the int8 row overwrites the start of its own fp32 row), and
// the second product runs over the chunk with an int32 accumulator in
// registers, folded into the fp32 output accumulator (also registers, each
// warp owns d/8 output columns) once per chunk, exactly as the twin does.
// Two accumulators of that footprint cap the tile at 16 rows. The weights
// are read transposed (k contiguous, the layout the int8 tensor-core
// product wants for its B operand; the wrapper lays them out once per weight
// tensor) and stream through a ring of four 32 KB shared-memory slots with
// cp.async, xor-swizzled so that ldmatrix reads them without bank conflicts.
// Every block streams both matrices from L2 (8 MB at ViT-L width): that
// stream, not the tensor cores, is what the time goes to. Not yet done:
// 32-row tiles (needs the output accumulator out of the register budget),
// wgmma, TMA multicast across a cluster.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

using namespace aaclip;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = 16;                 // rows per block
constexpr int MAX_D = 1024;            // widest model dimension
constexpr int MAX_CH = 1024;           // widest hidden chunk
constexpr int MAX_G = MAX_D / 128;     // 16-column output groups per warp
constexpr int KS1 = 128;               // c_fc k-bytes per pipeline stage
constexpr int KS2 = 32;                // c_proj k-bytes per pipeline stage
constexpr int SLOT_BYTES = 32768;      // 256 x KS1 or MAX_D x KS2
constexpr int SLOTS = 4;               // weight-stage ring: 3 loads in flight
constexpr float INV127 = 0.007874015748031496f;

// 0: exact (erf) GELU; 1: QuickGELU x * sigmoid(1.702 x), the sigmoid as
// 1 / (1 + exp(-t)).
template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if (ACT == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v * (1.f / (1.f + expf(-(1.702f * v))));
}

// clip(rint(v / s), +-127), round-half-to-even, a true division.
__device__ __forceinline__ int quantize(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

struct Smem {
  size_t xq, hid, sx, sh, ring, bytes;
};

// xq: int8 LayerNorm tile, rows padded by 16 bytes. hid: the fp32 hidden
// chunk, rows padded by 8 floats; after quantization the first CH bytes of
// each row hold its int8 values. sx, sh: the per-row scales.
__host__ __device__ inline Smem smem_layout(int d, int ch) {
  Smem s;
  s.xq = 0;
  s.hid = round_up((size_t)BM * (d + 16), 128);
  s.sx = s.hid + round_up(sizeof(float) * BM * (ch + 8), 128);
  s.sh = s.sx + 128;
  s.ring = s.sh + 128;
  s.bytes = s.ring + (size_t)SLOTS * SLOT_BYTES;
  return s;
}

// The weights stream as a sequence of stages per hidden chunk. First, for
// each sub-chunk of `sub` hidden units (256, or 128 when CH is 128), d/KS1
// slices of Wfc^T: `sub` rows (hidden units) x KS1 k-bytes, a row at
// r * 128 with its 16-byte segment s stored at s ^ (r & 7). Then CH/KS2
// slices of Wp^T: d rows (output columns) x KS2 k-bytes, a row at r * 32
// with segment s stored at s ^ ((r >> 2) & 1). While stage t multiplies,
// stages t+1 .. t+3 load; one barrier per stage.
template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
ln_mlp_residual_int8_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ ln_g,
                            const float* __restrict__ ln_b,
                            const int8_t* __restrict__ wfc_t,
                            const float* __restrict__ s_fc,
                            const float* __restrict__ b_fc,
                            const int8_t* __restrict__ wp_t,
                            const float* __restrict__ s_proj,
                            const float* __restrict__ b_proj,
                            bf16* __restrict__ y, int M, int d, int h, int ch,
                            float eps) {
  const Smem lay = smem_layout(d, ch);
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.xq);
  unsigned char* hid = smem + lay.hid;
  float* sxs = reinterpret_cast<float*>(smem + lay.sx);
  float* shs = reinterpret_cast<float*>(smem + lay.sh);
  const int ldx = d + 16;              // bytes per xq row
  const int ldh = (ch + 8) * 4;        // bytes per hidden row
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int sub = (ch % 256 == 0) ? 256 : 128;
  const int nt1 = sub / 64;            // this warp's n8 tiles of a sub-chunk
  const int nk1 = d / KS1;
  const int nfc = (ch / sub) * nk1;    // c_fc stages per chunk
  const int np = ch / KS2;             // c_proj stages per chunk
  const int per_chunk = nfc + np;
  const int total = (h / ch) * per_chunk;
  const int ngroups = d / 128;         // this warp's 16-column output groups
  const int col0 = warp * (d / 8);     // this warp's first output column

  auto slot = [&](int t) { return smem + lay.ring + (size_t)(t % SLOTS) * SLOT_BYTES; };
  // Start loading stage t (if it exists); always commit, so that group
  // counts stay aligned with stage numbers.
  auto fetch = [&](int t) {
    if (t < total) {
      const int j = t / per_chunk, s = t % per_chunk;
      unsigned char* dst = slot(t);
      if (s < nfc) {
        const int8_t* src = wfc_t + (long)(j * ch + (s / nk1) * sub) * d + (s % nk1) * KS1;
        for (int i = threadIdx.x; i < sub * 8; i += NTHREADS) {
          const int r = i >> 3, sg = i & 7;
          cp_async16(dst + r * 128 + ((sg ^ (r & 7)) << 4), src + (long)r * d + sg * 16);
        }
      } else {
        const int8_t* src = wp_t + j * ch + (s - nfc) * KS2;
        for (int i = threadIdx.x; i < d * 2; i += NTHREADS) {
          const int r = i >> 1, sg = i & 1;
          cp_async16(dst + r * 32 + ((sg ^ ((r >> 2) & 1)) << 4), src + (long)r * h + sg * 16);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < SLOTS - 1; ++t) fetch(t);

  // LayerNorm in fp32, the row's scale, and the int8 tile. One warp per row;
  // rows past M are zero.
  for (int r = warp; r < BM; r += NWARPS) {
    const int gr = row0 + r;
    int8_t* dst = xq + r * ldx;
    if (gr < M) {
      const bf16* src = x + (long)gr * d;
      float v[MAX_D / 32];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int c = i * 32 + lane;
        v[i] = c < d ? to_float(src[c]) : 0.f;
        s += v[i];
      }
      const float mean = warp_sum(s) / d;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const float t = (i * 32 + lane < d) ? v[i] - mean : 0.f;
        q += t * t;
      }
      const float rstd = 1.f / sqrtf(warp_sum(q) / d + eps);
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int c = i * 32 + lane;
        if (c < d) {
          v[i] = (v[i] - mean) * rstd * ln_g[c] + ln_b[c];
          amax = fmaxf(amax, fabsf(v[i]));
        }
      }
      const float sx = fmaxf(warp_max(amax), 1e-6f) * INV127;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int c = i * 32 + lane;
        if (c < d) dst[c] = (int8_t)quantize(v[i], sx);
      }
      if (lane == 0) sxs[r] = sx;
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = 0;
      if (lane == 0) sxs[r] = 0.f;
    }
  }

  float acc[2 * MAX_G][4];             // output: [n8 tile][fragment], fp32
  int iacc[2 * MAX_G][4];              // the chunk's second product, int32
  int hacc[4][4];                      // hidden sub-chunk: [n8 tile][fragment]
#pragma unroll
  for (int n = 0; n < 2 * MAX_G; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[n][i] = 0.f;
      iacc[n][i] = 0;
    }

  for (int t = 0; t < total; ++t) {
    cp_async_wait<SLOTS - 2>();        // stage t has landed (this thread's part)
    __syncthreads();                   // ... everyone's part; stage t-1 is done
    fetch(t + SLOTS - 1);              // into stage t-1's slot
    const unsigned char* buf = slot(t);
    const int j = t / per_chunk, s = t % per_chunk;
    if (s < nfc) {
      // hid[:, this warp's sub/8 columns] += x_q[:, slice] . Wfc_q[slice, sub-chunk]
      const int sb = s / nk1, ks = s % nk1;
      if (ks == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) hacc[n][i] = 0;
      }
#pragma unroll
      for (int kk = 0; kk < KS1 / 32; ++kk) {
        unsigned a[4];
        ldsm_x4_b8(a, xq + (lane % 16) * ldx + ks * KS1 + kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          if (2 * jb < nt1) {
            const int r = warp * (sub / 8) + jb * 16 + (lane % 8) + (lane / 16) * 8;
            const int sg = kk * 2 + ((lane / 8) & 1);
            unsigned b[4];
            ldsm_x4_b8(b, buf + r * 128 + ((sg ^ (r & 7)) << 4));
            mma16832_s8(hacc[2 * jb], a, b[0], b[1]);
            mma16832_s8(hacc[2 * jb + 1], a, b[2], b[3]);
          }
        }
      }
      if (ks == nk1 - 1) {
        // Dequantize, bias and activate this warp's hidden columns straight
        // from the accumulators, into the fp32 chunk.
        const float sx0 = sxs[g], sx1 = sxs[g + 8];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n < nt1) {
            const int col = sb * sub + warp * (sub / 8) + n * 8 + 2 * tq;
            const int hc = j * ch + col;
            const float f0 = s_fc[hc], f1 = s_fc[hc + 1];
            const float c0 = b_fc[hc], c1 = b_fc[hc + 1];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float sx = half ? sx1 : sx0;
              const float v0 = activation<ACT>(__fadd_rn(
                  __fmul_rn((float)hacc[n][2 * half], __fmul_rn(sx, f0)), c0));
              const float v1 = activation<ACT>(__fadd_rn(
                  __fmul_rn((float)hacc[n][2 * half + 1], __fmul_rn(sx, f1)), c1));
              *reinterpret_cast<float2*>(hid + (g + half * 8) * ldh + col * 4) =
                  make_float2(v0, v1);
            }
          }
        }
      }
    } else {
      const int p = s - nfc;
      if (p == 0) {
        // The chunk is complete: per row, its scale, then int8 in place.
        // The whole row is in registers before any of it is overwritten.
        for (int r = warp; r < BM; r += NWARPS) {
          unsigned char* rowp = hid + r * ldh;
          float4 v[MAX_CH / 128];
          float amax = 0.f;
#pragma unroll
          for (int i = 0; i < MAX_CH / 128; ++i) {
            if (i * 128 < ch) {
              v[i] = *reinterpret_cast<const float4*>(rowp + (i * 128 + lane * 4) * 4);
              amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y))),
                           fmaxf(fabsf(v[i].z), fabsf(v[i].w)));
            }
          }
          const float sh = fmaxf(warp_max(amax), 1e-6f) * INV127;
          __syncwarp();
#pragma unroll
          for (int i = 0; i < MAX_CH / 128; ++i) {
            if (i * 128 < ch) {
              const unsigned packed =
                  (unsigned)(quantize(v[i].x, sh) & 0xff) |
                  ((unsigned)(quantize(v[i].y, sh) & 0xff) << 8) |
                  ((unsigned)(quantize(v[i].z, sh) & 0xff) << 16) |
                  ((unsigned)(quantize(v[i].w, sh) & 0xff) << 24);
              *reinterpret_cast<unsigned*>(rowp + i * 128 + lane * 4) = packed;
            }
          }
          if (lane == 0) shs[r] = sh;
        }
        __syncthreads();
      }
      // iacc[:, this warp's columns] += h_q[:, slice] . Wp_q[slice, :]
      unsigned a[4];
      ldsm_x4_b8(a, hid + (lane % 16) * ldh + p * KS2 + (lane / 16) * 16);
#pragma unroll
      for (int jg = 0; jg < MAX_G; ++jg) {
        if (jg < ngroups) {
          const int r = col0 + jg * 16 + (lane % 8) + (lane / 16) * 8;
          const int sg = (lane / 8) & 1;
          unsigned b[4];
          ldsm_x4_b8(b, buf + r * 32 + ((sg ^ ((r >> 2) & 1)) << 4));
          mma16832_s8(iacc[2 * jg], a, b[0], b[1]);
          mma16832_s8(iacc[2 * jg + 1], a, b[2], b[3]);
        }
      }
      if (p == np - 1) {
        // acc += float(chunk's int32 product) * sh, then start the next chunk.
        const float sh0 = shs[g], sh1 = shs[g + 8];
#pragma unroll
        for (int n = 0; n < 2 * MAX_G; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[n][i] = __fadd_rn(acc[n][i],
                                  __fmul_rn((float)iacc[n][i], i < 2 ? sh0 : sh1));
            iacc[n][i] = 0;
          }
      }
    }
  }
  cp_async_wait<0>();                  // only empty groups remain

  // y = x + acc * s_proj + b_proj in fp32, one cast, from the accumulators.
#pragma unroll
  for (int n = 0; n < 2 * MAX_G; ++n) {
    if (n < 2 * ngroups) {
      const int col = col0 + n * 8 + 2 * tq;
      const float p0 = s_proj[col], p1 = s_proj[col + 1];
      const float b0 = b_proj[col], b1 = b_proj[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gr = row0 + g + half * 8;
        if (gr < M) {
          const long off = (long)gr * d + col;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off));
          *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(
              __fadd_rn(__fadd_rn(xv.x, __fmul_rn(acc[n][2 * half], p0)), b0),
              __fadd_rn(__fadd_rn(xv.y, __fmul_rn(acc[n][2 * half + 1], p1)), b1));
        }
      }
    }
  }
}

template <int ACT>
cudaError_t launch(const void* x, const float* ln_g, const float* ln_b,
                   const void* wfc_t, const float* s_fc, const float* b_fc,
                   const void* wp_t, const float* s_proj, const float* b_proj,
                   void* y, int M, int d, int h, int ch, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_layout(d, ch).bytes;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ln_mlp_residual_int8_kernel<ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_mlp_residual_int8_kernel<ACT><<<(M + BM - 1) / BM, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), ln_g, ln_b, static_cast<const int8_t*>(wfc_t),
      s_fc, b_fc, static_cast<const int8_t*>(wp_t), s_proj, b_proj,
      static_cast<bf16*>(y), M, d, h, ch, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (M, d) bf16. wfc_t: (h, d) int8, the c_fc weight transposed; wp_t:
// (d, h) int8, the c_proj weight transposed. LayerNorm scale/bias, the
// per-output-channel weight scales and both biases are fp32. ch: the hidden
// chunk width (128, 256, 512 or 1024, dividing h). act: 0 = exact GELU,
// 1 = QuickGELU. d must be a multiple of 128, at most 1024. Returns the
// launch's cudaError_t.
extern "C" int aaclip_ln_mlp_residual_int8(
    const void* x, const void* ln_g, const void* ln_b, const void* wfc_t,
    const void* s_fc, const void* b_fc, const void* wp_t, const void* s_proj,
    const void* b_proj, void* y, int M, int d, int h, int ch, float eps, int act,
    void* stream) {
  if (M <= 0 || d <= 0 || d % 128 != 0 || d > MAX_D) return cudaErrorInvalidValue;
  if ((ch != 128 && ch != 256 && ch != 512 && ch != 1024) || h <= 0 || h % ch != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* sf = static_cast<const float*>(s_fc);
  const float* bf = static_cast<const float*>(b_fc);
  const float* sp = static_cast<const float*>(s_proj);
  const float* bp = static_cast<const float*>(b_proj);
  if (act == 0)
    return launch<0>(x, g, b, wfc_t, sf, bf, wp_t, sp, bp, y, M, d, h, ch, eps, s);
  if (act == 1)
    return launch<1>(x, g, b, wfc_t, sf, bf, wp_t, sp, bp, y, M, d, h, ch, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* aaclip_ln_mlp_residual_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
