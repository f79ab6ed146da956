// The attention forward tile walk shared by the packed-qkv kernel (B1,
// csrc/packed_attention.cu) and the unpacked flash kernel (B7,
// csrc/flash_attention.cu): the two differ only in where a block's q, k, v
// rows and output rows live, which a Layout of strides says. Each source
// instantiates the kernels with a tag type named after itself, so that a
// profiler tells the two apart by the kernel's name.
//
// What it computes, per (batch b = blockIdx.z, head h = blockIdx.y):
//   S = scale * Q K^T in fp32, keys >= n_keys masked to -inf,
//   O = softmax(S) V, with the probabilities rounded to V's dtype before the
//   P.V product and fp32 accumulation; where the caller gives an lse buffer
//   (B, H, L) fp32, also each row's log-sum-exp m + log(l) of the scaled
//   scores, which the backward (B4/B6) rebuilds P from. B7 and B8 pass null.
//
// The design: the (L, L) score matrix never leaves the SM. One thread block
// (4 warps) owns a 64-row query tile of one head and walks the keys in 64-key
// tiles with an online softmax (fp32 running max, sum and accumulator), so
// device memory sees one read of q/k/v per tile and one write of the output.
// Two paths:
//   - bf16: the FlashAttention-2 layout. Each warp keeps its 16 query rows'
//     Q operands, scores, probabilities and output accumulator in registers;
//     both products are mma.sync m16n8k16 with operands from ldmatrix; row
//     statistics need two quad shuffles; the next K/V tile loads by cp.async
//     while this one multiplies;
//   - fp32: plain FMAs over shared-memory tiles, so it keeps full fp32
//     precision.
// The ragged last key tile and keys >= n_keys are masked; rows past L are
// zero-filled on load and never written, so no caller pads. Head width 64
// only (ViT-L's 16 heads). Not yet done: TMA, wgmma, warp specialisation.
//
// Online softmax differs from the TPU kernels' whole-row softmax only by fp32
// rounding of the running rescale, plus the bf16 rounding of P (taken against
// the running instead of the final row max).
#pragma once

#include <math.h>

#include "common.cuh"

namespace aaclip {
namespace attn_fwd {
namespace {  // each source that includes this is a library of its own

constexpr int HD = 64;                 // head width
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int NWARPS = 4;              // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;

// Where block (head blockIdx.y, batch blockIdx.z) finds its rows: row r of q
// (k, v alike) at q + z * batch + y * head + r * ld, row r of the output at
// out + z * out_batch + y * out_head + r * out_ld (elements).
struct Layout {
  long batch, head;
  int ld;
  long out_batch, out_head;
  int out_ld;
};

__device__ __forceinline__ long in_offset(const Layout& lay) {
  return blockIdx.z * lay.batch + blockIdx.y * lay.head;
}
__device__ __forceinline__ long out_offset(const Layout& lay) {
  return blockIdx.z * lay.out_batch + blockIdx.y * lay.out_head;
}

// ---------------------------------------------------------------------------
// bf16 path: FlashAttention-2 register layout.
// ---------------------------------------------------------------------------

constexpr int LD = HD + 8;             // tile row stride (16-byte padding)
constexpr size_t TILE = round_up(sizeof(bf16) * 64 * LD, 128);
constexpr size_t MMA_SMEM = 5 * TILE;  // Q, then K[2], then V[2]

// Start copying rows [r0, r0 + 64) of one head's (L, HD) panel into shared
// memory; rows at or past L are zero-filled.
__device__ __forceinline__ void load_panel(bf16* dst, const bf16* src, int row_stride, int r0,
                                           int L) {
  constexpr int VPR = HD / 8;          // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool real = r0 + r < L;
    cp_async16(dst + r * LD + c, real ? src + (long)(r0 + r) * row_stride + c : src,
               real ? 16 : 0);
  }
}

template <class Tag>
__global__ void __launch_bounds__(NTHREADS)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, Layout lay, int L, int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto kbuf = [&](int i) { return reinterpret_cast<bf16*>(smem + (1 + i) * TILE); };
  auto vbuf = [&](int i) { return reinterpret_cast<bf16*>(smem + (3 + i) * TILE); };

  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long in_off = in_offset(lay);
  const bf16* ksrc = k + in_off;
  const bf16* vsrc = v + in_off;
  const int ntiles = (n_keys + BK - 1) / BK;

  load_panel(Qs, q + in_off, lay.ld, q0, L);
  load_panel(kbuf(0), ksrc, lay.ld, 0, L);
  load_panel(vbuf(0), vsrc, lay.ld, 0, L);
  cp_async_commit();

  unsigned qa[HD / 16][4];             // this warp's Q rows as A operands
  float o[HD / 8][4];                  // output accumulator, n8 tiles over hd
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // Running max and (per-lane partial) sum of rows g and g + 8.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      load_panel(kbuf((kt + 1) & 1), ksrc, lay.ld, (kt + 1) * BK, L);
      load_panel(vbuf((kt + 1) & 1), vsrc, lay.ld, (kt + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qa[kk], tile_lane_row(Qs + warp * 16 * LD + kk * 16, LD));
    }
    const bf16* Kt = kbuf(kt & 1);
    const bf16* Vt = vbuf(kt & 1);

    // S = Q K^T: 8 n8 tiles of keys. K is [key][d], so its plain 8x8
    // matrices are B operands; lane l addresses key (l % 8) + 8 (l / 16),
    // column block (l / 8) % 2.
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        unsigned kb[4];
        ldsm_x4(kb, Kt + (j * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma16816(sc[2 * j], qa[kk], kb[0], kb[1]);
        mma16816(sc[2 * j + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // Scale, mask, online softmax. The lane holds columns 2tq, 2tq+1 of each
    // n8 tile for rows g (i = 0, 1) and g + 8 (i = 2, 3); a row lives in a quad.
    const int k0 = kt * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * tq + (i & 1);
        const float s = key < n_keys ? sc[n][i] * scale : -INFINITY;
        sc[n][i] = s;
        mx[i / 2] = fmaxf(mx[i / 2], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // k0 < n_keys, so key k0 is real and the row max is finite.
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // P = exp(S - m), rounded to bf16 as the A operands of P.V: key group
    // kk2 takes n8 tiles 2kk2 (registers 0, 1) and 2kk2 + 1 (registers 2, 3).
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = expf(sc[n][0] - m_run[0]), p1 = expf(sc[n][1] - m_run[0]);
      const float p2 = expf(sc[n][2] - m_run[1]), p3 = expf(sc[n][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16x2(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: V is [key][d], its transposed 8x8 matrices are B operands.
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        unsigned vb[4];
        ldsm_x4_t(vb, tile_lane_row(Vt + kk2 * 16 * LD + j * 16, LD));
        mma16816(o[2 * j], pa[kk2], vb[0], vb[1]);
        mma16816(o[2 * j + 1], pa[kk2], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  // Normalise and write rows g and g + 8.
  bf16* dst_base = out + out_offset(lay);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    if (lse != nullptr && tq == 0)
      lse[((long)blockIdx.z * gridDim.y + blockIdx.y) * L + row] = m_run[r] + logf(l_run[r]);
    const float inv = 1.f / l_run[r];
    bf16* dst = dst_base + (long)row * lay.out_ld + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32 path: shared-memory tiles and plain FMAs.
// ---------------------------------------------------------------------------

constexpr int LDT = HD + 4;            // q/k/v tile and accumulator row stride
constexpr int LDS = BK + 4;            // score / probability row stride
constexpr size_t F_Q = 0;
constexpr size_t F_K = F_Q + round_up(sizeof(float) * BQ * LDT, 128);
constexpr size_t F_V = F_K + round_up(sizeof(float) * BK * LDT, 128);
constexpr size_t F_S = F_V + round_up(sizeof(float) * BK * LDT, 128);
constexpr size_t F_O = F_S + round_up(sizeof(float) * BQ * LDS, 128);
constexpr size_t F32_SMEM = F_O + round_up(sizeof(float) * BQ * LDT, 128);

// Copy rows [r0, r0 + ROWS) of one head's (L, HD) panel into shared memory,
// 16 bytes per thread per step; rows at or past L are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row_stride,
                                              int r0, int L) {
  constexpr int VPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = val;
  }
}

template <class Tag>
__global__ void __launch_bounds__(NTHREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Layout lay, int L, int n_keys, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + F_Q);
  float* Ks = reinterpret_cast<float*>(smem + F_K);
  float* Vs = reinterpret_cast<float*>(smem + F_V);
  float* Ss = reinterpret_cast<float*>(smem + F_S);   // scores, then P
  float* Os = reinterpret_cast<float*>(smem + F_O);

  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr0 = warp * ROWS_PER_WARP;
  const long in_off = in_offset(lay);

  load_tile_f32<BQ>(Qs, q + in_off, lay.ld, q0, L);
  for (int i = threadIdx.x; i < BQ * LDT; i += NTHREADS) Os[i] = 0.f;
  // Lanes 2i and 2i+1 own row wr0 + i of the online softmax (each takes
  // every other column) and both keep its running max and sum.
  static_assert(ROWS_PER_WARP * 2 == 32, "two lanes per softmax row");
  const int my_row = wr0 + lane / 2, half = lane % 2;
  float m_row = -INFINITY, l_row = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    load_tile_f32<BK>(Ks, k + in_off, lay.ld, k0, L);
    load_tile_f32<BK>(Vs, v + in_off, lay.ld, k0, L);
    __syncthreads();

    for (int i = lane; i < ROWS_PER_WARP * BK; i += 32) {
      const int r = wr0 + i / BK, c = i % BK;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc = fmaf(Qs[r * LDT + d], Ks[c * LDT + d], acc);
      Ss[r * LDS + c] = acc;
    }
    __syncwarp();

    float sv[BK / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      sv[j] = (k0 + c < n_keys) ? Ss[my_row * LDS + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    // k0 < n_keys, so key k0 is real and the pair's max is finite.
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_row, mx);
    const float alpha = expf(m_row - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      Ss[my_row * LDS + 2 * j + half] = p;   // each lane overwrites what it read
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    m_row = m_new;
    l_row = l_row * alpha + sum;
    for (int c = half; c < HD; c += 2) Os[my_row * LDT + c] *= alpha;
    __syncwarp();

    for (int i = lane; i < ROWS_PER_WARP * HD; i += 32) {
      const int r = wr0 + i / HD, c = i % HD;
      float acc = Os[r * LDT + c];
#pragma unroll 8
      for (int key = 0; key < BK; ++key) acc = fmaf(Ss[r * LDS + key], Vs[key * LDT + c], acc);
      Os[r * LDT + c] = acc;
    }
    __syncthreads();  // K/V tiles are overwritten by the next iteration
  }

  float* dst_base = out + out_offset(lay);
  if (lse != nullptr && half == 0 && q0 + my_row < L)
    lse[((long)blockIdx.z * gridDim.y + blockIdx.y) * L + q0 + my_row] = m_row + logf(l_row);
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const float inv = 1.f / __shfl_sync(0xffffffffu, l_row, 2 * i);
    const int row = q0 + wr0 + i;
    if (row >= L) break;
    float* dst = dst_base + (long)row * lay.out_ld;
    for (int c = lane; c < HD; c += 32) dst[c] = Os[(wr0 + i) * LDT + c] * inv;
  }
}

// Launch the kernel for `dtype` (0 = float32, 1 = bfloat16) over a grid of
// 64-row query tiles x heads x batch items; lse (batch, heads, L) fp32 or
// null. Returns the launch's error.
template <class Tag>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   float* lse, const Layout& lay, int L, int heads, int batch, int n_keys,
                   float scale, cudaStream_t stream) {
  const dim3 grid((L + BQ - 1) / BQ, heads, batch);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(attention_mma_kernel<Tag>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM);
    if (err != cudaSuccess) return err;
    attention_mma_kernel<Tag><<<grid, NTHREADS, MMA_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), lse, lay, L, n_keys, scale);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    err = cudaFuncSetAttribute(attention_f32_kernel<Tag>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (err != cudaSuccess) return err;
    attention_f32_kernel<Tag><<<grid, NTHREADS, F32_SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, lay, L, n_keys, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace attn_fwd
}  // namespace aaclip
